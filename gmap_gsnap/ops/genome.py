"""Device-resident genome representation.

Layout (replaces the reference's interleaved high/low/flags
blocks, src/genome.c / src/compress.c): two parallel uint32 arrays

  * ``ref16``  — 16 nucleotides per word, 2-bit codes LSB-first
                 (code at position p = (ref16[p>>4] >> 2*(p&15)) & 3)
  * ``flag16`` — 16 flag bits per word in the low half
                 (bit i of word w = position 16w+i is N/X)

Keeping codes and flags at the same 16-per-word granularity means every
span fetch is ONE aligned gather per array followed by identical
shift/align arithmetic — no high/low interleave to untangle on device.

The structure also carries chromosome metadata for coordinate mapping
(replaces chrnum.c / the chromosome IIT lookup at alignment time).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

NT_PER_WORD = 16
ROW_WORDS = 8  # words moved per gather descriptor (see _rows_window)


def _pad_rows(arr16: np.ndarray, fill: int) -> np.ndarray:
    """Pad a word array to a multiple of ROW_WORDS plus one full guard
    row of ``fill`` so row-aligned span gathers can always read one row
    past any in-genome start."""
    pad = (-len(arr16)) % ROW_WORDS + ROW_WORDS
    return np.concatenate([arr16, np.full(pad, fill, np.uint32)])


def pack16(codes: np.ndarray, flags: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side packing of 2-bit codes/flags into the 16-per-word layout.
    Pads the tail with X (T + flag) like the disk format."""
    n = len(codes)
    nwords = (n + NT_PER_WORD - 1) // NT_PER_WORD
    pad = nwords * NT_PER_WORD - n
    if pad:
        codes = np.concatenate([codes, np.full(pad, 3, dtype=codes.dtype)])
        flags = np.concatenate([flags, np.ones(pad, dtype=bool)])
    c = codes.astype(np.uint32).reshape(nwords, NT_PER_WORD)
    f = flags.astype(np.uint32).reshape(nwords, NT_PER_WORD)
    shifts = np.arange(NT_PER_WORD, dtype=np.uint32)
    ref16 = np.bitwise_or.reduce(c << (2 * shifts), axis=1)
    flag16 = np.bitwise_or.reduce(f << shifts, axis=1)
    return ref16, flag16


@jax.tree_util.register_pytree_node_class
@dataclass
class GenomeArrays:
    """Genome + chromosome tables as device arrays (pytree)."""

    ref16: jax.Array      # uint32[nwords]
    flag16: jax.Array     # uint32[nwords]
    length: int           # genome length in nt (static)
    chr_offsets: jax.Array  # uint32[nchrs+1] universal start coords (+ total)

    def tree_flatten(self):
        return (self.ref16, self.flag16, self.chr_offsets), (self.length,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        ref16, flag16, chr_offsets = children
        return cls(ref16, flag16, aux[0], chr_offsets)

    @classmethod
    def from_codes(cls, codes: np.ndarray, flags: np.ndarray, chr_ends) -> "GenomeArrays":
        ref16, flag16 = pack16(codes, flags)
        # pad to gather-row granularity (plus a guard row) so span
        # fetches can read whole aligned rows past the genome end; the
        # fill decodes as X (T + N flag) like the disk format's tail
        ref16 = _pad_rows(ref16, 0xFFFFFFFF)
        flag16 = _pad_rows(flag16, 0xFFFF)
        chr_offsets = np.concatenate([[0], np.asarray(chr_ends, dtype=np.int64)])
        return cls(
            ref16=jnp.asarray(ref16),
            flag16=jnp.asarray(flag16),
            length=int(len(codes)),
            chr_offsets=jnp.asarray(chr_offsets.astype(np.uint32)),
        )


def _rows_window(arr16: jax.Array, w0, nword_window: int):
    """Words w0 .. w0+nword_window-1 for a batch of word indices, fetched
    as aligned ROW_WORDS-wide rows — one gather index per 8 words (a
    layout tuned for the earlier accelerator, whose gathers cost per
    index; not yet measured against a per-word gather on the GPU).  The
    dynamic offset of w0 within its row is then removed with three
    vectorized binary shifts.
    arr16 must be row-padded (see _pad_rows)."""
    t = (w0 & (ROW_WORDS - 1)).astype(jnp.int32)
    r0 = w0 >> 3
    nrows = ((ROW_WORDS - 1 + nword_window - 1) >> 3) + 1
    rows2d = arr16.reshape(-1, ROW_WORDS)
    rows = r0[..., None] + jnp.arange(nrows, dtype=jnp.int32)
    rows = jnp.minimum(rows, rows2d.shape[0] - 1)
    win = rows2d[rows].reshape(*w0.shape, nrows * ROW_WORDS)
    for b in (4, 2, 1):
        win = jnp.where(
            ((t & b) > 0)[..., None], win[..., b:], win[..., : win.shape[-1] - b]
        )
    return win[..., :nword_window]


def fetch_span_words(ref16: jax.Array, flag16: jax.Array, start, nwords: int):
    """Fetch ``nwords`` aligned uint32 words (codes and flags) such that
    word j holds genome positions start+16j .. start+16j+15, for a batch
    of ``start`` positions (uint32[B]).  Returns (codes, flags) each
    uint32[B, nwords], flags in the low 16 bits of each word."""
    start = start.astype(jnp.uint32)
    w0 = (start >> 4).astype(jnp.int32)  # word index
    sh = (start & 15).astype(jnp.uint32)  # nt shift within word
    raw_c = _rows_window(ref16, w0, nwords + 1)  # [B, nwords+1]
    raw_f = _rows_window(flag16, w0, nwords + 1)
    sh2 = (2 * sh)[:, None]
    shf = sh[:, None]
    # align: out[j] = raw[j] >> 2*sh | raw[j+1] << (32 - 2*sh)
    c = (raw_c[:, :-1] >> sh2) | _shl32(raw_c[:, 1:], 32 - sh2)
    f = (raw_f[:, :-1] >> shf) | _shl32(raw_f[:, 1:], 16 - shf)
    f = f & jnp.uint32(0xFFFF)
    return c, f


def _shl32(x, amount):
    """Left shift where amount may be 32/16 (full width): result 0 then."""
    amount = amount.astype(jnp.uint32)
    big = amount >= 32
    safe = jnp.where(big, 0, amount)
    return jnp.where(big, jnp.uint32(0), x << safe)


def fetch_span_codes(ref16: jax.Array, start, n: int) -> jax.Array:
    """Unpacked 2-bit codes of genome[start : start+n] for a batch of
    start positions (uint32[B]) -> uint8[B, n].

    Fetches aligned 16-nt words (one gather per 16 nt) and unpacks with
    vector shifts — ~14x fewer gathered elements than a per-position
    fetch_codes."""
    nwords = (n + NT_PER_WORD - 1) // NT_PER_WORD
    start = start.astype(jnp.uint32)
    w0 = (start >> 4).astype(jnp.int32)
    sh2 = (2 * (start & 15))[..., None]
    raw = _rows_window(ref16, w0, nwords + 1)
    c16 = (raw[..., :-1] >> sh2) | _shl32(raw[..., 1:], 32 - sh2)
    sh = 2 * jnp.arange(NT_PER_WORD, dtype=jnp.uint32)
    codes = ((c16[..., None] >> sh) & 3).astype(jnp.uint8)
    return codes.reshape(c16.shape[:-1] + (nwords * NT_PER_WORD,))[..., :n]


def fetch_span_bits(bits32: jax.Array, start, n: int) -> jax.Array:
    """Bits of a genome-length bitvector over [start, start+n) for a
    batch of start positions -> bool[..., n].  Word-aligned fetch +
    vector unpack (used for known-splicesite masks)."""
    nwords = (n + 31) // 32
    start = start.astype(jnp.uint32)
    w0 = (start >> 5).astype(jnp.int32)
    sh = (start & 31)[..., None]
    idx = w0[..., None] + jnp.arange(nwords + 1, dtype=jnp.int32)
    idx = jnp.clip(idx, 0, bits32.shape[0] - 1)
    raw = bits32[idx]
    al = (raw[..., :-1] >> sh) | _shl32(raw[..., 1:], 32 - sh)
    b = ((al[..., None] >> jnp.arange(32, dtype=jnp.uint32)) & 1).astype(jnp.bool_)
    return b.reshape(al.shape[:-1] + (nwords * 32,))[..., :n]


def fetch_codes(ref16: jax.Array, positions) -> jax.Array:
    """Per-position 2-bit code gather: codes[i] = genome[positions[i]]."""
    positions = positions.astype(jnp.uint32)
    w = (positions >> 4).astype(jnp.int32)
    w = jnp.minimum(w, ref16.shape[0] - 1)
    sh = 2 * (positions & 15)
    return ((ref16[w] >> sh) & 3).astype(jnp.uint8)


def fetch_flags(flag16: jax.Array, positions) -> jax.Array:
    positions = positions.astype(jnp.uint32)
    w = (positions >> 4).astype(jnp.int32)
    w = jnp.minimum(w, flag16.shape[0] - 1)
    sh = positions & 15
    return ((flag16[w] >> sh) & 1).astype(jnp.bool_)
