"""Bit-parallel mismatch kernels — the genome_hr replacement.

The hottest GSNAP operation (reference contract: src/genome_hr.h:43-83,
implementation absent from the snapshot; semantics re-derived from the
header, call sites in stage1hr.c/substring.c, and golden outputs):

  * count mismatches of a read vs the genome at a candidate placement
  * enumerate mismatch positions left->right / right->left
  * trim ends by match/mismatch score

Design: everything is batched over B candidates with static shapes.
The packed path XORs 16-nt words fetched from HBM against the pre-packed
query and reduces with ``jax.lax.population_count`` — the vectorized
equivalent of the reference's XOR + __builtin_popcount idiom
(ChangeLog:1952,9209), with one uint32 gather per 16 nt instead of
byte-level access.

N semantics (gsnap.c:142-143 defaults): genome N => always a mismatch
(genome_unk_mismatch_p true); query N => never a mismatch
(query_unk_mismatch_p false).  Positions outside [pos5, pos3) never
count.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from . import genome as genome_ops

NT_PER_WORD = 16


@jax.tree_util.register_pytree_node_class
@dataclass
class PackedQueries:
    """A batch of reads packed 16 nt/word (plus N flags), fixed width.

    codes16: uint32[B, W] 2-bit codes LSB-first; positions >= length are
             padded with code 0 and flagged as N.
    nflags16: uint32[B, W] query-N flag bits (low 16 bits per word).
    length: int32[B] actual read lengths.
    lmax: static max read length (W = ceil(lmax/16)).
    """

    codes16: jax.Array
    nflags16: jax.Array
    length: jax.Array
    lmax: int

    def tree_flatten(self):
        return (self.codes16, self.nflags16, self.length), (self.lmax,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, aux[0])


def pack_queries(codes: np.ndarray, nflags: np.ndarray, lengths: np.ndarray) -> PackedQueries:
    """Host-side packing: codes uint8[B, Lmax], nflags bool[B, Lmax],
    lengths int[B].  Positions >= length are treated as query-N."""
    b, lmax = codes.shape
    w = (lmax + NT_PER_WORD - 1) // NT_PER_WORD
    pad = w * NT_PER_WORD - lmax
    idx = np.arange(lmax)
    nflags = nflags | (idx[None, :] >= lengths[:, None])
    if pad:
        codes = np.pad(codes, ((0, 0), (0, pad)))
        nflags = np.pad(nflags, ((0, 0), (0, pad)), constant_values=True)
    c = codes.astype(np.uint32).reshape(b, w, NT_PER_WORD)
    f = nflags.astype(np.uint32).reshape(b, w, NT_PER_WORD)
    shifts = np.arange(NT_PER_WORD, dtype=np.uint32)
    codes16 = np.bitwise_or.reduce(c << (2 * shifts), axis=2)
    nflags16 = np.bitwise_or.reduce(f << shifts, axis=2)
    return PackedQueries(
        codes16=jnp.asarray(codes16),
        nflags16=jnp.asarray(nflags16),
        length=jnp.asarray(lengths.astype(np.int32)),
        lmax=int(lmax),
    )


_LANE_LO = jnp.uint32(0x55555555)


def convert_words(codes16, conversion: str | None):
    """Nucleotide-conversion on 2-bit packed words (cmet/atoi modes).
    Each lane: lo bit at 2i, hi bit at 2i+1.  A=00 C=01 G=10 T=11."""
    if conversion is None:
        return codes16
    lo = codes16 & _LANE_LO
    hi = (codes16 >> 1) & _LANE_LO
    if conversion == "ct":      # C -> T: set hi where lane == 01
        mask = lo & ~hi
        return codes16 | (mask << 1)
    if conversion == "ga":      # G -> A: clear hi where lane == 10
        mask = hi & ~lo
        return codes16 & ~(mask << 1)
    if conversion == "ag":      # A -> G: set hi where lane == 00
        mask = ~hi & ~lo & _LANE_LO
        return codes16 | (mask << 1)
    if conversion == "tc":      # T -> C: clear hi where lane == 11
        mask = hi & lo
        return codes16 & ~(mask << 1)
    raise ValueError(conversion)


def _expand2(mask16):
    """Expand a 16-bit-per-word mask to 2-bit lanes: bit i -> bits 2i,2i+1."""
    x = mask16.astype(jnp.uint32)
    # interleave bits with zeros (classic morton spread for 16 -> 32 bits)
    x = (x | (x << 8)) & jnp.uint32(0x00FF00FF)
    x = (x | (x << 4)) & jnp.uint32(0x0F0F0F0F)
    x = (x | (x << 2)) & jnp.uint32(0x33333333)
    x = (x | (x << 1)) & jnp.uint32(0x55555555)
    return x | (x << 1)


def mismatch_words(genome: genome_ops.GenomeArrays, queries: PackedQueries, left,
                   conversion: str | None = None, alt=None):
    """Per-word mismatch bitmasks for a batch of placements.

    Returns uint32[B, W]: bit i of word j set iff query position 16j+i is
    a mismatch under the N rules (regardless of pos5/pos3 masking).

    conversion: optional cmet/atoi nucleotide conversion ('ct', 'ga',
    'ag', 'tc') applied to BOTH sides before comparing.
    alt: optional (alt_ref16, alt_flag16) SNP-substituted genome — a
    position matching either genome is not a mismatch
    (Genome_count_mismatches_substring with snp_blocks).
    """
    nwords = queries.codes16.shape[1]
    qcodes = convert_words(queries.codes16, conversion)
    qn = _expand2(queries.nflags16) & _LANE_LO

    def one(ref16, flag16):
        gcodes, gflags = genome_ops.fetch_span_words(ref16, flag16, left, nwords)
        gcodes = convert_words(gcodes, conversion)
        diff = gcodes ^ qcodes
        neq = (diff | (diff >> 1)) & _LANE_LO
        gn = _expand2(gflags) & _LANE_LO
        m = (neq | gn) if GENOME_UNK_MISMATCH else (neq & ~gn)
        return (m | qn) if QUERY_UNK_MISMATCH else (m & ~qn)

    mm = one(genome.ref16, genome.flag16)
    if alt is not None:
        mm = mm & one(alt[0], alt[1])
    return mm


# gsnap --query-unk-mismatch / --genome-unk-mismatch (gsnap.c:142-143).
# Read at trace time: CLIs set these once at startup, before any jit
# trace; flipping them mid-process would leave stale compiled caches.
QUERY_UNK_MISMATCH = False
GENOME_UNK_MISMATCH = True


def _range_mask_words(pos5, pos3, nwords):
    """uint32[B, W] with even-bit lanes set for query positions in
    [pos5, pos3)."""
    j = jnp.arange(nwords, dtype=jnp.int32)[None, :]
    base = j * NT_PER_WORD
    lane = jnp.arange(NT_PER_WORD, dtype=jnp.int32)[None, None, :]
    pos = base[:, :, None] + lane  # [1, W, 16]
    inrange = (pos >= pos5[:, None, None]) & (pos < pos3[:, None, None])
    bits = jnp.where(inrange, jnp.uint32(1), jnp.uint32(0)) << (
        2 * lane.astype(jnp.uint32)
    )
    # lanes are disjoint bits, so sum == bitwise-or
    return jnp.sum(bits, axis=2).astype(jnp.uint32)


def count_mismatches(genome, queries, left, pos5, pos3, conversion=None, alt=None):
    """Batched Genome_count_mismatches_substring (genome_hr.h:52-54):
    number of mismatches of query[pos5:pos3] aligned at genome position
    left+pos5.  left/pos5/pos3 are arrays of shape [B]."""
    mm = mismatch_words(genome, queries, left, conversion, alt)
    nwords = mm.shape[1]
    mask = _range_mask_words(pos5, pos3, nwords)
    return jnp.sum(jax.lax.population_count(mm & mask), axis=1).astype(jnp.int32)


def mismatch_matrix(genome, queries, left, conversion=None, alt=None):
    """Unpacked bool[B, Lmax] mismatch matrix (for position enumeration,
    trimming, and as the reference implementation for kernel tests)."""
    mm = mismatch_words(genome, queries, left, conversion, alt)
    b, w = mm.shape
    lane = jnp.arange(NT_PER_WORD, dtype=jnp.uint32)
    bits = (mm[:, :, None] >> (2 * lane[None, None, :])) & 1
    return bits.reshape(b, w * NT_PER_WORD)[:, : queries.lmax].astype(jnp.bool_)


def mismatch_positions_left(genome, queries, left, pos5, pos3, max_mismatches: int):
    """Batched Genome_mismatches_left (genome_hr.h:62-64): the first
    ``max_mismatches`` mismatch positions scanning pos5 -> pos3.

    Returns (positions int32[B, max_mismatches], count int32[B]); unused
    slots are filled with pos3 (one past the end).
    """
    m = mismatch_matrix(genome, queries, left)
    lmax = m.shape[1]
    idx = jnp.arange(lmax, dtype=jnp.int32)[None, :]
    valid = m & (idx >= pos5[:, None]) & (idx < pos3[:, None])
    key = jnp.where(valid, idx, lmax + 1)
    order = jnp.sort(key, axis=1)[:, :max_mismatches]
    count = jnp.sum(valid, axis=1).astype(jnp.int32)
    positions = jnp.where(order > lmax, pos3[:, None], order)
    return positions.astype(jnp.int32), jnp.minimum(count, max_mismatches)


def mismatch_positions_right(genome, queries, left, pos5, pos3, max_mismatches: int):
    """Batched Genome_mismatches_right: first positions scanning
    pos3-1 -> pos5.  Unused slots filled with pos5 - 1."""
    m = mismatch_matrix(genome, queries, left)
    lmax = m.shape[1]
    idx = jnp.arange(lmax, dtype=jnp.int32)[None, :]
    valid = m & (idx >= pos5[:, None]) & (idx < pos3[:, None])
    key = jnp.where(valid, -idx, 2)  # descending by position
    order = jnp.sort(key, axis=1)[:, :max_mismatches]
    count = jnp.sum(valid, axis=1).astype(jnp.int32)
    positions = jnp.where(order > 1, pos5[:, None] - 1, -order)
    return positions.astype(jnp.int32), jnp.minimum(count, max_mismatches)


def trim_left(genome, queries, left, pos5, pos3, mismatch_score: int = -3):
    """Batched Genome_trim_left semantics: find the trim point near pos5
    maximizing the match(-1/+1) score of query[trim:pos3] scanning from
    pos3 leftward (match +1, mismatch ``mismatch_score``).

    Returns int32[B]: the best start position (>= pos5).
    """
    m = mismatch_matrix(genome, queries, left)
    lmax = m.shape[1]
    idx = jnp.arange(lmax, dtype=jnp.int32)[None, :]
    inrange = (idx >= pos5[:, None]) & (idx < pos3[:, None])
    contrib = jnp.where(inrange, jnp.where(m, mismatch_score, 1), 0)
    # score(start) = sum of contrib[start:pos3]; maximize over start
    total = jnp.sum(contrib, axis=1, keepdims=True)
    prefix = jnp.cumsum(contrib, axis=1) - contrib  # sum of contrib[:start]
    score = total - prefix
    score = jnp.where(inrange, score, jnp.int32(-(10**9)))
    # rightmost-of-max would trim aggressively; reference keeps leftmost max
    best = jnp.argmax(score, axis=1).astype(jnp.int32)
    return jnp.maximum(best, pos5)


def trim_right(genome, queries, left, pos5, pos3, mismatch_score: int = -3):
    """Batched Genome_trim_right: best exclusive end position (<= pos3)."""
    m = mismatch_matrix(genome, queries, left)
    lmax = m.shape[1]
    idx = jnp.arange(lmax, dtype=jnp.int32)[None, :]
    inrange = (idx >= pos5[:, None]) & (idx < pos3[:, None])
    contrib = jnp.where(inrange, jnp.where(m, mismatch_score, 1), 0)
    score = jnp.cumsum(contrib, axis=1)  # score(end) = sum contrib[pos5:end+1]
    score = jnp.where(inrange, score, jnp.int32(-(10**9)))
    # flip to pick the RIGHTMOST maximum (prefer longer alignments on ties)
    rev_best = jnp.argmax(score[:, ::-1], axis=1)
    best = (lmax - 1) - rev_best
    return (best + 1).astype(jnp.int32)
