"""MaxEnt splice-site probability models (donor / acceptor, both strands).

The models are the maximum-entropy splice models (Yeo & Burge 2004) as
shipped in the reference's precomputed table form (src/maxent_hr.c:
donor window = 3 exonic nt + GT + 6 intronic; acceptor window = 18
intronic + AG + 3 exonic; maxent_hr.c:11-15).  The probability is
odds/(1+odds) where odds is a product of 7-mer table lookups plus a
dinucleotide factor — here expressed as batched gathers over constant
tables.

Table data is extracted from the reference into
``gmap_gsnap/data/maxent_hr_tables.npz`` (numeric model constants;
see tools/extract_maxent_tables.py) so probabilities match bit-for-bit.

Window decompositions (derived from the bit-slicing dispatch handlers,
maxent_hr.c:24817-27200; nt indices are offsets into the window, each a
2-bit code, LSB-first packing):

  donor  (window at pos-3, 9 nt;  GT at offsets 3,4):
      score7 = nt[0,1,2,5,6,7,8]          discore = nt[3,4]
  acceptor (window at pos-20, 23 nt; AG at offsets 18,19):
      score1 = nt[0..6]   score2 = nt[7..13]  score467 = nt[4..10]
      score589 = nt[11..17]
      score3 = nt[14,15,16,17,20,21,22]   discore = nt[18,19]
  antidonor (window at pos-6, 9 nt; minus-strand donor read forward):
      score7 = nt[0,1,2,3,6,7,8]          discore = nt[4,5]
  antiacceptor (window at pos-3, 23 nt):
      score1 = nt[16..22]  score2 = nt[9..15]  score467 = nt[12..18]
      score589 = nt[5..11]
      score3 = nt[0,1,2,5,6,7,8]          discore = nt[3,4]

Entry-point margins per Maxent_hr_{donor,acceptor,antidonor,
antiacceptor}_prob (maxent_hr.c:27218-27395).
"""

from __future__ import annotations

import os
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from . import genome as genome_ops

DONOR_LEFT_MARGIN = 3     # exonic nt before GT
DONOR_WIDTH = 9
ACCEPTOR_LEFT_MARGIN = 20  # intronic nt incl AG
ACCEPTOR_WIDTH = 23

_DATA = os.path.join(os.path.dirname(os.path.dirname(__file__)), "data",
                     "maxent_hr_tables.npz")

# (table_name, nt offsets) per model; offsets are LSB-first digit order
_MODELS = {
    "donor": [
        ("donor_score_plus", (0, 1, 2, 5, 6, 7, 8)),
        ("donor_discore_plus", (3, 4)),
    ],
    "acceptor": [
        ("acc_score1_plus", tuple(range(0, 7))),
        ("acc_score2_plus", tuple(range(7, 14))),
        ("acc_score3_plus", (14, 15, 16, 17, 20, 21, 22)),
        ("acc_discore_plus", (18, 19)),
        ("acc_score467_plus", tuple(range(4, 11))),
        ("acc_score589_plus", tuple(range(11, 18))),
    ],
    "antidonor": [
        ("donor_score_minus", (0, 1, 2, 3, 6, 7, 8)),
        ("donor_discore_minus", (4, 5)),
    ],
    "antiacceptor": [
        ("acc_score1_minus", tuple(range(16, 23))),
        ("acc_score2_minus", tuple(range(9, 16))),
        ("acc_score3_minus", (0, 1, 2, 5, 6, 7, 8)),
        ("acc_discore_minus", (3, 4)),
        ("acc_score467_minus", tuple(range(12, 19))),
        ("acc_score589_minus", tuple(range(5, 12))),
    ],
}

_MARGIN = {"donor": 3, "acceptor": 20, "antidonor": 6, "antiacceptor": 3}
_WIDTH = {"donor": 9, "acceptor": 23, "antidonor": 9, "antiacceptor": 23}


@lru_cache(maxsize=1)
def _tables_np() -> dict[str, np.ndarray]:
    return {k: v for k, v in np.load(_DATA).items()}


def _tables_jnp(dtype=jnp.float32):
    # NOT cached as jax arrays: a cache filled inside a jit trace would
    # capture tracers; converting per call yields XLA constants instead
    return {k: jnp.asarray(v, dtype=dtype) for k, v in _tables_np().items()}


def _index(window, offsets):
    """Pack window[..., offsets] 2-bit codes LSB-first into an index."""
    idx = window[..., offsets[0]].astype(np.int64 if isinstance(window, np.ndarray) else jnp.int32)
    for j, o in enumerate(offsets[1:], start=1):
        idx = idx + (window[..., o].astype(idx.dtype) << (2 * j))
    return idx


def _prob_from_window(window, kind: str, tables):
    odds = None
    for name, offsets in _MODELS[kind]:
        factor = tables[name][_index(window, offsets)]
        odds = factor if odds is None else odds * factor
    return odds / (1.0 + odds)


# --------------------------------------------------------------- device path

def splice_prob(genome: genome_ops.GenomeArrays, positions, kind: str):
    """Batched splice probability at genome positions (uint32[B]) on the
    plus-strand genome.  kind in {donor, acceptor, antidonor,
    antiacceptor}.  float32[B]; positions closer than the window margin to
    coordinate 0 return 0.
    """
    margin = _MARGIN[kind]
    width = _WIDTH[kind]
    positions = positions.astype(jnp.uint32)
    start = positions - jnp.uint32(margin)
    ok = positions >= margin
    offs = jnp.arange(width, dtype=jnp.uint32)[None, :]
    window = genome_ops.fetch_codes(
        genome.ref16, jnp.where(ok, start, 0)[:, None] + offs
    )
    p = _prob_from_window(window, kind, _tables_jnp())
    return jnp.where(ok, p.astype(jnp.float32), 0.0)


def splice_prob_span(span, kind: str, npos: int, origin: int = 20):
    """Splice probabilities for a run of candidate positions from a
    pre-fetched local code span (static slices; only the tables gather).

    span: integer 2-bit codes [..., W]; position s of the scan (s =
    0..npos-1) corresponds to genome coordinate span[..., origin + s].
    Requires origin >= 20 and W >= origin + npos + 19 (the acceptor
    window reaches 20 left / antiacceptor 19 right of the coordinate).
    Returns float32[..., npos].
    """
    tables = _tables_jnp()
    margin = _MARGIN[kind]
    odds = None
    for name, offsets in _MODELS[kind]:
        idx = None
        for j, off in enumerate(offsets):
            base = origin - margin + off
            sl = jax.lax.slice_in_dim(span, base, base + npos, axis=-1).astype(jnp.int32)
            piece = sl << (2 * j)
            idx = piece if idx is None else idx + piece
        factor = tables[name][idx]
        odds = factor if odds is None else odds * factor
    return (odds / (1.0 + odds)).astype(jnp.float32)


def splice_idx_span(span, kind: str, npos: int, origin: int = 20):
    """Dense per-position table indices for a splice scan.

    Pure static-slice/shift vector ops (no gathers): returns a list of
    (table_name, idx int32[..., npos]) — callers gather table values
    only at selected candidate positions."""
    margin = _MARGIN[kind]
    out = []
    for name, offsets in _MODELS[kind]:
        idx = None
        for j, off in enumerate(offsets):
            base = origin - margin + off
            sl = jax.lax.slice_in_dim(span, base, base + npos, axis=-1).astype(jnp.int32)
            piece = sl << (2 * j)
            idx = piece if idx is None else idx + piece
        out.append((name, idx))
    return out


def splice_prob_window(window, kind: str):
    """Splice probability from pre-extracted model windows.

    window: integer codes [..., W] where W = _WIDTH[kind] and
    window[..., 0] is the base at coordinate - margin.  Used on sparse
    candidate sets (the dense-scan variant is splice_prob_span)."""
    tables = _tables_jnp()
    odds = None
    for name, offsets in _MODELS[kind]:
        idx = None
        for j, off in enumerate(offsets):
            piece = window[..., off].astype(jnp.int32) << (2 * j)
            idx = piece if idx is None else idx + piece
        factor = tables[name][idx]
        odds = factor if odds is None else odds * factor
    return (odds / (1.0 + odds)).astype(jnp.float32)


def window_margin_width(kind: str) -> tuple[int, int]:
    return _MARGIN[kind], _WIDTH[kind]


# ----------------------------------------------------------------- host path

_CODE_OF = np.full(256, 0, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE_OF[_c] = _i


def prob_from_str(window: str, kind: str) -> float:
    """String-form maxent probability (Maxent_donor/acceptor_prob,
    maxent.h:12-32): ``window`` is the model window itself (donor:
    3 exonic + GT + 4 intronic = 9 nt; acceptor: 20 intronic incl AG +
    3 exonic = 23 nt)."""
    w = np.frombuffer(window.upper().encode("latin-1"), np.uint8)
    if len(w) != _WIDTH[kind]:
        raise ValueError(f"{kind} window must be {_WIDTH[kind]} nt")
    codes = _CODE_OF[w][None, :]
    return float(_prob_from_window(codes, kind, _tables_np())[0])


def donor_prob(window: str) -> float:
    return prob_from_str(window, "donor")


def acceptor_prob(window: str) -> float:
    return prob_from_str(window, "acceptor")


def donor_prob_revcomp(window: str) -> float:
    """Maxent_donor_prob_revcomp: the window read on the other strand."""
    comp = str.maketrans("ACGTacgt", "TGCAtgca")
    return donor_prob(window.translate(comp)[::-1])


def acceptor_prob_revcomp(window: str) -> float:
    comp = str.maketrans("ACGTacgt", "TGCAtgca")
    return acceptor_prob(window.translate(comp)[::-1])


def splice_prob_np(codes: np.ndarray, positions: np.ndarray, kind: str) -> np.ndarray:
    """Host float64 implementation over an unpacked 2-bit code array
    (exact double-precision parity with the reference)."""
    margin = _MARGIN[kind]
    width = _WIDTH[kind]
    positions = np.asarray(positions, dtype=np.int64)
    ok = (positions >= margin) & (positions - margin + width <= len(codes))
    start = np.where(ok, positions - margin, 0)
    window = codes[start[:, None] + np.arange(width)[None, :]]
    p = _prob_from_window(window, kind, _tables_np())
    return np.where(ok, p, 0.0)
