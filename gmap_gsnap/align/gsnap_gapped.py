"""GSNAP gapped extensions: middle indels + local (single) splicing.

Batched, static-shape re-design of the reference's stage-1hr gapped
stages:

  * middle insertions/deletions — solve_middle_insertion /
    solve_middle_deletion (stage1hr.c:4180, 4330): given two seeded
    diagonals dL < dR (deletion) or dL > dR (insertion), the split point
    is the lexicographically smallest (mismatch_sum, position) over the
    candidate set derived from per-diagonal mismatch positions, bounded
    by min_indel_end_matches (4).
  * local novel splicing — solve_singlesplice (stage1hr.c:6195) +
    find_singlesplices_plus (stage1hr.c:7235): candidate splice points
    are positions in [2, L-2] where segmenti carries a donor GT (sense)
    or antiacceptor CT, and segmentj carries an acceptor AG / antidonor
    AC two bases earlier; the winner maximizes maxent prob_i + prob_j
    (first maximum = smallest position) subject to the mismatch budget
    and sufficient_splice_prob_local (stage1hr.c:6093) support
    thresholds.

Everything here operates on the top-voted diagonals emitted by the
seeding stage of gsnap_se; diagonal pairs are selected per read with a
masked argsort (static MAXPAIRS shape), then all pair solvers run as
dense [B, P, L+1] scans — mismatch-prefix cumsums replace the
reference's Genome_mismatches_left/right streams, and splice-site
probabilities come from static-slice table lookups over a prefetched
local genome span (ops.maxent.splice_prob_span).

Hit kinds: 0 = substitution-only, 1 = insertion, 2 = deletion,
3 = splice.  Scores follow stage3hr: score = nmismatches + penalty
(indel_penalty_middle = 2, localsplicing_penalty = 0; gsnap.c:83-96).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from ..ops import genome as genome_ops
from ..ops import maxent
from ..ops import mismatch as mm_ops
from . import gsnap_se
from .gsnap_se import (
    BIG_NMM,
    INVALID_DIAG,
    GsnapParams,
    IndexArrays,
    _MODE_CONV,
    _convert_codes,
    _extract_oligos,
    _pack_device,
    _qpos_ranges,
    _revcomp_batch,
    _seed_diagonals,
    _top_diagonals,
)

KIND_SUB = 0
KIND_INS = 1
KIND_DEL = 2
KIND_SPLICE = 3
KIND_SHORTEXON = 4

INDEL_PENALTY_MIDDLE = 2       # gsnap.c:85
LOCALSPLICING_PENALTY = 0      # gsnap.c:90
MIN_INDEL_END_MATCHES = 4      # gsnap.c:88
MAX_MIDDLE_INSERTIONS = 9      # gsnap.c:86
MAX_MIDDLE_DELETIONS = 30      # gsnap.c:87
SHORTSPLICEDIST = 200_000      # gsnap.c:91
BIG_SCORE = jnp.int32(10**6)


@dataclass(frozen=True)
class GappedParams:
    """Static shape configuration for the gapped stages."""

    base: GsnapParams = GsnapParams()
    indel_pairs: int = 16      # diagonal pairs solved for indels per strand
    splice_pairs: int = 16     # diagonal pairs solved for splicing per strand
    shortexon_triples: int = 8  # diagonal triples solved for doublesplices
    novelsplicing: bool = False  # gsnap -N (novelsplicingp, default off)


# ------------------------------------------------------------- mismatch scans

def _prefix_mm(genome, queries, diags, lengths, conversion, alt):
    """Mismatch matrices + prefix sums for each candidate diagonal.

    diags uint32[B, NC] -> (mm bool[B, NC, L], pref int32[B, NC, L+1])
    where pref[..., s] = #mismatches of query[0:s] at that diagonal.
    Invalid diagonals produce all-mismatch rows.
    """
    b, nc = diags.shape
    lmax = queries.lmax
    glen = jnp.uint32(genome.length)
    ok = (diags != INVALID_DIAG) & (diags + lengths.astype(jnp.uint32)[:, None] <= glen)
    lefts = jnp.where(ok, diags, 0).reshape(-1)
    rep = lambda x: jnp.repeat(x, nc, axis=0)
    q = mm_ops.PackedQueries(
        codes16=rep(queries.codes16),
        nflags16=rep(queries.nflags16),
        length=rep(queries.length),
        lmax=lmax,
    )
    mm = mm_ops.mismatch_matrix(genome, q, lefts, conversion, alt).reshape(b, nc, lmax)
    idx = jnp.arange(lmax, dtype=jnp.int32)[None, None, :]
    inlen = idx < lengths[:, None, None]
    mm = (mm & inlen) | (~ok[:, :, None] & inlen)
    pref = jnp.concatenate(
        [jnp.zeros((b, nc, 1), jnp.int32), jnp.cumsum(mm, axis=2, dtype=jnp.int32)],
        axis=2,
    )
    return mm, pref


def _trim_ends_device(mm, lengths, trim_mm_score: int):
    """Device trim_left_end + trim_right_end (substring.c) over
    [B, K, L] mismatch matrices — exact runner.trim_ends semantics
    including the '>=' tie rule (smallest trim5 / largest pre-trim3
    position wins).  Returns (t5, t3) int32[B, K].

    Closed form instead of a sequential scan: the reference walks the
    read accumulating s' = max(s + v, 0) (v = +1 match,
    trim_mm_score mismatch) — a zero-clamped Kadane recurrence whose
    state at any position is  max(0, best subarray sum ending there),
    expressible with one cumsum plus running max/min of the prefix
    sums.  Everything below is vectorized log-depth ops; no scan."""
    B, K, L = mm.shape
    La = lengths.astype(jnp.int32)[:, None]              # [B, 1]
    iota = jnp.arange(L, dtype=jnp.int32)
    active = iota[None, None, :] < La[:, :, None]        # [B, K, L]
    w = jnp.int32(trim_mm_score)
    v = jnp.where(active, jnp.where(mm, w, 1), 0)
    P = jnp.concatenate(
        [jnp.zeros((B, K, 1), jnp.int32),
         jnp.cumsum(v, axis=2, dtype=jnp.int32)], axis=2)   # [B, K, L+1]
    NEG = jnp.int32(-(2**30))

    # trim5 walks p = L-1 .. 0; candidate value at mismatch p is the
    # clamped Kadane state over positions > p:
    #   sig5(p) = max(0, max_{i in [p+2, L]} P_i  -  P_{p+1})
    T = jax.lax.cummax(P[:, :, ::-1], axis=2)[:, :, ::-1]   # suffix max
    Tpad = jnp.concatenate([T, jnp.full((B, K, 1), NEG)], axis=2)
    sig5 = jnp.maximum(Tpad[:, :, 2:] - P[:, :, 1:], 0)     # [B, K, L]
    cand5 = jnp.where(mm & active, sig5, NEG)
    best5 = jnp.max(cand5, axis=2)
    # '>=' with descending p => smallest p wins ties = first argmax
    p5 = jnp.argmax(cand5, axis=2).astype(jnp.int32)
    sfin5 = jnp.maximum(T[:, :, 1], 0)                      # state after p=0
    t5 = jnp.where(sfin5 >= best5, 0, p5 + 1)

    # trim3 walks p = 0 .. L-1; candidate at mismatch p:
    #   sig3(p) = max(0, P_p - min_{q in [0, p-1]} P_q)
    Cm = jax.lax.cummin(P, axis=2)
    Cpad = jnp.concatenate(
        [jnp.full((B, K, 1), jnp.int32(2**30)), Cm], axis=2)
    sig3 = jnp.maximum(P[:, :, :L] - Cpad[:, :, :L], 0)
    cand3 = jnp.where(mm & active, sig3, NEG)
    best3 = jnp.max(cand3, axis=2)
    # '>=' with ascending p => largest p wins ties = last argmax
    p3 = (L - 1) - jnp.argmax(cand3[:, :, ::-1], axis=2).astype(jnp.int32)
    sfin3 = jnp.maximum(P[:, :, L] - Cm[:, :, L - 1], 0)
    t3 = jnp.where(sfin3 >= best3, 0, La - p3)
    return t5, t3


def _lane_features(mm, pref, nmm_raw, lengths, k: int, interval: int,
                   trim_mm_score: int):
    """Per-candidate features for the device lane-noop gate (the
    host rescue lanes' ENTRY/acceptance tests; see runner._se_lane_noop
    for the host mirror and the stage1hr.c citations).  All values are
    independent of the per-read done level, which is applied later."""
    B, K, L = mm.shape
    La = lengths.astype(jnp.int32)
    spansize = -(-k // interval) * interval
    firstbound = interval + (interval - 1) + k
    lastpos = La - k                                    # [B]
    lastbound = lastpos - interval - 1
    mtl = jnp.minimum(spansize + interval - 1, La // 2)

    # [B]-indexed prefix counts are gathers from the prefix array;
    # candidate-indexed counts (trims) are fused masked reduces; seed
    # windows are static prefix-array slices.
    iota = jnp.arange(L, dtype=jnp.int32)

    idxs = jnp.stack([
        jnp.maximum(lastbound, 0),                      # lbc
        mtl + 1,                                        # cnt <= mtl
        La - mtl,                                       # cnt < La - mtl
        lastpos + k,                                    # last-seed hi
        lastpos,                                        # last-seed lo
    ], axis=1)                                          # [B, 5]
    # mismatches in [0, idx) = pref[idx], idx clamped to [0, L]
    cnts = jnp.take_along_axis(
        pref, jnp.broadcast_to(jnp.clip(idxs, 0, L)[:, None, :], (B, K, 5)),
        axis=2)
    lbc, cnt_le_mtl, cnt_lt_lmtl, lp_hi, lp_lo = (
        cnts[:, :, 0], cnts[:, :, 1], cnts[:, :, 2],
        cnts[:, :, 3], cnts[:, :, 4])

    npos = pref[:, :, -1]
    lowc = pref[:, :, min(firstbound + 1, L)]

    # clean k-window seeds at 0, interval, 2*interval, ... <= lastpos,
    # plus lastpos itself — static slices of the prefix array
    smax = max(1, (L - k) // interval + 1)
    sps = [s * interval for s in range(smax)]
    clean = jnp.stack(
        [(pref[:, :, min(s + k, L)] - pref[:, :, s]) == 0 for s in sps],
        axis=2)                                          # [B, K, S]
    sp = jnp.asarray(sps, jnp.int32)
    sp_ok = sp[None, :] <= lastpos[:, None]              # [B, S]
    clean = clean & sp_ok[:, None, :]
    clean_last = (lp_hi - lp_lo == 0) & (lastpos > 0)[:, None]
    spb = sp[None, None, :]
    BIGP = jnp.int32(2**30)
    pfirst = jnp.min(jnp.where(clean, spb, BIGP), axis=2)
    plast = jnp.max(jnp.where(clean, spb, -1), axis=2)
    pfirst = jnp.where(clean_last,
                       jnp.minimum(pfirst, lastpos[:, None]), pfirst)
    plast = jnp.where(clean_last,
                      jnp.maximum(plast, lastpos[:, None]), plast)
    has_present = pfirst < BIGP

    t5, t3 = _trim_ends_device(mm, lengths, trim_mm_score)
    mmi = mm.astype(jnp.int32)
    nmm_0t3 = jnp.sum(
        mmi * (iota[None, None, :] < (La[:, None] - t3)[:, :, None]),
        axis=2)
    cb_t5 = jnp.sum(
        mmi * (iota[None, None, :] < t5[:, :, None]), axis=2)
    nmm_tt = nmm_0t3 - cb_t5
    nmm_t50 = npos - cb_t5
    return dict(lane_npos=npos, lane_t5=t5, lane_t3=t3,
                lane_lowc=lowc, lane_lbc=lbc,
                lane_cle=cnt_le_mtl, lane_clt=cnt_lt_lmtl,
                lane_pfirst=pfirst, lane_plast=plast,
                lane_present=has_present,
                lane_nmm_tt=nmm_tt, lane_nmm_0t3=nmm_0t3,
                lane_nmm_t50=nmm_t50)


_LANE_FEATURE_KEYS = (
    "lane_npos", "lane_t5", "lane_t3", "lane_lowc", "lane_lbc",
    "lane_cle", "lane_clt", "lane_pfirst", "lane_plast", "lane_present",
    "lane_nmm_tt", "lane_nmm_0t3", "lane_nmm_t50")


def _lane_noop_device(final, cands, lengths, k: int, interval: int,
                      base, ktop_kind_sub: int):
    """(noop bool[B], ind_fires bool[B, K], term_fires bool[B, K]):
    noop is True when the SE host rescue lanes (end indels + terminals,
    and therefore the GMAP improvement pass that only fires on
    terminals) provably produce NOTHING, so emission can use the
    compact fast path without fetching the full tree.  Mirrors
    runner._se_lane_noop exactly; rows it cannot prove stay False.
    ind_fires/term_fires flag the candidate slots each lane must
    examine (supersets of the host tests at its own done level)."""
    B = lengths.shape[0]
    La = lengths.astype(jnp.int32)
    spansize = -(-k // interval) * interval
    budget = jnp.maximum((La + interval - 1) // spansize - 2, 0)
    np_ = final["npaths"]
    score0 = final["score"][:, 0]
    done = jnp.minimum(budget, jnp.where(np_ > 0, score0, 10**6))
    lastpos = La - k
    minlength = jnp.minimum(La // 3, 40)

    cl = cands["cand_left"]
    cp = cands["cand_plusp"]
    cn = cands["cand_nmm"]
    valid = cn < BIG_NMM

    d = done[:, None]
    # end-indel entry mismatches (find_end_indels, stage1hr.c:6001)
    mmi = d - base.indel_penalty_end
    npos = cands["lane_npos"]
    lowc = cands["lane_lowc"]
    lbc = cands["lane_lbc"]
    ind_entry = ((npos > 0)
                 & (((lowc >= 1) & (npos - lowc <= mmi))
                    | ((npos - lbc >= 1) & (lbc <= mmi))))
    ind_fires = (done >= base.indel_penalty_end)[:, None] & valid & ind_entry

    # terminal variants (make_terminals)
    t5 = cands["lane_t5"]
    t3 = cands["lane_t3"]
    pfirst = cands["lane_pfirst"]
    plast = cands["lane_plast"]
    longb = cands["lane_present"] & (plast - pfirst > k)
    start_term = pfirst >= interval
    end_term = plast < (lastpos - interval)[:, None]

    def accept(t5v, t3v, nmm_trim):
        span = La[:, None] - t5v - t3v
        ok = span > minlength[:, None]
        ok &= (span - nmm_trim) - 3 * nmm_trim >= 0
        ok &= nmm_trim <= d
        ok &= ~((t5v == 0) & (t3v == 0) & (cn <= d))
        return ok

    z = jnp.zeros_like(t5)
    lt5 = jnp.where(start_term, t5, z)
    lt3 = jnp.where(end_term, t3, z)
    # long-branch nmm over [lt5, L - lt3): recompose from the
    # precomputed spans (nmm_tt covers [t5, L-t3))
    nmm_long = (jnp.where(start_term & end_term, cands["lane_nmm_tt"],
                jnp.where(start_term, cands["lane_nmm_t50"],
                jnp.where(end_term, cands["lane_nmm_0t3"], npos))))
    v_long = longb & accept(lt5, lt3, nmm_long)
    c1 = (npos <= d) | (cands["lane_cle"] <= d)
    c2 = (npos <= d) | (cands["lane_clt"] >= npos - d)
    v1 = ~longb & c1 & accept(z, t3, cands["lane_nmm_0t3"])
    v2 = ~longb & c2 & accept(t5, z, cands["lane_nmm_t50"])
    # sub hits do not mark diagonals used (find_complete_mm skipped
    # at done_level <= fast_level) — every candidate may terminal
    term_exists = valid & (v_long | v1 | v2)
    term_fires = (done >= base.terminal_threshold)[:, None] & term_exists

    gated = (np_ == 1) & (final["kind"][:, 0] == KIND_SUB)
    noop = gated & ~jnp.any(ind_fires | term_fires, axis=1)
    # per-candidate verdicts: host lanes iterate ONLY flagged slots
    # (ind_fires/term_fires are supersets of the host lanes' entry/
    # acceptance tests at the host's — possibly lower — done level)
    return noop, ind_fires, term_fires


# ------------------------------------------------------------- pair selection

def _select_pairs(top_d, votes, mask_fn, maxpairs: int):
    """Choose up to ``maxpairs`` ordered diagonal pairs (i -> left part,
    j -> right part) per read, ranked by vote sum.

    mask_fn(di, dj) -> bool[B, NC, NC] eligibility.
    Returns (ii, jj, valid) each int32/bool[B, maxpairs]."""
    b, nc = top_d.shape
    di = top_d[:, :, None]
    dj = top_d[:, None, :]
    okd = (top_d != INVALID_DIAG)
    eligible = mask_fn(di, dj) & okd[:, :, None] & okd[:, None, :]
    score = votes[:, :, None] + votes[:, None, :]
    score = jnp.where(eligible, score, -1).reshape(b, nc * nc)
    order = jnp.argsort(-score, axis=1, stable=True)[:, :maxpairs]
    valid = jnp.take_along_axis(score.reshape(b, -1), order, axis=1) >= 0
    ii = (order // nc).astype(jnp.int32)
    jj = (order % nc).astype(jnp.int32)
    return ii, jj, valid


def _gather_pair(arr, idx):
    """arr [B, NC, ...] gathered at idx [B, P] -> [B, P, ...]."""
    return arr[jnp.arange(arr.shape[0])[:, None], idx]


# ----------------------------------------------------------------- indel solve

def _solve_indels(top_d, mm, pref, ii, jj, pvalid, lengths, budget, lmax: int,
                  qp5=None, qp3=None, max_ins: int = MAX_MIDDLE_INSERTIONS,
                  max_del: int = MAX_MIDDLE_DELETIONS,
                  min_end: int = MIN_INDEL_END_MATCHES):
    """Vectorized solve_middle_insertion/deletion.

    Returns dict of [B, P] arrays: valid, is_del, nindels, split (query
    position where part 2 begins on dL for deletions / where the
    inserted bases begin for insertions, i.e. the reference indel_pos),
    nmm1, nmm2, left (dL), right (dR).

    qp5/qp3 [B, K]: per-candidate-diagonal first/last seed query
    positions; pairing requires the left piece's seeds to end before
    the right piece's start (find_middle_indels, stage1hr.c:4559
    "segmentj->querypos3 < segmenti->querypos5") — without this gate,
    a diagonal seeded only far from the junction can fabricate a tiny
    indel flank the reference cannot represent.
    """
    b, p = ii.shape
    di = _gather_pair(top_d, ii)      # left-part diagonal  [B, P] uint32
    dj = _gather_pair(top_d, jj)      # right-part diagonal
    mm_i = _gather_pair(mm, ii)       # [B, P, L]
    mm_j = _gather_pair(mm, jj)
    pref_i = _gather_pair(pref, ii)   # [B, P, L+1]
    pref_j = _gather_pair(pref, jj)

    L = lengths[:, None]              # [B, 1]
    tot_j = jnp.take_along_axis(
        pref_j, L[:, :, None].astype(jnp.int32), axis=2
    )[:, :, 0][:, :, None]            # broadcastable total mismatches at dj

    ndel = (dj - di).astype(jnp.int32)   # >0 for deletions
    nins = (di - dj).astype(jnp.int32)   # >0 for insertions
    is_del = (ndel >= 1) & (ndel <= max_del)
    is_ins = (nins >= 1) & (nins <= max_ins)
    n = jnp.where(is_del, ndel, nins)[:, :, None]  # [B, P, 1]

    s = jnp.arange(lmax + 1, dtype=jnp.int32)[None, None, :]  # [1, 1, L+1]

    # suffix mismatch count of query[s':L] at dj, where s' = s (deletion,
    # shift 0) or s + n (insertion, shift n <= 9): a gather at s + n_eff
    nsh = max_ins + 1  # shifts 0..max_ins
    n_eff = jnp.where(is_del, 0, jnp.clip(nins, 0, max_ins))
    at_shift = s + n_eff[:, :, None]                    # [B, P, L+1]

    pref_pad = jnp.pad(pref_j, ((0, 0), (0, 0), (0, nsh - 1)), mode="edge")
    pref_j_at = jnp.take_along_axis(pref_pad, at_shift, axis=2)
    total = pref_i + (tot_j - pref_j_at)  # [B, P, L+1] mismatch sum per split

    # candidate splits (reference scans mismatch positions only):
    #   deletion:  s = mm_j position + 1, or s = mm_i position
    #   insertion: s = mm_j position - n + 1, or s = mm_i position
    pad_i = jnp.pad(mm_i, ((0, 0), (0, 0), (0, 1)))           # mm_i[s], s<L
    # mm_j at (s + n_eff - 1): left-pad absorbs the -1; padding is False
    # so the s=0 deletion candidate is correctly absent
    mm_pad = jnp.pad(mm_j, ((0, 0), (0, 0), (1, nsh - 1)))
    mmj_at = jnp.take_along_axis(mm_pad, at_shift, axis=2)
    cand = pad_i.astype(bool) | mmj_at

    # bounds: indel_pos in [4, L-4]; insertions also need s + n <= L - 4
    hi = jnp.where(is_del[:, :, None], L[:, :, None], L[:, :, None] - n)
    inb = (s >= min_end) & (s <= hi - min_end)

    # pack (mismatch_sum, split) into one sortable key; radix derived
    # from lmax so reads longer than a fixed constant can't corrupt
    # the split position (next power of two >= lmax + 2)
    radix = 1 << (lmax + 1).bit_length()
    key = jnp.where(cand & inb, total * radix + s, BIG_SCORE)
    bestkey = jnp.min(key, axis=2)
    split = bestkey % radix
    best_sum = bestkey // radix

    valid = (
        pvalid
        & (is_del | is_ins)
        & (bestkey < BIG_SCORE)
        & (best_sum <= budget[:, None])
    )
    if qp5 is not None:
        qp3_i = _gather_pair(qp3, ii)   # left piece's last seed qpos
        qp5_j = _gather_pair(qp5, jj)   # right piece's first seed qpos
        valid = valid & (qp3_i < qp5_j)
    nmm1 = jnp.take_along_axis(pref_i, split[:, :, None], axis=2)[:, :, 0]
    return {
        "valid": valid,
        "is_del": is_del,
        "nindels": jnp.where(valid, n[:, :, 0], 0),
        "split": jnp.where(valid, split, 0),
        "nmm1": nmm1,
        "nmm2": jnp.where(valid, best_sum - nmm1, 0),
        "left": di,
        "right": dj,
    }


# ---------------------------------------------------------------- splice solve

def _suff_local(support, nmm, prob):
    """sufficient_splice_prob_local (stage1hr.c:6093)."""
    s = support - 3 * nmm
    thr = jnp.where(s < 14, 0.95, jnp.where(s < 20, 0.90, jnp.where(s < 26, 0.85, 0.70)))
    return prob > thr


def _fetch_span(genome, d, lmax: int):
    """Codes at genome positions d + (-20 .. lmax + 20) -> [B, P, L+41].

    Word-based fetch: one aligned gather per 16 nt + vector unpack
    (near-start underflow wraps to the clamped pad word; those pairs
    are masked by the di/dj >= 64 guard in _solve_splices)."""
    start = d.astype(jnp.uint32) - jnp.uint32(20)
    return genome_ops.fetch_span_codes(genome.ref16, start, lmax + 41)


SPLICE_CANDS = 16  # splice positions scored per pair per sense class


def _solve_splices(genome, top_d, pref, ii, jj, pvalid, lengths, budget,
                   lmax: int, novel: bool = True, known=None):
    """Vectorized solve_singlesplice over selected pairs.

    novel: scan GT-AG / CT-AC dinucleotides (novelsplicingp).  known:
    optional (donor, acceptor, antidonor, antiacceptor) genome-length
    BITMASK vectors (uint32 words) — known sites are candidates
    regardless of dinucleotide and score prob 1.0 (stage1hr.c:6330-6339).

    Structure: candidate positions come from cheap vector ops
    (dinucleotide compare on word-fetched spans + bitmask spans + the
    mismatch budget); maxent tables are then gathered ONLY at the top
    SPLICE_CANDS candidates per class, not at every scan position.

    Returns dict of [B, P] arrays: valid, split, sense (True = GT-AG on
    plus genome), prob_d, prob_a, nmm1, nmm2, left, right.
    """
    di = _gather_pair(top_d, ii)
    dj = _gather_pair(top_d, jj)
    pref_i = _gather_pair(pref, ii)
    pref_j = _gather_pair(pref, jj)
    L = lengths[:, None]
    tot_j = jnp.take_along_axis(
        pref_j, L[:, :, None].astype(jnp.int32), axis=2
    )[:, :, 0][:, :, None]

    span_i = _fetch_span(genome, di, lmax)  # [B, P, lmax+41], origin 20
    span_j = _fetch_span(genome, dj, lmax)
    npos = lmax + 1
    s = jnp.arange(npos, dtype=jnp.int32)[None, None, :]

    def at(span, rel):  # code at splice-scan position s + rel
        return jax.lax.slice_in_dim(span, 20 + rel, 20 + rel + npos, axis=2)

    # sense: donor GT on segmenti at [s, s+1]; acceptor AG on segmentj at
    # [s-2, s-1].  antisense: antiacceptor CT on segmenti at [s, s+1];
    # antidonor AC on segmentj at [s-2, s-1].  (genome_hr site scans)
    if novel:
        donor_i = (at(span_i, 0) == 2) & (at(span_i, 1) == 3)
        acc_j = (at(span_j, -2) == 0) & (at(span_j, -1) == 2)
        antiacc_i = (at(span_i, 0) == 1) & (at(span_i, 1) == 3)
        antidon_j = (at(span_j, -2) == 0) & (at(span_j, -1) == 1)
    else:
        z = jnp.zeros(span_i.shape[:2] + (npos,), bool)
        donor_i = acc_j = antiacc_i = antidon_j = z
    if known is not None:
        kd_i = genome_ops.fetch_span_bits(known[0], di, npos)
        ka_j = genome_ops.fetch_span_bits(known[1], dj, npos)
        kad_j = genome_ops.fetch_span_bits(known[2], dj, npos)
        kaa_i = genome_ops.fetch_span_bits(known[3], di, npos)
    else:
        z = jnp.zeros(span_i.shape[:2] + (npos,), bool)
        kd_i = ka_j = kad_j = kaa_i = z
    donor_i = donor_i | kd_i
    acc_j = acc_j | ka_j
    antiacc_i = antiacc_i | kaa_i
    antidon_j = antidon_j | kad_j

    # splice_pos range [2, L-2] (stage1hr.c:6262), genome margins
    inb = (
        (s >= 2)
        & (s <= L[:, :, None] - 2)
        & (di[:, :, None] >= 64)
        & (dj[:, :, None] >= 64)
    )

    nmm_i = pref_i[:, :, :npos].astype(jnp.int32)
    nmm_j = (tot_j - pref_j[:, :, :npos]).astype(jnp.int32)
    under = (nmm_i + nmm_j) <= budget[:, None, None]

    def solve_class(cand, kn_i, kn_j, kind_i, kind_j):
        """Score the top SPLICE_CANDS candidate positions of one sense
        class.  Returns (best prob sum, split, prob_i, prob_j) [B, P]."""
        k = SPLICE_CANDS
        key = jnp.where(cand, s, jnp.int32(npos + 7))
        negk, _ = jax.lax.top_k(-key, k)        # k smallest s, ascending
        sel = -negk                              # [B, P, k] ascending s
        sel_ok = sel < npos
        sel_c = jnp.clip(sel, 0, npos - 1)

        def pick(x):  # [B, P, S] -> [B, P, k]
            return jnp.take_along_axis(x, sel_c, axis=2)

        def prob_at_sel(span, kind):
            odds = None
            tables = maxent._tables_jnp()
            for name, idx in maxent.splice_idx_span(span, kind, npos):
                factor = tables[name][pick(idx)]
                odds = factor if odds is None else odds * factor
            return (odds / (1.0 + odds)).astype(jnp.float32)

        p_i = prob_at_sel(span_i, kind_i)
        p_j = prob_at_sel(span_j, kind_j)
        p_i = jnp.where(pick(kn_i), 1.0, p_i)
        p_j = jnp.where(pick(kn_j), 1.0, p_j)
        mi = pick(nmm_i)
        mj = pick(nmm_j)
        sup_i = sel_c
        sup_j = L[:, :, None] - sel_c
        ok = (
            sel_ok
            & _suff_local(sup_i, mi, p_i)
            & _suff_local(sup_j, mj, p_j)
        )
        prob = jnp.where(ok, p_i + p_j, -1.0)
        # first maximum = smallest splice_pos (sel ascending)
        bi = jnp.argmax(prob, axis=2)
        take = lambda x: jnp.take_along_axis(x, bi[:, :, None], axis=2)[:, :, 0]
        return take(prob), take(sel_c), take(p_i), take(p_j)

    prob_s, split_s, pd_s, pa_s = solve_class(
        donor_i & acc_j & inb & under, kd_i, ka_j, "donor", "acceptor")
    prob_a_, split_a, pa_i, pd_j = solve_class(
        antiacc_i & antidon_j & inb & under, kaa_i, kad_j,
        "antiacceptor", "antidonor")

    use_anti = prob_a_ > prob_s  # antisense must strictly beat sense
    split = jnp.where(use_anti, split_a, split_s).astype(jnp.int32)
    prob = jnp.where(use_anti, prob_a_, prob_s)
    valid = pvalid & (prob > 0.0)

    split_cl = jnp.clip(split, 0, npos - 1)
    pick2 = lambda x: jnp.take_along_axis(x, split_cl[:, :, None], axis=2)[:, :, 0]
    nmm1 = pick2(nmm_i)
    nmm2 = pick2(nmm_j)
    # donor/acceptor probabilities for output (sense: donor on i; anti:
    # donor on j)
    prob_d = jnp.where(use_anti, pd_j, pd_s)
    prob_a = jnp.where(use_anti, pa_i, pa_s)
    return {
        "valid": valid,
        "split": jnp.where(valid, split, 0),
        "sense": ~use_anti,
        "prob_d": jnp.where(valid, prob_d, 0.0),
        "prob_a": jnp.where(valid, prob_a, 0.0),
        "nmm1": jnp.where(valid, nmm1, 0),
        "nmm2": jnp.where(valid, nmm2, 0),
        "left": di,
        "right": dj,
    }


def _select_triples(top_d, votes, maxdist, ntriples: int):
    """Choose up to ``ntriples`` diagonal triples (i < m < j, each step
    within maxdist) per read, ranked by vote sum — the candidate set of
    find_doublesplices (stage1hr.c:7698-7742 potentiali x potentialj
    around each middle segment).  Returns (ti, tm, tj, valid).

    Decomposed per middle segment: the vote sum is separable, so each
    middle's best triples use its top-2 eligible predecessors x top-2
    successors (4 combos/middle) and the top ``ntriples`` combos win —
    the old dense [B, NC^3] ranking materialized 16 GB at the wide
    lane's ncand=128 (HBM OOM) for identical leading choices."""
    b, nc = top_d.shape
    di = top_d[:, :, None]
    dj = top_d[:, None, :]
    okd = top_d != INVALID_DIAG
    step = ((dj - di) >= jnp.uint32(1)) & ((dj - di) <= jnp.uint32(maxdist))
    elig = step & okd[:, :, None] & okd[:, None, :]       # edge i -> j
    vi = jnp.where(elig, jnp.broadcast_to(votes[:, :, None], elig.shape), -1)
    v2i, i2 = jax.lax.top_k(vi.transpose(0, 2, 1), 2)    # per m: best i
    vj = jnp.where(elig, jnp.broadcast_to(votes[:, None, :], elig.shape), -1)
    v2j, j2 = jax.lax.top_k(vj, 2)                        # per m: best j
    vsum = (votes[:, :, None, None] + v2i[:, :, :, None]
            + v2j[:, :, None, :])                         # [B, m, 2, 2]
    okc = ((v2i[:, :, :, None] >= 0) & (v2j[:, :, None, :] >= 0)
           & okd[:, :, None, None])
    vsum = jnp.where(okc, vsum, -1).reshape(b, nc * 4)
    order = jnp.argsort(-vsum, axis=1, stable=True)[:, :ntriples]
    valid = jnp.take_along_axis(vsum, order, axis=1) >= 0
    m_sel = (order // 4).astype(jnp.int32)
    a_sel = ((order // 2) % 2).astype(jnp.int32)
    b_sel = (order % 2).astype(jnp.int32)
    ti = jnp.take_along_axis(
        i2.reshape(b, nc * 2), m_sel * 2 + a_sel, axis=1).astype(jnp.int32)
    tj = jnp.take_along_axis(
        j2.reshape(b, nc * 2), m_sel * 2 + b_sel, axis=1).astype(jnp.int32)
    return ti, m_sel, tj, valid


def _solve_doublesplices(genome, top_d, pref, ti, tm, tj, tvalid, lengths,
                         budget, lmax: int, novel: bool = True, known=None):
    """Vectorized solve_doublesplice (stage1hr.c:6612): short middle
    exon between two local introns.

    For each triple (i, m, j): splice_pos_1 must be a donor on segment
    i AND an acceptor on segment m; splice_pos_2 > splice_pos_1 a donor
    on m AND an acceptor on j (sense; antisense uses antiacceptor/
    antidonor with roles reversed).  Score = mismatches of the three
    pieces; best by (lowest score, then highest summed prob), each of
    the four junction probs gated by sufficient_splice_prob_local.

    Returns dict of [B, T] arrays: valid, split, split2, sense,
    prob_d, prob_a, prob_d2, prob_a2, nmm1, nmm2, nmm3, left, mid,
    right.
    """
    di = _gather_pair(top_d, ti)
    dm = _gather_pair(top_d, tm)
    dj = _gather_pair(top_d, tj)
    pref_i = _gather_pair(pref, ti)
    pref_m = _gather_pair(pref, tm)
    pref_j = _gather_pair(pref, tj)
    L = lengths[:, None]
    tot_j = jnp.take_along_axis(
        pref_j, L[:, :, None].astype(jnp.int32), axis=2)[:, :, 0][:, :, None]

    span_i = _fetch_span(genome, di, lmax)
    span_m = _fetch_span(genome, dm, lmax)
    span_j = _fetch_span(genome, dj, lmax)
    npos = lmax + 1
    s = jnp.arange(npos, dtype=jnp.int32)[None, None, :]

    def at(span, rel):
        return jax.lax.slice_in_dim(span, 20 + rel, 20 + rel + npos, axis=2)

    def sites(span, kind):
        if not novel:
            return jnp.zeros(span.shape[:2] + (npos,), bool)
        if kind == "donor":          # GT at [s, s+1]
            return (at(span, 0) == 2) & (at(span, 1) == 3)
        if kind == "acceptor":       # AG at [s-2, s-1]
            return (at(span, -2) == 0) & (at(span, -1) == 2)
        if kind == "antiacceptor":   # CT at [s, s+1]
            return (at(span, 0) == 1) & (at(span, 1) == 3)
        return (at(span, -2) == 0) & (at(span, -1) == 1)  # antidonor AC

    def ksites(bits, d):
        if known is None:
            return jnp.zeros(d.shape + (npos,), bool)
        return genome_ops.fetch_span_bits(bits, d, npos)

    kd_i = ksites(known[0], di) if known is not None else sites(span_i, "x") & False
    ka_m = ksites(known[1], dm) if known is not None else kd_i
    kd_m = ksites(known[0], dm) if known is not None else kd_i
    ka_j = ksites(known[1], dj) if known is not None else kd_i
    kad_j = ksites(known[2], dj) if known is not None else kd_i
    kaa_m = ksites(known[3], dm) if known is not None else kd_i
    kad_m = ksites(known[2], dm) if known is not None else kd_i
    kaa_i = ksites(known[3], di) if known is not None else kd_i

    inb = ((s >= 2) & (s <= L[:, :, None] - 2)
           & (di[:, :, None] >= 64) & (dm[:, :, None] >= 64)
           & (dj[:, :, None] >= 64))
    nmm_i = pref_i[:, :, :npos].astype(jnp.int32)          # nmm[0:s) on i
    cum_m = pref_m[:, :, :npos].astype(jnp.int32)
    nmm_j_suf = (tot_j - pref_j[:, :, :npos]).astype(jnp.int32)

    K = 8  # candidate junction positions kept per junction per sense

    def topk_sel(cand):
        key = jnp.where(cand, s, jnp.int32(npos + 7))
        negk, _ = jax.lax.top_k(-key, K)
        sel = -negk                                        # ascending s
        return jnp.clip(sel, 0, npos - 1), sel < npos

    def pick_at(x, sel):  # [B, T, S] -> [B, T, K]
        return jnp.take_along_axis(x, sel, axis=2)

    def probs_at(span, kind, sel):
        odds = None
        tables = maxent._tables_jnp()
        for name, idx in maxent.splice_idx_span(span, kind, npos):
            factor = tables[name][pick_at(idx, sel)]
            odds = factor if odds is None else odds * factor
        return (odds / (1.0 + odds)).astype(jnp.float32)

    def solve_sense(c1, c2, k1_i, k1_m, k2_m, k2_j,
                    kind1_i, kind1_m, kind2_m, kind2_j):
        sel1, ok1 = topk_sel(c1 & inb)
        sel2, ok2 = topk_sel(c2 & inb)
        p1i = jnp.where(pick_at(k1_i, sel1), 1.0, probs_at(span_i, kind1_i, sel1))
        p1m = jnp.where(pick_at(k1_m, sel1), 1.0, probs_at(span_m, kind1_m, sel1))
        p2m = jnp.where(pick_at(k2_m, sel2), 1.0, probs_at(span_m, kind2_m, sel2))
        p2j = jnp.where(pick_at(k2_j, sel2), 1.0, probs_at(span_j, kind2_j, sel2))
        mi1 = pick_at(nmm_i, sel1)         # nmm on i in [0, sp1)
        cm1 = pick_at(cum_m, sel1)
        cm2 = pick_at(cum_m, sel2)
        mj2 = pick_at(nmm_j_suf, sel2)     # nmm on j in [sp2, L)
        # joint [B, T, K1, K2]
        sp1 = sel1[:, :, :, None]
        sp2 = sel2[:, :, None, :]
        okp = (ok1[:, :, :, None] & ok2[:, :, None, :] & (sp2 > sp1))
        nmm1 = mi1[:, :, :, None]
        nmm2 = cm2[:, :, None, :] - cm1[:, :, :, None]
        nmm3 = mj2[:, :, None, :]
        total = nmm1 + nmm2 + nmm3
        okp = okp & (total <= budget[:, None, None, None]) & (nmm2 >= 0)
        sup1 = sp1
        sup_m = sp2 - sp1
        sup3 = L[:, :, None, None] - sp2
        g = (_suff_local(sup1, nmm1, p1i[:, :, :, None])
             & _suff_local(sup_m, nmm2, p1m[:, :, :, None])
             & _suff_local(sup_m, nmm2, p2m[:, :, None, :])
             & _suff_local(sup3, nmm3, p2j[:, :, None, :]))
        okp = okp & g
        prob = (p1i[:, :, :, None] + p1m[:, :, :, None]
                + p2m[:, :, None, :] + p2j[:, :, None, :])
        key = jnp.where(okp, -total.astype(jnp.float32) * 8.0 + prob, -1e9)
        kf = key.reshape(key.shape[:2] + (K * K,))
        best = jnp.argmax(kf, axis=2)
        bval = jnp.take_along_axis(kf, best[:, :, None], 2)[:, :, 0]
        b1 = best // K
        b2 = best % K
        take1 = lambda x: jnp.take_along_axis(x, b1[:, :, None], 2)[:, :, 0]
        take2 = lambda x: jnp.take_along_axis(x, b2[:, :, None], 2)[:, :, 0]
        return dict(score=bval, sp1=take1(sel1), sp2=take2(sel2),
                    p1i=take1(p1i), p1m=take1(p1m),
                    p2m=take2(p2m), p2j=take2(p2j),
                    nmm1=take1(mi1),
                    nmm2=take2(cm2) - take1(cm1),
                    nmm3=take2(mj2))

    sense = solve_sense(
        (sites(span_i, "donor") | kd_i) & (sites(span_m, "acceptor") | ka_m),
        (sites(span_m, "donor") | kd_m) & (sites(span_j, "acceptor") | ka_j),
        kd_i, ka_m, kd_m, ka_j,
        "donor", "acceptor", "donor", "acceptor")
    anti = solve_sense(
        (sites(span_i, "antiacceptor") | kaa_i)
        & (sites(span_m, "antidonor") | kad_m),
        (sites(span_m, "antiacceptor") | kaa_m)
        & (sites(span_j, "antidonor") | kad_j),
        kaa_i, kad_m, kaa_m, kad_j,
        "antiacceptor", "antidonor", "antiacceptor", "antidonor")

    use_anti = anti["score"] > sense["score"]
    pickd = lambda k: jnp.where(use_anti, anti[k], sense[k])
    score = pickd("score")
    valid = tvalid & (score > -1e8)
    sp1 = pickd("sp1").astype(jnp.int32)
    sp2 = pickd("sp2").astype(jnp.int32)
    return {
        "valid": valid,
        "split": jnp.where(valid, sp1, 0),
        "split2": jnp.where(valid, sp2, 0),
        "sense": ~use_anti,
        # junction probs in DONOR/ACCEPTOR display order per junction
        "prob_d": jnp.where(valid, jnp.where(use_anti, anti["p2j"], sense["p1i"]), 0.0),
        "prob_a": jnp.where(valid, jnp.where(use_anti, anti["p2m"], sense["p1m"]), 0.0),
        "prob_d2": jnp.where(valid, jnp.where(use_anti, anti["p1m"], sense["p2m"]), 0.0),
        "prob_a2": jnp.where(valid, jnp.where(use_anti, anti["p1i"], sense["p2j"]), 0.0),
        "nmm1": jnp.where(valid, pickd("nmm1").astype(jnp.int32), 0),
        "nmm2": jnp.where(valid, pickd("nmm2").astype(jnp.int32), 0),
        "nmm3": jnp.where(valid, pickd("nmm3").astype(jnp.int32), 0),
        "left": di,
        "mid": dm,
        "right": dj,
    }


# -------------------------------------------------------------- full pipeline

def _strand_hits(genome, index, queries, codes, nflags, lengths, conv, alt,
                 budget, params: GappedParams, known=None):
    """Run seed -> vote -> verify -> indel/splice for one strand.

    Returns a dict of [B, K] hit-candidate arrays for this strand."""
    base = params.base
    oligos, valid = _extract_oligos(
        _convert_codes(codes, conv), nflags, lengths, index.k
    )
    diag, qpos_grid, trunc, nphase_min, nph_half = _seed_diagonals(
        index, oligos, valid, base, lengths)
    top_d, votes, ndistinct = _top_diagonals(diag, base.ncand)
    overflow = trunc | (ndistinct > base.ncand)

    mm, pref = _prefix_mm(genome, queries, top_d, lengths, conv, alt)

    # substitution-only hits: the full-span verify count is the final
    # prefix total (positions past each read's length are masked in the
    # mismatch matrix, so the static last slice is exact) — shares
    # _prefix_mm's genome fetch instead of a second span gather.
    # Invalid diagonals become all-mismatch rows there; map them back to
    # BIG_NMM to keep _verify's contract for the host rescue lanes.
    dok = (top_d != INVALID_DIAG) & (
        top_d + lengths.astype(jnp.uint32)[:, None] <= jnp.uint32(genome.length)
    )
    nmm_raw = jnp.where(dok, pref[:, :, -1], BIG_NMM)
    nmm_sub = jnp.where(nmm_raw <= budget[:, None], nmm_raw, BIG_NMM)

    ii, jj, pv = _select_pairs(
        top_d,
        votes,
        lambda di, dj: (
            ((dj - di).astype(jnp.int32) >= 1)
            & ((dj - di).astype(jnp.int32) <= base.max_middle_deletions)
        )
        | (
            ((di - dj).astype(jnp.int32) >= 1)
            & ((di - dj).astype(jnp.int32) <= base.max_middle_insertions)
        ),
        params.indel_pairs,
    )
    qp5, qp3 = _qpos_ranges(diag, qpos_grid, top_d)
    indels = _solve_indels(top_d, mm, pref, ii, jj, pv, lengths, budget,
                           queries.lmax, qp5=qp5, qp3=qp3,
                           max_ins=base.max_middle_insertions,
                           max_del=base.max_middle_deletions,
                           min_end=base.min_indel_end_matches)

    if params.novelsplicing or known is not None:
        si, sj, sv = _select_pairs(
            top_d,
            votes,
            lambda di, dj: ((dj - di) >= jnp.uint32(1))
            & ((dj - di) <= jnp.uint32(base.shortsplicedist)),
            params.splice_pairs,
        )
        splices = _solve_splices(
            genome, top_d, pref, si, sj, sv, lengths, budget, queries.lmax,
            novel=params.novelsplicing, known=known,
        )
        ti, tm, tj, tv = _select_triples(
            top_d, votes, base.shortsplicedist, params.shortexon_triples)
        shortex = _solve_doublesplices(
            genome, top_d, pref, ti, tm, tj, tv, lengths, budget,
            queries.lmax, novel=params.novelsplicing, known=known,
        )
    else:
        z = jnp.zeros(ii.shape[:1] + (params.splice_pairs,), jnp.int32)
        splices = {
            "valid": z.astype(bool), "split": z, "sense": z.astype(bool),
            "prob_d": z.astype(jnp.float32), "prob_a": z.astype(jnp.float32),
            "nmm1": z, "nmm2": z,
            "left": z.astype(jnp.uint32), "right": z.astype(jnp.uint32),
        }
        zt = jnp.zeros(ii.shape[:1] + (params.shortexon_triples,), jnp.int32)
        shortex = {
            "valid": zt.astype(bool), "split": zt, "split2": zt,
            "sense": zt.astype(bool),
            "prob_d": zt.astype(jnp.float32),
            "prob_a": zt.astype(jnp.float32),
            "prob_d2": zt.astype(jnp.float32),
            "prob_a2": zt.astype(jnp.float32),
            "nmm1": zt, "nmm2": zt, "nmm3": zt,
            "left": zt.astype(jnp.uint32), "mid": zt.astype(jnp.uint32),
            "right": zt.astype(jnp.uint32),
        }

    # assemble candidate hit arrays [B, K]
    def cat(*xs):
        return jnp.concatenate(xs, axis=1)

    b, nc = top_d.shape
    zsub = jnp.zeros((b, nc), jnp.int32)
    kind = cat(
        jnp.full((b, nc), KIND_SUB, jnp.int32),
        jnp.where(indels["is_del"], KIND_DEL, KIND_INS),
        jnp.full_like(splices["split"], KIND_SPLICE),
        jnp.full_like(shortex["split"], KIND_SHORTEXON),
    )
    ind_nmm = indels["nmm1"] + indels["nmm2"]
    spl_nmm = splices["nmm1"] + splices["nmm2"]
    shx_nmm = shortex["nmm1"] + shortex["nmm2"] + shortex["nmm3"]
    score = cat(
        nmm_sub,
        jnp.where(indels["valid"], ind_nmm + base.indel_penalty_middle, BIG_NMM),
        jnp.where(splices["valid"], spl_nmm + base.localsplicing_penalty, BIG_NMM),
        jnp.where(shortex["valid"], shx_nmm + 2 * base.localsplicing_penalty,
                  BIG_NMM),
    )
    nmm = cat(jnp.where(nmm_sub < BIG_NMM, nmm_sub, 0), ind_nmm, spl_nmm,
              shx_nmm)
    left = cat(top_d, indels["left"], splices["left"], shortex["left"])
    right = cat(top_d, indels["right"], splices["right"], shortex["right"])
    split = cat(zsub, indels["split"], splices["split"], shortex["split"])
    zspl = jnp.zeros_like(splices["split"])
    zshx = jnp.zeros_like(shortex["split"])
    split2 = cat(zsub, jnp.zeros_like(indels["split"]), zspl,
                 shortex["split2"])
    mid = cat(top_d, indels["left"], splices["left"], shortex["mid"])
    nindels = cat(zsub, indels["nindels"], zspl, zshx)
    sense = cat(
        jnp.zeros((b, nc), bool),
        jnp.zeros_like(indels["valid"]),
        splices["sense"],
        shortex["sense"],
    )
    zf = jnp.zeros((b, nc), jnp.float32)
    zfi = jnp.zeros(indels["split"].shape, jnp.float32)
    prob_d = cat(zf, zfi, splices["prob_d"], shortex["prob_d"])
    prob_a = cat(zf, zfi, splices["prob_a"], shortex["prob_a"])
    prob_d2 = cat(zf, zfi, jnp.zeros_like(splices["prob_d"]),
                  shortex["prob_d2"])
    prob_a2 = cat(zf, zfi, jnp.zeros_like(splices["prob_a"]),
                  shortex["prob_a2"])
    return {
        "kind": kind, "score": score, "nmm": nmm, "left": left, "right": right,
        "split": split, "split2": split2, "mid": mid, "nindels": nindels,
        "sense": sense,
        "prob_d": prob_d, "prob_a": prob_a,
        "prob_d2": prob_d2, "prob_a2": prob_a2,
    }, {
        # unfiltered diagonal candidates (terminal/rescue lanes); the
        # selection mismatch matrix rides along BITPACKED (8x fewer
        # device->host bytes than the raw [B, K, L] mask) — host lanes
        # unpack with np.unpackbits(..., bitorder="little")
        "cand_left": top_d, "cand_votes": votes, "cand_nmm": nmm_raw,
        "cand_mm": _bitpack_mask(mm), "overflow": overflow,
        **_lane_features(mm, pref, nmm_raw, lengths, index.k,
                         index.interval, base.trim_mismatch_score),
        # truncation-only flag: when False for an overflowing read, the
        # seed grid was COMPLETE (no position list hit seed_cap), so the
        # wide re-run only needs a larger candidate budget, not the
        # ~3.5x seed grid (runner._dispatch_wide widecand config)
        "overflow_trunc": trunc,
        # pigeonhole lower bound on the mismatches of ANY diagonal the
        # top-ncand cut dropped (stage1hr.c FLOOR_* floors analog): a
        # placement with m mismatches keeps >= nphase_min - m*ceil(k/q)
        # phase-aligned seeds, and every dropped diagonal has votes <=
        # votes[:, -1] (top_k keeps the ncand largest) => its m >=
        # ceil((nphase_min - v_drop) / ceil(k/q)).  BIG when nothing
        # was dropped.
        "ovf_bound": jnp.where(
            ndistinct > base.ncand,
            jnp.maximum(
                -(-(nphase_min - votes[:, -1])
                  // -(-index.k // index.interval)), 0),
            BIG_NMM),
        # per-half pigeonhole floor for dropped diagonals (reference
        # terminal/end-lane segment filter keeps a segment iff one
        # HALF's floor fits the done level): any dropped diagonal has
        # votes <= votes[:, -1], so either half retains at most that
        # many seeds => its half floor >= this bound
        "hbound": jnp.where(
            ndistinct > base.ncand,
            jnp.maximum(
                -(-(nph_half - votes[:, -1])
                  // -(-index.k // index.interval)), 0),
            BIG_NMM),
    }


def _bitpack_mask(mm):
    """bool[B, K, L] -> uint8[B, K, ceil(L/8)], little-endian bits."""
    b, k, L = mm.shape
    nby = (L + 7) // 8
    mmp = jnp.pad(mm, ((0, 0), (0, 0), (0, nby * 8 - L)))
    mmp = mmp.reshape(b, k, nby, 8).astype(jnp.uint8)
    return (mmp << jnp.arange(8, dtype=jnp.uint8)).sum(
        axis=-1, dtype=jnp.uint8)


def gather_candidates(
    genome, index, index_minus, codes, nflags, lengths, params: GappedParams,
    alt=None, known=None,
):
    """Both-strand candidate gathering: seed/vote/verify + indel/splice
    solvers.  Returns an unranked dict of [B, NCAND] hit fields."""
    base = params.base
    b, lmax = codes.shape
    lengths = lengths.astype(jnp.int32)
    conv_plus, conv_minus = _MODE_CONV[base.mode]
    if index_minus is None:
        index_minus = index

    queries_fwd = _pack_device(codes, nflags, lengths, lmax)
    codes_rc, nflags_rc = _revcomp_batch(codes, nflags, lengths,
                                         base.uniform_len)
    queries_rev = _pack_device(codes_rc, nflags_rc, lengths, lmax)

    if base.max_mismatches >= 0:
        budget = jnp.full((b,), base.max_mismatches, jnp.int32)
    else:
        spansize = -(-index.k // index.interval) * index.interval
        budget = jnp.maximum((lengths + index.interval - 1) // spansize - 2, 0)

    if conv_plus is None and conv_minus is None and index_minus is index:
        # standard mode: both strands share the conversion and index —
        # run them as ONE [2B] batch through the cascade core.  Halves
        # the op count (per-op dispatch/fixed costs dominate many of
        # the small fused kernels) and doubles every gather's batch.
        q2 = mm_ops.PackedQueries(
            codes16=jnp.concatenate([queries_fwd.codes16,
                                     queries_rev.codes16]),
            nflags16=jnp.concatenate([queries_fwd.nflags16,
                                      queries_rev.nflags16]),
            length=jnp.concatenate([queries_fwd.length,
                                    queries_rev.length]),
            lmax=queries_fwd.lmax,
        )
        h2, c2 = _strand_hits(
            genome, index, q2,
            jnp.concatenate([codes, codes_rc]),
            jnp.concatenate([nflags, nflags_rc]),
            jnp.concatenate([lengths, lengths]),
            None, alt, jnp.concatenate([budget, budget]), params, known,
        )
        hf = {k: v[:b] for k, v in h2.items()}
        hr = {k: v[b:] for k, v in h2.items()}
        cf = {k: v[:b] for k, v in c2.items()}
        cr = {k: v[b:] for k, v in c2.items()}
    else:
        hf, cf = _strand_hits(
            genome, index, queries_fwd, codes, nflags, lengths, conv_plus,
            alt, budget, params, known,
        )
        hr, cr = _strand_hits(
            genome, index_minus, queries_rev, codes_rc, nflags_rc, lengths,
            conv_minus, alt, budget, params, known,
        )

    out = {}
    for k in hf:
        out[k] = jnp.concatenate([hf[k], hr[k]], axis=1)
    nplus = hf["kind"].shape[1]
    ncand = out["kind"].shape[1]
    plusp = jnp.concatenate(
        [jnp.ones((b, nplus), bool), jnp.zeros((b, ncand - nplus), bool)], axis=1
    )
    out["plusp"] = plusp
    cands = {k: jnp.concatenate([cf[k], cr[k]], axis=1)
             for k in cf
             if k not in ("overflow", "overflow_trunc", "ovf_bound",
                          "hbound")}
    cands["overflow"] = cf["overflow"] | cr["overflow"]
    cands["overflow_trunc"] = cf["overflow_trunc"] | cr["overflow_trunc"]
    cands["ovf_bound"] = jnp.minimum(cf["ovf_bound"], cr["ovf_bound"])
    cands["hbound"] = jnp.minimum(cf["hbound"], cr["hbound"])
    nc = cf["cand_left"].shape[1]
    cands["cand_plusp"] = jnp.concatenate(
        [jnp.ones((b, nc), bool), jnp.zeros((b, nc), bool)], axis=1
    )
    return out, cands


def rank_hits(out, base: GsnapParams, apply_optimal: bool = True,
              maxout: int | None = None):
    """Dedup + (optional) optimal-score filter + deterministic ranking.

    Index-composition design: all stable sorts act on small int32
    permutation vectors; data fields move ONCE through a composed
    permutation.

    Returns dict of [B, maxout] arrays plus npaths."""
    take_cols = lambda x, i: jnp.take_along_axis(x, i, axis=1)

    ncand = out["kind"].shape[1]
    maxout = base.maxpaths if maxout is None else maxout
    score = out["score"]
    # dedup identical (kind, left, right, split, strand) candidates:
    # multi-pass stable sort (least-significant key first) groups equal
    # tuples adjacently; sorts permute only the index vector
    fields = ["kind", "split", "split2", "mid", "right", "plusp", "left"]
    ordl = jnp.broadcast_to(
        jnp.arange(ncand, dtype=jnp.int32)[None, :], score.shape
    )
    for k in fields:
        f = take_cols(out[k], ordl)
        if f.dtype == jnp.bool_:
            f = f.astype(jnp.int32)
        o = jnp.argsort(f, axis=1, stable=True)
        ordl = take_cols(ordl, o)
    sorted_fields = {k: take_cols(out[k], ordl) for k in fields}
    score_s = take_cols(score, ordl)
    same = jnp.ones_like(score_s, bool)
    for k in fields:
        f = sorted_fields[k].astype(jnp.int32) if sorted_fields[k].dtype == bool else sorted_fields[k]
        same = same & jnp.concatenate(
            [jnp.zeros_like(f[:, :1], bool), f[:, 1:] == f[:, :-1]], axis=1
        )
    score_s = jnp.where(same & (score_s < BIG_NMM), BIG_NMM, score_s)
    # scatter the deduped scores back through the inverse permutation
    inv = jnp.argsort(ordl, axis=1, stable=True)
    score = take_cols(score_s, inv)

    # optimal-score filter (Stage3end_optimal_score, stage3hr.c:3798)
    if apply_optimal:
        best = jnp.min(score, axis=1, keepdims=True)
        score = jnp.where(score > best + base.subopt_levels, BIG_NMM, score)

    # rank: (score asc, left asc, plus first); compose the three stable
    # passes into one final permutation
    plusp = out["plusp"]
    ordp = jnp.argsort(jnp.where(plusp, 0, 1).astype(jnp.int32), axis=1, stable=True)
    left_p = take_cols(out["left"], ordp)
    ordl2 = jnp.argsort(left_p, axis=1, stable=True)
    perm2 = take_cols(ordp, ordl2)
    score2 = take_cols(score, perm2)
    ords = jnp.argsort(score2, axis=1, stable=True)[:, :maxout]
    perm3 = take_cols(perm2, ords)
    final = {k: take_cols(out[k], perm3) for k in out}
    final_score = take_cols(score, perm3)

    ok = final_score < BIG_NMM
    final["score"] = jnp.where(ok, final_score, BIG_NMM)
    final["npaths"] = jnp.sum(ok, axis=1).astype(jnp.int32)
    for k in ("left", "right", "mid"):
        final[k] = jnp.where(ok, final[k], 0).astype(jnp.uint32)
    for k in ("kind", "split", "split2", "nindels", "nmm"):
        final[k] = jnp.where(ok, final[k], 0)
    return final


@partial(jax.jit, static_argnames=("params",))
def align_batch_gapped(
    genome: genome_ops.GenomeArrays,
    index: IndexArrays,
    codes,
    nflags,
    lengths,
    params: GappedParams = GappedParams(),
    index_minus: IndexArrays | None = None,
    alt=None,
    known=None,
):
    """Full single-end pipeline: substitutions + middle indels + local
    splicing (novel when params.novelsplicing; known sites when
    ``known`` arrays are given).

    Returns dict of [B, maxpaths] arrays: kind, score, nmm, left, right,
    split, nindels, sense, prob_d, prob_a, plusp; plus npaths int32[B]
    and unranked cand_* arrays (terminal/rescue candidate diagonals).
    """
    out, cands = gather_candidates(
        genome, index, index_minus, codes, nflags, lengths, params, alt, known
    )
    final = rank_hits(out, params.base)
    final.update(cands)
    # candidate-budget overflow gate (reference floors analog): with
    # splicing off, the rescue lanes that could consume a dropped
    # diagonal (end indels, terminals, middle indel pairs) are all
    # done-level-gated at >= min(indel_penalty, terminal_threshold); for
    # rows below that level only SUB ties matter, and ovf_bound proves
    # no dropped diagonal can reach them — the wide re-run is a no-op,
    # so clear the flag (stage1hr.c FLOOR_END/FLOOR_MIDDLE gating:
    # segments whose floor exceeds done_level are never examined).
    if known is None:
        base = params.base
        lengths_i = lengths.astype(jnp.int32)
        if base.max_mismatches >= 0:
            budget = jnp.full(lengths_i.shape, base.max_mismatches, jnp.int32)
        else:
            spansize = -(-index.k // index.interval) * index.interval
            budget = jnp.maximum(
                (lengths_i + index.interval - 1) // spansize - 2, 0)
        score0 = final["score"][:, 0]
        done = jnp.minimum(
            budget, jnp.where(final["npaths"] > 0, score0, BIG_NMM))
        lane_gate = min(base.indel_penalty_middle, base.indel_penalty_end,
                        base.terminal_threshold)
        if params.novelsplicing:
            # novel splice/shortexon solvers admit dropped diagonals at
            # localsplicing_penalty (0): only the floor-bound branch
            # can clear overflow
            lane_gate = min(lane_gate, base.localsplicing_penalty)
        so = base.subopt_levels
        # two clearing conditions for candidate-budget overflow:
        #  (1) done below every lane gate AND no dropped diagonal can
        #      reach the sub ladder (full-span floor bound);
        #  (2) a real hit exists AND dropped diagonals can reach
        #      neither the sub/indel ladder (full-span bound) nor the
        #      terminal/end lanes' per-half segment filter (half
        #      bound) — the reference keeps a segment for those lanes
        #      iff one HALF's floor fits done
        #      (identify_all_segments_for_terminals, stage1hr.c:3665);
        #      the distant lane only runs when nothing was found, so
        #      npaths > 0 rules it out (stage1hr.c:12207 gating).
        safe = (((done + so < lane_gate)
                 | ((final["npaths"] > 0) & (final["hbound"] > done + so)))
                & (final["ovf_bound"] > done + so)
                # the floor bound assumes the seed grid was COMPLETE:
                # truncation means positions are missing entirely, so
                # trunc-type overflow always rescues
                & ~final["overflow_trunc"])
        final["overflow"] = final["overflow"] & ~safe
    final.pop("ovf_bound")
    final.pop("hbound", None)
    # device lane-noop gate: rows where the host rescue lanes provably
    # change nothing can emit from the compact view alone, skipping the
    # full-tree row-subset fetch entirely (runner.run need_full);
    # lane_ind/lane_term are per-candidate verdicts so the host lanes
    # only touch flagged slots
    if params.base.trim_mismatch_score == -3:
        noop, ind_f, term_f = _lane_noop_device(
            final, final, lengths, index.k, index.interval, params.base,
            KIND_SUB)
        final["lane_noop"] = noop
        final["lane_ind"] = ind_f
        final["lane_term"] = term_f
    else:
        final["lane_noop"] = jnp.zeros(lengths.shape[0], bool)
    # the intermediate lane features exist only to feed the gate —
    # drop them from the result tree (they dominated the row-subset
    # fetch payload: 13 x [B, 2K] int32)
    for key in _LANE_FEATURE_KEYS:
        final.pop(key, None)
    return final


# the ranked per-hit fields SAM/native emission reads through
# runner._end_hit (+ score for the rescue-lane gating decision)
SE_EMIT_FIELDS = ("kind", "left", "right", "split", "nindels", "sense",
                  "plusp", "mid", "split2", "score", "nmm")


# compact-view dtype slimming: these fields have small value ranges and
# ride the uint8 buffer, shrinking the per-batch device->host payload
_SMALL_FIELDS = {"kind": jnp.uint8, "nindels": jnp.int8}


def _slim(out):
    for k, dt in _SMALL_FIELDS.items():
        if k in out:
            out[k] = out[k].astype(dt)
    return out


def compact_se(res, ktop: int = 8):
    """Emission-compact view of an align_batch_gapped result: the
    top-ktop ranked hit fields plus npaths/overflow.  The full tree
    (incl. the cand_* arrays the terminal/end-indel rescue lanes need)
    stays on device; rows whose emission needs it are fetched as a row
    subset (runner.fetch_record_rows).  Same transfer-volume design as
    gsnap_pe.compact_pe."""
    out = {k: res[k][:, :ktop] for k in SE_EMIT_FIELDS if k in res}
    out["npaths"] = res["npaths"]
    for key in ("overflow", "overflow_trunc", "lane_noop"):
        if key in res:
            out[key] = res[key]
    return _slim(out)
