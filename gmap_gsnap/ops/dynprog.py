"""Batched banded affine-gap DP — the dynprog kernel family on device.

Batched re-design of the reference's per-thread Gotoh solvers
(src/dynprog.c:1424 compute_scores_lookup_fwd/rev, :3291
bridge_intron_gap, :4450 Dynprog_single_gap, :4836 Dynprog_genome_gap,
:5100/:5600 Dynprog_end5_gap/Dynprog_end3_gap, :2236/:2294/:2359
find_best_endpoint*).  The reference runs one small O(M*band) DP per
gap per thread; here ONE jitted kernel solves a whole batch of gap
problems at once:

  * band-packed layout: score[b, r, k] with k = c - r + lband, so the
    three Gotoh states (nogap / gap1 = gap in query consuming genome /
    gap2 = gap in genome consuming query) become [B, W] vectors swept
    by a single lax.scan over query rows;
  * the within-row affine recurrence gap1[c] = max(nogap[c-1]+open,
    gap1[c-1]) + extend is reassociated into an exclusive running max
    (gap1[c] = extend*c + max_{j<c}(nogap[j] + open - extend*j)), so
    each row is pure vector ops — no sequential inner loop;
  * traceback is a batched device scan over the direction state
    machine, emitting fixed-size edit scripts;
  * bridge_intron_gap's (rL, cL) x (rR, cR) junction search becomes a
    single masked argmax over a [B, M, 2W] candidate tensor whose
    linear order replicates the reference's strict-'>' update order.

Scoring semantics (verified against src/dynprog.c:141-300,1045-1240):
FULLMATCH 3; mismatch by tier; N (code 4) vs ACGT = AMBIGUOUS -1 but
N vs N = FULLMATCH (pairdistance permute_cases includes N==N); code 5
= past-chromosome '*' scores 0 against everything (pairdistance is
CALLOC'd and '*' is never permuted); gap = open + extend * length;
ties broken by jump_late_p exactly as the reference's sequential
compares (src/dynprog.c:1520-1557).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

NEG_INF = -1000000  # dynprog.c NEG_INFINITY

# scoring constants (dynprog.c:141-248)
FULLMATCH = 3
MISMATCH_HIGHQ, MISMATCH_MEDQ, MISMATCH_LOWQ, MISMATCH_ENDQ = -3, -2, -1, -5
SINGLE_OPEN, SINGLE_EXTEND = -10, -3
PAIRED_OPEN, PAIRED_EXTEND = -18, -3
END_OPEN, END_EXTEND = -12, -1
CDNA_OPEN, CDNA_EXTEND = -10, -7
CANONICAL_INTRON_HIGHQ = 10
FINAL_CANONICAL_INTRON_HIGHQ = 30
GCAG_INTRON, FINAL_GCAG_INTRON = 15, 20
ATAC_INTRON, FINAL_ATAC_INTRON = 12, 12
KNOWN_SPLICESITE_REWARD = 20
MICROINTRON_LENGTH = 9

# intron dinucleotide bit codes (src/intron.h:10-28)
LEFT_GT, LEFT_GC, LEFT_AT, LEFT_CT = 0x21, 0x10, 0x08, 0x06
RIGHT_AG, RIGHT_AC, RIGHT_GC, RIGHT_AT = 0x30, 0x0C, 0x02, 0x01
GTAG_FWD, GCAG_FWD, ATAC_FWD = 0x20, 0x10, 0x08
GTAG_REV, GCAG_REV, ATAC_REV = 0x04, 0x02, 0x01
NONINTRON = 0x00

# Endalign modes (dynprog.h:8)
QUERYEND_GAP, QUERYEND_INDELS, QUERYEND_NOGAPS, BEST_LOCAL = 0, 1, 2, 3

# traceback op kinds
OP_NONE, OP_DIAG, OP_HORIZ, OP_VERT = 0, 1, 2, 3

# sequence codes: 0..3 = ACGT, 4 = N, 5 = '*' past-chromosome padding
NCODES = 6


def pair_matrix(mismatch: int, cmet: bool = False) -> np.ndarray:
    """pairdistance_array semantics for coded sequences
    (dynprog.c:1127-1240 pairdistance_init).  Row = query code, col =
    genome code (the oneway cmet permutes are query-side only)."""
    p = np.full((NCODES, NCODES), mismatch, np.int32)
    for i in range(4):
        p[i, i] = FULLMATCH
    p[4, :5] = -1  # N vs ACGT: AMBIGUOUS
    p[:5, 4] = -1
    p[4, 4] = FULLMATCH  # permute_cases(c,c) includes N==N
    p[5, :] = 0  # '*' never entered pairdistance_array (CALLOC zeros)
    p[:, 5] = 0
    if cmet:
        p[3, 1] = FULLMATCH  # query T matches genome C (oneway)
        p[0, 2] = FULLMATCH  # query A matches genome G
    return p


def compute_bands(len1, len2, extraband: int, widebandp: bool = True):
    """Band widths per problem (compute_scores_lookup_fwd:1442-1454)."""
    len1 = np.asarray(len1, np.int32)
    len2 = np.asarray(len2, np.int32)
    if not widebandp:
        lband = np.full_like(len1, extraband)
        rband = np.full_like(len1, extraband)
    else:
        rband = np.where(len2 >= len1, len2 - len1 + extraband, extraband)
        lband = np.where(len2 >= len1, extraband, len1 - len2 + extraband)
    return lband.astype(np.int32), rband.astype(np.int32)


@functools.partial(jax.jit, static_argnames=("M", "W", "open_", "extend"))
def banded_matrices(q, g, len1, len2, lband, rband, pairmat, jump_late,
                    M: int, W: int, open_: int, extend: int):
    """The banded 3-state Gotoh sweep (compute_scores_lookup_fwd
    semantics, src/dynprog.c:1424-1570).

    q: int32[B, M] query codes (rows); g: int32[B, N] genome codes
    (cols); len1/len2/lband/rband: int32[B]; pairmat: int32[6, 6];
    jump_late: bool[B].

    Returns (nogap, gap1, gap2) int32[B, M+1, W] band-packed with
    k = c - r + lband, and ndiag bool[B, M+1, W]: nogap direction is
    HORIZ or VERT (used by bridge_intron_gap's gap-avoidance -1).
    Cells outside the band / sequence are NEG_INF.
    """
    B = q.shape[0]
    N = g.shape[1]
    kk = jnp.arange(W, dtype=jnp.int32)[None, :]  # [1, W]
    bandw = lband + rband  # inclusive max k

    # row 0: c = k - lband
    c0 = kk - lband[:, None]
    nogap0 = jnp.where(c0 == 0, 0, NEG_INF)
    in0 = (c0 >= 1) & (c0 <= jnp.minimum(rband, len2)[:, None])
    gap10 = jnp.where(in0, open_ + extend * c0, NEG_INF)
    gap20 = jnp.full((B, W), NEG_INF, jnp.int32)

    ext_k = extend * kk  # [1, W]
    neg = jnp.full((B, W), NEG_INF, jnp.int32)
    late = jump_late[:, None]

    def row_step(carry, r):
        nogap_p, gap1_p, gap2_p = carry
        c = r + kk - lband[:, None]  # [B, W]
        valid = (c >= 1) & (c <= len2[:, None]) & (kk <= bandw[:, None])

        # vertical state: (r-1, c) lives at band k+1 of the previous row
        nogap_up = jnp.concatenate([nogap_p[:, 1:], neg[:, :1]], axis=1)
        gap2_up = jnp.concatenate([gap2_p[:, 1:], neg[:, :1]], axis=1)
        gap2 = jnp.maximum(nogap_up + open_, gap2_up) + extend
        # column-0 init (only in band when r <= lband)
        gap2 = jnp.where(c == 0, open_ + extend * r, gap2)
        gap2 = jnp.where(valid | (c == 0), gap2, NEG_INF)

        # diagonal: (r-1, c-1) is band k of the previous row
        best12 = jnp.maximum(gap1_p, gap2_p)
        diag = jnp.maximum(nogap_p, best12)
        ndiag = jnp.where(late, best12 >= nogap_p, best12 > nogap_p)
        gc = jnp.take_along_axis(
            g, jnp.clip(c - 1, 0, N - 1), axis=1)  # genome code at col c-1
        gc = jnp.where((c >= 1) & (c <= len2[:, None]), gc, 5)
        qc = q[:, r - 1][:, None]  # [B, 1]
        pscore = pairmat[qc, gc]
        nogap = jnp.where(valid, diag + pscore, NEG_INF)

        # horizontal state: within-row exclusive running max.
        # gap1[c] = max(nogap[c-1]+open, gap1[c-1]) + extend unrolls to
        # gap1[k] = extend*k + max_{j<k}(nogap[j] + open - extend*j);
        # the band edge (k=0, no left neighbor) is NEG_INF
        t = nogap + open_ - ext_k
        run = jax.lax.associative_scan(jnp.maximum, t, axis=1)
        run_excl = jnp.concatenate([neg[:, :1], run[:, :-1]], axis=1)
        gap1 = run_excl + ext_k
        gap1 = jnp.where(valid, gap1, NEG_INF)

        out = (nogap, gap1, gap2, ndiag & valid)
        return (nogap, gap1, gap2), out

    (_, _, _), ys = jax.lax.scan(
        row_step, (nogap0, gap10, gap20), jnp.arange(1, M + 1))
    nogap = jnp.concatenate([nogap0[:, None], ys[0].transpose(1, 0, 2)], 1)
    gap1 = jnp.concatenate([gap10[:, None], ys[1].transpose(1, 0, 2)], 1)
    gap2 = jnp.concatenate([gap20[:, None], ys[2].transpose(1, 0, 2)], 1)
    ndiag = jnp.concatenate(
        [jnp.zeros((B, 1, W), bool), ys[3].transpose(1, 0, 2)], 1)
    return nogap, gap1, gap2, ndiag


def _cell(arr, r, k, W: int):
    """arr[b, r, k] with out-of-band k -> NEG_INF.  r is assumed valid."""
    B, M1, _ = arr.shape
    flat = arr.reshape(B, M1 * W)
    idx = jnp.clip(r, 0, M1 - 1) * W + jnp.clip(k, 0, W - 1)
    v = jnp.take_along_axis(flat, idx[:, None], axis=1)[:, 0]
    return jnp.where((k >= 0) & (k < W) & (r >= 0) & (r < M1), v, NEG_INF)


@functools.partial(jax.jit, static_argnames=("T", "W", "open_", "extend"))
def traceback(nogap, gap1, gap2, r0, c0, lband, jump_late,
              T: int, W: int, open_: int, extend: int):
    """Batched traceback state machine (src/dynprog.c:2612-2715).

    Starts at (r0, c0) in state nogap; emits up to T ops in reverse
    (end -> start) order.  Returns ops int8[B, T] (OP_*), opr/opc
    int32[B, T]: for OP_DIAG the (query row-1, genome col-1) pair, for
    OP_HORIZ the skipped genome col-1, for OP_VERT the skipped query
    row-1.  Direction decisions are recomputed from the matrices with
    the reference's sequential tie rules, so stored directions are
    unnecessary.
    """
    late = jump_late
    S_NOGAP, S_GAP1, S_GAP2, S_DONE = 0, 1, 2, 3

    def step(carry, _):
        r, c, state = carry
        k = c - r + lband

        at_origin = (r <= 0) & (c <= 0)
        done = (state == S_DONE) | ((state == S_NOGAP) & ((r <= 0) | (c <= 0)))

        # --- state NOGAP at (r, c): emit the diagonal pair, then the
        # direction comes from the three states at (r-1, c-1) (band k).
        ng = _cell(nogap, r - 1, k, W)
        g1 = _cell(gap1, r - 1, k, W)
        g2 = _cell(gap2, r - 1, k, W)
        best12 = jnp.maximum(g1, g2)
        takeh = jnp.where(late, g1 >= ng, g1 > ng)
        takev = jnp.where(late, g2 >= jnp.maximum(ng, g1),
                          g2 > jnp.maximum(ng, g1))
        ng_next = jnp.where(takev, S_GAP2, jnp.where(takeh, S_GAP1, S_NOGAP))

        # --- state GAP1 at (r, c): emit genome-skip of col c-1; dir
        # from nogap[r][c-1] + open vs gap1[r][c-1] (band k-1, same row)
        h_ng = _cell(nogap, r, k - 1, W) + open_
        h_g1 = _cell(gap1, r, k - 1, W)
        h_horiz = jnp.where(late, h_g1 >= h_ng, h_g1 > h_ng)
        h_horiz = h_horiz & (r > 0) & (c > 1)  # row-0: STOP at c==1
        h_horiz = jnp.where((r == 0), c > 1, h_horiz)
        g1_next = jnp.where(h_horiz, S_GAP1, S_NOGAP)

        # --- state GAP2 at (r, c): emit query-skip of row r-1; dir
        # from nogap[r-1][c] + open vs gap2[r-1][c] (band k+1, prev row)
        v_ng = _cell(nogap, r - 1, k + 1, W) + open_
        v_g2 = _cell(gap2, r - 1, k + 1, W)
        v_vert = jnp.where(late, v_g2 >= v_ng, v_g2 > v_ng)
        v_vert = v_vert & (c > 0) & (r > 1)  # col-0: STOP at r==1
        v_vert = jnp.where((c == 0), r > 1, v_vert)
        g2_next = jnp.where(v_vert, S_GAP2, S_NOGAP)

        op = jnp.where(
            done, OP_NONE,
            jnp.where(state == S_NOGAP, OP_DIAG,
                      jnp.where(state == S_GAP1, OP_HORIZ, OP_VERT)))
        opr = jnp.where(state == S_GAP1, r, r - 1)
        opc = jnp.where(state == S_GAP2, c, c - 1)

        nr = jnp.where(done, r,
                       jnp.where(state == S_GAP1, r, r - 1))
        nc = jnp.where(done, c,
                       jnp.where(state == S_GAP2, c, c - 1))
        nstate = jnp.where(
            done | at_origin, S_DONE,
            jnp.where(state == S_NOGAP, ng_next,
                      jnp.where(state == S_GAP1, g1_next, g2_next)))
        return (nr, nc, nstate), (op.astype(jnp.int8), opr, opc)

    state0 = jnp.zeros_like(r0)
    (_, _, _), (ops, opr, opc) = jax.lax.scan(
        step, (r0, c0, state0), None, length=T)
    return ops.T, opr.T, opc.T  # [B, T]


# ------------------------------------------------------------------ drivers

def dinucl_codes_left(gseq, N: int):
    """leftdi per column cL (0-based genome index): dinucleotide at
    (cL, cL+1) -> LEFT_* bitmask (bridge_intron_gap:3330-3350).
    gseq int32[B, N] -> int32[B, N+1] indexed by cL in 0..N."""
    a = gseq
    b = jnp.concatenate([gseq[:, 1:], jnp.full_like(gseq[:, :1], 5)], axis=1)
    code = jnp.zeros_like(a)
    code = jnp.where((a == 2) & (b == 3), LEFT_GT, code)   # GT
    code = jnp.where((a == 2) & (b == 1), LEFT_GC, code)   # GC
    code = jnp.where((a == 0) & (b == 3), LEFT_AT, code)   # AT
    code = jnp.where((a == 1) & (b == 3), LEFT_CT, code)   # CT
    return jnp.concatenate([code, jnp.zeros_like(code[:, :1])], axis=1)


def dinucl_codes_right(grev, N: int):
    """rightdi per column cR of the REVERSED right genome region:
    right2 = g[revoffset - cR - 1], right1 = g[revoffset - cR], i.e.
    in the reversed array: right1 = grev[cR], right2 = grev[cR + 1]."""
    r1 = grev
    r2 = jnp.concatenate([grev[:, 1:], jnp.full_like(grev[:, :1], 5)], axis=1)
    code = jnp.zeros_like(r1)
    code = jnp.where((r2 == 0) & (r1 == 2), RIGHT_AG, code)  # AG
    code = jnp.where((r2 == 0) & (r1 == 1), RIGHT_AC, code)  # AC
    code = jnp.where((r2 == 2) & (r1 == 1), RIGHT_GC, code)  # GC
    code = jnp.where((r2 == 0) & (r1 == 3), RIGHT_AT, code)  # AT
    return jnp.concatenate([code, jnp.zeros_like(code[:, :1])], axis=1)


def intron_score_table(cdna_direction, canonical_reward, finalp,
                       nosplicing: bool = False):
    """(scores int32[64], types int32[64]) tables: introntype bitmask
    -> score and normalized introntype (dynprog.c:3152-3210
    intron_score; types outside the direction's table collapse to
    NONINTRON).  nosplicing (gmap --nosplicing) zeroes every reward."""
    t = np.zeros(64, np.int32)
    ty = np.zeros(64, np.int32)
    if nosplicing:
        return t, ty
    gcag = FINAL_GCAG_INTRON if finalp else GCAG_INTRON
    atac = FINAL_ATAC_INTRON if finalp else ATAC_INTRON
    fwd = {GTAG_FWD: canonical_reward, GCAG_FWD: gcag, ATAC_FWD: atac}
    rev = {GTAG_REV: canonical_reward, GCAG_REV: gcag, ATAC_REV: atac}
    if cdna_direction > 0:
        table = fwd
    elif cdna_direction < 0:
        table = rev
    else:
        table = {**fwd, **rev}
    for typ, sc in table.items():
        t[typ] = sc
        ty[typ] = typ
    return t, ty


@functools.partial(
    jax.jit,
    static_argnames=("M", "W", "open_", "extend", "canonical_reward",
                     "cdna_direction", "finalp", "halfp", "nosplicing"))
def bridge_intron(nogapL, ndiagL, nogapR, ndiagR, len1, len2L, len2R,
                  lbandL, lbandR, leftdi, rightdi, left_known, right_known,
                  leftoffset, rightoffset,
                  M: int, W: int, open_: int, extend: int,
                  canonical_reward: int, cdna_direction: int,
                  finalp: bool, halfp: bool, nosplicing: bool = False):
    """bridge_intron_gap, novel-splicing branch (dynprog.c:3701-3830).

    For each rL in 1..len1-1 (rR = len1-rL) score
      scoreL(rL,cL) + intron(leftdi[cL] & rightdi[cR]) + scoreR(rR,cR)
    over two candidate families — cL in band with cR = rR pinned, then
    cR in band with cL = rL pinned — and take the best with the
    reference's strict-'>' first-wins order.  left/right_known are
    KNOWN_SPLICESITE_REWARD vectors indexed by genome column.

    Returns (finalscore, bestrL, bestrR, bestcL, bestcR, introntype).
    """
    B = nogapL.shape[0]
    itab_np, ttab_np = intron_score_table(
        cdna_direction, canonical_reward, finalp, nosplicing)
    itab = jnp.asarray(itab_np)
    ttab = jnp.asarray(ttab_np)

    rr = jnp.arange(1, M + 1, dtype=jnp.int32)[None, :]       # rL [1, M]
    rL = jnp.broadcast_to(rr, (B, M))
    rR = len1[:, None] - rL
    rok = (rL >= 1) & (rL <= len1[:, None] - 1)

    kk = jnp.arange(W, dtype=jnp.int32)[None, None, :]        # [1, 1, W]

    def gather_rows(nogap, ndiag, r):
        # nogap[b, r[b,m], :] -> [B, M, W]
        M1 = nogap.shape[1]
        rc = jnp.clip(r, 0, M1 - 1)
        return (jnp.take_along_axis(nogap, rc[:, :, None], axis=1),
                jnp.take_along_axis(ndiag, rc[:, :, None], axis=1))

    ngL, ndL = gather_rows(nogapL, ndiagL, rL)                # [B, M, W]
    ngR, ndR = gather_rows(nogapR, ndiagR, rR)

    cL_band = rL[:, :, None] + kk - lbandL[:, None, None]     # [B, M, W]
    cR_band = rR[:, :, None] + kk - lbandR[:, None, None]
    okL = (cL_band >= 1) & (cL_band <= len2L[:, None, None] - 1)
    okR = (cR_band >= 1) & (cR_band <= len2R[:, None, None] - 1)

    def col_gather(tab, c):
        # tab [B, NC] indexed by genome column -> [B, M, W]
        return jnp.take_along_axis(
            tab[:, None, :].repeat(M, 1), jnp.clip(c, 0, tab.shape[1] - 1),
            axis=2)

    def col_gather1(tab, c):
        # tab [B, NC] indexed by [B, M] column -> [B, M]
        return jnp.take_along_axis(
            tab[:, None, :].repeat(M, 1),
            jnp.clip(c[:, :, None], 0, tab.shape[1] - 1), 2)[:, :, 0]

    # dinucleotides past len2-2 are zeroed (bridge_intron_gap:3352)
    ldi_band = jnp.where(cL_band <= len2L[:, None, None] - 2,
                         col_gather(leftdi, cL_band), 0)
    rdi_band = jnp.where(cR_band <= len2R[:, None, None] - 2,
                         col_gather(rightdi, cR_band), 0)
    lkn_band = col_gather(left_known, cL_band)
    rkn_band = col_gather(right_known, cR_band)

    def pin(ng, lb):
        kB = jnp.broadcast_to(lb[:, None], ng.shape[:2])
        return jnp.take_along_axis(ng, kB[:, :, None], axis=2)[:, :, 0]

    # family A: cL varies ("indel on left"), cR pinned at rR.  The -1
    # gap-avoidance applies to the varying side only (dynprog.c:3727)
    ngR_pin = pin(ngR, lbandR)
    rkn_pin = col_gather1(right_known, rR)
    rdi_pin = jnp.where(rR <= len2R[:, None] - 2,
                        col_gather1(rightdi, rR), 0)
    scR_pin = ngR_pin + rkn_pin
    okR_pin = (rR >= 1) & (rR <= len2R[:, None] - 1)

    sep = rightoffset[:, None, None] - leftoffset[:, None, None]
    okA = (okL & okR_pin[:, :, None] & rok[:, :, None]
           & (rR[:, :, None] < sep - cL_band))
    itypA = ldi_band & rdi_pin[:, :, None]
    scoreA = (ngL + lkn_band - ndL.astype(jnp.int32)
              + itab[itypA] + scR_pin[:, :, None])
    scoreA = jnp.where(okA, scoreA, NEG_INF)

    # family B: cR varies ("indel on right"), cL pinned at rL
    ngL_pin = pin(ngL, lbandL)
    lkn_pin = col_gather1(left_known, rL)
    ldi_pin = jnp.where(rL <= len2L[:, None] - 2,
                        col_gather1(leftdi, rL), 0)
    scL_pin = ngL_pin + lkn_pin
    okL_pin = (rL >= 1) & (rL <= len2L[:, None] - 1)

    okB = (okR & okL_pin[:, :, None] & rok[:, :, None]
           & (rL[:, :, None] < sep - cR_band))
    itypB = ldi_pin[:, :, None] & rdi_band
    scoreB = (scL_pin[:, :, None] + itab[itypB]
              + ngR + rkn_band - ndR.astype(jnp.int32))
    scoreB = jnp.where(okB, scoreB, NEG_INF)

    # linear order per rL: family A block then family B block ->
    # first-max argmax replicates the reference's strict '>' updates
    cand = jnp.concatenate([scoreA, scoreB], axis=2)          # [B, M, 2W]
    ityp = jnp.concatenate([itypA, itypB], axis=2)
    candf = cand.reshape(B, -1)
    best = jnp.argmax(candf, axis=1)
    bestscore = jnp.take_along_axis(candf, best[:, None], 1)[:, 0]
    brow = best // (2 * W)
    bcol = best % (2 * W)
    in_b = bcol >= W
    bk = jnp.where(in_b, bcol - W, bcol)
    bestrL = brow + 1
    bestrR = len1 - bestrL
    bestcL = jnp.where(in_b, bestrL, bestrL + bk - lbandL)
    bestcR = jnp.where(in_b, bestrR + bk - lbandR, bestrR)
    ityp_best = jnp.take_along_axis(
        ityp.reshape(B, -1), best[:, None], 1)[:, 0]
    besti = itab[ityp_best]
    ityp_best = ttab[ityp_best]  # normalize to NONINTRON outside table
    finalscore = jnp.where(halfp, bestscore - besti // 2, bestscore)
    return finalscore, bestrL, bestrR, bestcL, bestcR, ityp_best


@functools.partial(jax.jit, static_argnames=("W", "extraband"))
def best_endpoint(nogap, len1, len2, lband, extraband: int,
                  jump_late, W: int):
    """find_best_endpoint (dynprog.c:2236): best nogap cell within
    +-extraband of the MAIN diagonal, bestscore starting at 0.
    jump_late picks the last tie, else the first.  Returns
    (score, bestr, bestc)."""
    B, M1, _ = nogap.shape
    r = jnp.arange(M1, dtype=jnp.int32)[None, :, None]
    k = jnp.arange(W, dtype=jnp.int32)[None, None, :]
    c = r + k - lband[:, None, None]
    eb = extraband
    ok = ((r >= 1) & (r <= len1[:, None, None])
          & (c >= jnp.maximum(1, r - eb))
          & (c <= jnp.minimum(len2[:, None, None], r + eb)))
    sc = jnp.where(ok, nogap, NEG_INF)
    flat = sc.reshape(B, -1)
    # scan order is r-major then c: argmax = first max = jump_late False;
    # for jump_late True take the LAST max
    first = jnp.argmax(flat, axis=1)
    last = (flat.shape[1] - 1) - jnp.argmax(flat[:, ::-1], axis=1)
    best = jnp.where(jump_late, last, first)
    score = jnp.take_along_axis(flat, best[:, None], 1)[:, 0]
    bestr = best // W
    bestc = bestr + (best % W) - lband
    # bestscore starts at 0: late ('>=') accepts a 0-score cell,
    # early ('>') keeps (0, 0)
    none = jnp.where(jump_late, score < 0, score <= 0)
    score = jnp.maximum(score, 0)
    bestr = jnp.where(none, 0, bestr)
    bestc = jnp.where(none, 0, bestc)
    return score, bestr, bestc


@functools.partial(jax.jit, static_argnames=("W",))
def best_endpoint_queryend(nogap, len1, len2, lband, rband, jump_late,
                           W: int):
    """find_best_endpoint_to_queryend_indels (dynprog.c:2294): best
    nogap cell in the LAST row (r = len1)."""
    B, M1, _ = nogap.shape
    k = jnp.arange(W, dtype=jnp.int32)[None, :]
    r = len1[:, None]
    c = r + k - lband[:, None]
    ok = (c >= jnp.maximum(1, r - lband[:, None])) & (c <= len2[:, None])
    row = jnp.take_along_axis(
        nogap, jnp.clip(r, 0, M1 - 1)[:, :, None].repeat(W, 2), axis=1
    )[:, 0, :]
    sc = jnp.where(ok, row, NEG_INF)
    first = jnp.argmax(sc, axis=1)
    last = (W - 1) - jnp.argmax(sc[:, ::-1], axis=1)
    best = jnp.where(jump_late, last, first)
    score = jnp.take_along_axis(sc, best[:, None], 1)[:, 0]
    bestr = len1
    bestc = len1 + best - lband
    return score, bestr, bestc
