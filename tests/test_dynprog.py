"""Device dynprog kernels vs the dense NumPy oracle (reference
recurrences from src/dynprog.c) on randomized gap problems."""

import numpy as np
import pytest

import dynprog_oracle as oracle
from gmap_gsnap.ops import dynprog as dp


def _rand_problem(rng, M_max=24, N_max=32, related=True):
    M = int(rng.integers(1, M_max))
    N = int(rng.integers(1, N_max))
    g = rng.integers(0, 4, N).astype(np.int32)
    if related and M <= N:
        q = g[:M].copy()
        for _ in range(int(rng.integers(0, 3))):
            q[rng.integers(0, M)] = rng.integers(0, 4)
    else:
        q = rng.integers(0, 4, M).astype(np.int32)
    if rng.random() < 0.2 and M > 1:
        q[rng.integers(0, M)] = 4  # an N
    return q.astype(np.int32), g


def _pack(problems, M, N):
    B = len(problems)
    q = np.full((B, M), 5, np.int32)
    g = np.full((B, N), 5, np.int32)
    len1 = np.zeros(B, np.int32)
    len2 = np.zeros(B, np.int32)
    for i, (qi, gi) in enumerate(problems):
        q[i, : len(qi)] = qi
        g[i, : len(gi)] = gi
        len1[i] = len(qi)
        len2[i] = len(gi)
    return q, g, len1, len2


def _band_cells(len1, len2, lband, rband):
    for r in range(0, len1 + 1):
        for c in range(0, len2 + 1):
            if -lband <= c - r <= rband:
                yield r, c


@pytest.mark.parametrize("jump_late", [False, True])
def test_banded_matrices_vs_oracle(jump_late):
    rng = np.random.default_rng(7)
    extraband = 3
    problems = [_rand_problem(rng) for _ in range(40)]
    M = max(len(p[0]) for p in problems)
    N = max(len(p[1]) for p in problems)
    q, g, len1, len2 = _pack(problems, M, N)
    lband, rband = dp.compute_bands(len1, len2, extraband)
    W = int((lband + rband).max()) + 1
    pairmat = dp.pair_matrix(dp.MISMATCH_HIGHQ)
    late = np.full(len(problems), jump_late)

    nogap, gap1, gap2, ndiag = (
        np.asarray(x) for x in dp.banded_matrices(
            q, g, len1, len2, lband, rband, pairmat, late,
            M=M, W=W, open_=dp.SINGLE_OPEN, extend=dp.SINGLE_EXTEND))

    for i, (qi, gi) in enumerate(problems):
        ng_o, g1_o, g2_o, dng, dg1, dg2 = oracle.compute_matrices(
            qi, gi, dp.SINGLE_OPEN, dp.SINGLE_EXTEND, pairmat, extraband,
            jump_late)
        for r, c in _band_cells(len1[i], len2[i], lband[i], rband[i]):
            k = c - r + lband[i]
            if not (0 <= k < W):
                continue
            for dev, ora, name in ((nogap, ng_o, "nogap"),
                                   (gap1, g1_o, "gap1"),
                                   (gap2, g2_o, "gap2")):
                d, o = int(dev[i, r, k]), int(ora[r][c])
                if o <= oracle.NEG_INF:
                    assert d <= oracle.NEG_INF + 100, (i, r, c, name, d, o)
                else:
                    assert d == o, (i, r, c, name, d, o)
            if r >= 1 and c >= 1 and int(ng_o[r][c]) > oracle.NEG_INF // 2:
                nd_o = dng[r][c] != oracle.DIAG
                assert bool(ndiag[i, r, k]) == nd_o, (i, r, c)


@pytest.mark.parametrize("jump_late", [False, True])
def test_traceback_single_gap(jump_late):
    """Global corner-to-corner traceback (Dynprog_single_gap)."""
    rng = np.random.default_rng(11)
    extraband = 3
    problems = []
    while len(problems) < 40:
        q, g = _rand_problem(rng, related=True)
        problems.append((q, g))
    M = max(len(p[0]) for p in problems)
    N = max(len(p[1]) for p in problems)
    q, g, len1, len2 = _pack(problems, M, N)
    lband, rband = dp.compute_bands(len1, len2, extraband)
    W = int((lband + rband).max()) + 1
    pairmat = dp.pair_matrix(dp.MISMATCH_HIGHQ)
    late = np.full(len(problems), jump_late)

    mats = dp.banded_matrices(q, g, len1, len2, lband, rband, pairmat, late,
                              M=M, W=W, open_=dp.SINGLE_OPEN,
                              extend=dp.SINGLE_EXTEND)
    T = M + N + 2
    ops, opr, opc = (np.asarray(x) for x in dp.traceback(
        mats[0], mats[1], mats[2], len1, len2, lband, late,
        T=T, W=W, open_=dp.SINGLE_OPEN, extend=dp.SINGLE_EXTEND))

    for i, (qi, gi) in enumerate(problems):
        ng_o, g1_o, g2_o, dng, dg1, dg2 = oracle.compute_matrices(
            qi, gi, dp.SINGLE_OPEN, dp.SINGLE_EXTEND, pairmat, extraband,
            jump_late)
        want = oracle.traceback(dng, dg1, dg2, len1[i], len2[i])
        got = []
        for t in range(T):
            k = int(ops[i, t])
            if k == dp.OP_NONE:
                continue
            if k == dp.OP_DIAG:
                got.append(("diag", int(opr[i, t]), int(opc[i, t])))
            elif k == dp.OP_HORIZ:
                got.append(("horiz", int(opc[i, t])))
            else:
                got.append(("vert", int(opr[i, t])))
        assert got == want, (i, got, want)


@pytest.mark.parametrize("jump_late", [False, True])
def test_best_endpoints(jump_late):
    rng = np.random.default_rng(13)
    extraband = 3
    problems = [_rand_problem(rng) for _ in range(40)]
    M = max(len(p[0]) for p in problems)
    N = max(len(p[1]) for p in problems)
    q, g, len1, len2 = _pack(problems, M, N)
    lband, rband = dp.compute_bands(len1, len2, extraband)
    W = int((lband + rband).max()) + 1
    pairmat = dp.pair_matrix(dp.MISMATCH_ENDQ)
    late = np.full(len(problems), jump_late)

    mats = dp.banded_matrices(q, g, len1, len2, lband, rband, pairmat, late,
                              M=M, W=W, open_=dp.END_OPEN,
                              extend=dp.END_EXTEND)
    sc, br, bc = (np.asarray(x) for x in dp.best_endpoint(
        mats[0], len1, len2, lband, extraband, late, W=W))
    scq, brq, bcq = (np.asarray(x) for x in dp.best_endpoint_queryend(
        mats[0], len1, len2, lband, rband, late, W=W))

    for i, (qi, gi) in enumerate(problems):
        ng_o, *_ = oracle.compute_matrices(
            qi, gi, dp.END_OPEN, dp.END_EXTEND, pairmat, extraband,
            jump_late)
        s_o, r_o, c_o = oracle.find_best_endpoint(
            ng_o, len1[i], len2[i], extraband, jump_late)
        assert (sc[i], br[i], bc[i]) == (s_o, r_o, c_o), (
            i, (sc[i], br[i], bc[i]), (s_o, r_o, c_o))
        s_o, r_o, c_o = oracle.find_best_endpoint_queryend(
            ng_o, len1[i], len2[i], extraband, jump_late)
        assert (scq[i], brq[i], bcq[i]) == (s_o, r_o, c_o), (
            i, (scq[i], brq[i], bcq[i]), (s_o, r_o, c_o))


@pytest.mark.parametrize("cdna_direction", [+1, -1])
def test_bridge_intron(cdna_direction):
    """Intron bridging: random gap problems built from a genomic span
    with a (sometimes canonical) intron."""
    rng = np.random.default_rng(17)
    extraband = 7  # extraband_paired
    B = 30
    problems = []
    for _ in range(B):
        M = int(rng.integers(4, 16))
        NL = M + 8
        NR = M + 8
        gL = rng.integers(0, 4, NL).astype(np.int32)
        gR = rng.integers(0, 4, NR).astype(np.int32)
        split = int(rng.integers(1, M))
        q = np.concatenate([gL[:split], gR[NR - (M - split):]]).astype(np.int32)
        if rng.random() < 0.6:  # plant canonical GT..AG at the split
            if split + 1 < NL:
                gL[split], gL[split + 1] = 2, 3
            gR[NR - (M - split) - 2], gR[NR - (M - split) - 1] = 0, 2
        problems.append((q, gL, gR))

    M = max(len(p[0]) for p in problems)
    NL = max(len(p[1]) for p in problems)
    NR = max(len(p[2]) for p in problems)
    B = len(problems)
    q = np.full((B, M), 5, np.int32)
    qr = np.full((B, M), 5, np.int32)
    gl = np.full((B, NL), 5, np.int32)
    grv = np.full((B, NR), 5, np.int32)
    len1 = np.zeros(B, np.int32)
    len2L = np.zeros(B, np.int32)
    len2R = np.zeros(B, np.int32)
    for i, (qi, gLi, gRi) in enumerate(problems):
        q[i, : len(qi)] = qi
        qr[i, : len(qi)] = qi[::-1]
        gl[i, : len(gLi)] = gLi
        grv[i, : len(gRi)] = gRi[::-1]
        len1[i], len2L[i], len2R[i] = len(qi), len(gLi), len(gRi)

    lbandL, rbandL = dp.compute_bands(len1, len2L, extraband)
    lbandR, rbandR = dp.compute_bands(len1, len2R, extraband)
    W = int(max((lbandL + rbandL).max(), (lbandR + rbandR).max())) + 1
    pairmat = dp.pair_matrix(dp.MISMATCH_HIGHQ)
    late = np.zeros(B, bool)       # jump_late_p for fwd
    later = np.ones(B, bool)       # !jump_late_p for rev

    matsL = dp.banded_matrices(q, gl, len1, len2L, lbandL, rbandL, pairmat,
                               late, M=M, W=W, open_=dp.PAIRED_OPEN,
                               extend=dp.PAIRED_EXTEND)
    matsR = dp.banded_matrices(qr, grv, len1, len2R, lbandR, rbandR, pairmat,
                               later, M=M, W=W, open_=dp.PAIRED_OPEN,
                               extend=dp.PAIRED_EXTEND)

    leftdi = np.asarray(dp.dinucl_codes_left(gl, NL))
    rightdi = np.asarray(dp.dinucl_codes_right(grv, NR))
    zerosL = np.zeros((B, NL + 1), np.int32)
    zerosR = np.zeros((B, NR + 1), np.int32)
    leftoffset = np.zeros(B, np.int32)
    rightoffset = np.full(B, 10**6, np.int32)  # genomically far apart

    fs, brL, brR, bcL, bcR, ityp = (np.asarray(x) for x in dp.bridge_intron(
        matsL[0], matsL[3], matsR[0], matsR[3], len1, len2L, len2R,
        lbandL, lbandR, leftdi, rightdi, zerosL, zerosR,
        leftoffset, rightoffset,
        M=M, W=W, open_=dp.PAIRED_OPEN, extend=dp.PAIRED_EXTEND,
        canonical_reward=dp.FINAL_CANONICAL_INTRON_HIGHQ,
        cdna_direction=cdna_direction, finalp=True, halfp=False))

    for i, (qi, gLi, gRi) in enumerate(problems):
        ngL, _, _, dngL, _, _ = oracle.compute_matrices(
            qi, gLi, dp.PAIRED_OPEN, dp.PAIRED_EXTEND, pairmat, extraband,
            False)
        ngR, _, _, dngR, _, _ = oracle.compute_matrices(
            qi[::-1], gRi[::-1], dp.PAIRED_OPEN, dp.PAIRED_EXTEND, pairmat,
            extraband, True)
        f_o, best_o = oracle.bridge_intron_gap(
            ngL, dngL, ngR, dngR, gLi, gRi[::-1],
            len(qi), len(gLi), len(gRi), extraband,
            dp.FINAL_CANONICAL_INTRON_HIGHQ, cdna_direction, True,
            0, 10**6)
        assert fs[i] == f_o, (i, fs[i], f_o)
        assert best_o is not None
        assert (brL[i], brR[i], bcL[i], bcR[i]) == best_o[:4], (
            i, (brL[i], brR[i], bcL[i], bcR[i]), best_o)
        assert ityp[i] == best_o[4] or f_o <= oracle.NEG_INF
