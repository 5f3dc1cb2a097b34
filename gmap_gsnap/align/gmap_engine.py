"""Batched device GMAP stages: seeding, segment extraction, chaining,
and junction solving.

Batched re-design of the reference GMAP stack's compute path:

  * stage1/stage2 seeding (stage1.c:3448 Stage1_compute,
    oligoindex_hr.c:12358 Oligoindex_hr_tally + stage2.c:2921
    align_compute_scores): instead of per-region 8-mer tallies and
    per-querypos sparse DP, every query k-mer of a BATCH of queries is
    looked up in the global positional index with two device gathers,
    hits are sorted into diagonal segments with one device sort (the
    heap-merge equivalent), and segments are chained with an
    intron-aware sparse DP swept by one lax.scan — O(S^2) vector work
    per query instead of Python loops;
  * stage3 junction refinement (stage3.c:5633 traverse_genome_gap,
    :5381 traverse_single_gap): ALL junctions of all chained paths are
    solved in ONE batched call to the banded affine DP kernels
    (ops/dynprog.py), replacing the reference's per-junction
    Dynprog_genome_gap/Dynprog_single_gap calls.

The host keeps only O(S) assembly work per query (chain backtracking,
Path construction).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import dynprog as dp

MIN_SEGLEN = 15
MIN_CHAIN_SCORE = 20  # MIN_MATCHES path floor (gmap.c:82)
MAX_INSERTLEN = 30
MIN_INTRONLENGTH = 9
PEEL = 11                  # maxpeelback (gsnap.c:96)
EXTRAMATERIAL_PAIRED = 8   # gsnap.c:99
EXTRABAND_PAIRED = 7       # gsnap.c:106
EXTRABAND_SINGLE = 3       # gsnap.c:104


# ------------------------------------------------------------- seed + segment

@functools.partial(jax.jit, static_argnames=("k", "H", "S", "threshold"))
def seed_segments_device(offsets, positions, oligos, valid,
                         k: int, H: int, S: int, threshold: int):
    """Device seeding + diagonal segment extraction.

    oligos int32[B, Q]: packed k-mers per query position; valid bool.
    The hit set (union of the index position runs of all kept oligos)
    is enumerated COMPACTLY into H slots via an exclusive prefix sum
    over per-oligo counts + one searchsorted (no [Q, cap] expansion):
    slot t belongs to query position qidx = searchsorted(cum, t) at
    run offset t - cumbase[qidx].  Hits emerge already qpos-ordered,
    so one stable sort by diagonal yields (diag, qpos) order.

    Returns per-row segment arrays [B, S] (qstart, qend, diag, valid)
    ordered by (qstart, diag), diag biased by +Q, plus nhits int32[B]
    (total hits; > H means slots overflowed and the caller should
    re-run at a larger H bucket — the overflow rescue lane).
    """
    B, Q = oligos.shape
    o = jnp.clip(oligos, 0, offsets.shape[0] - 2)
    s = offsets[o].astype(jnp.int32)
    e = offsets[o + 1].astype(jnp.int32)
    cnt = e - s
    keep = valid & (cnt > 0) & (cnt <= threshold)
    cnt = jnp.where(keep, cnt, 0)

    cum = jnp.cumsum(cnt, axis=1)                        # inclusive [B, Q]
    nhits = cum[:, -1]
    cumbase = cum - cnt                                  # exclusive
    t = jnp.arange(H, dtype=jnp.int32)

    # slot -> owning query position WITHOUT a binary search: runs are
    # contiguous, so scatter each kept oligo's (qpos, run base, run
    # start) at its first slot and carry them forward with cummax — a
    # searchsorted here is log2(Q) gather steps over [B, H], the
    # scatter is only [B, Q] and the scans are vector ops.
    bi = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32)[:, None],
                          cumbase.shape)
    # kept oligos have STRICTLY increasing cumbase (cnt > 0), so each
    # scatters to a distinct slot; non-kept and overflowing (>= H)
    # oligos index out of bounds and drop.
    sl = jnp.where(keep, cumbase, H)
    neg = jnp.int32(-1)
    qmark = jnp.full((B, H), neg).at[bi, sl].set(
        jnp.broadcast_to(jnp.arange(Q, dtype=jnp.int32)[None, :],
                         cumbase.shape), mode="drop")
    bmark = jnp.full((B, H), neg).at[bi, sl].set(cumbase, mode="drop")
    # q and cumbase are co-monotone among kept oligos so cummax carries
    # the owner forward; s is NOT monotone in q, so it comes from one
    # [B, H] gather through the carried qidx (still 13x fewer gathers
    # than the searchsorted it replaces)
    qidx = jnp.maximum(jax.lax.cummax(qmark, axis=1), 0)
    base_at = jax.lax.cummax(bmark, axis=1)
    s_at = jnp.take_along_axis(s, qidx, axis=1)
    ok = t[None, :] < jnp.minimum(nhits, H)[:, None]     # [B, H]
    pidx = s_at + (t[None, :] - base_at)
    pidx = jnp.clip(pidx, 0, positions.shape[0] - 1)
    pos = positions[pidx].astype(jnp.uint32)             # [B, H] gather

    qq0 = qidx.astype(jnp.uint32)
    diag_f = pos - qq0 + jnp.uint32(Q)                   # biased diagonal
    diag_f = jnp.where(ok, diag_f, jnp.uint32(0xFFFFFFFF))

    # hits are qpos-ascending by construction; one stable multi-operand
    # sort by diag gives (diag, qpos) order with invalid slots at the
    # end — lax.sort carries qq/ok along instead of three elementwise
    # take_along_axis gathers over [B, H]
    dg, qq, oks = jax.lax.sort(
        (diag_f, qq0.astype(jnp.int32), ok), dimension=1,
        is_stable=True, num_keys=1)

    prev_d = jnp.concatenate([dg[:, :1] ^ 1, dg[:, :-1]], axis=1)
    prev_q = jnp.concatenate([qq[:, :1], qq[:, :-1]], axis=1)
    newseg = oks & ((dg != prev_d) | (qq - prev_q > 2 * k))

    hidx = jnp.arange(H, dtype=jnp.int32)[None, :]
    # hits beyond the last ok hit are not ok; find per-row last ok index
    last_ok = jnp.sum(oks.astype(jnp.int32), axis=1) - 1
    # NOTE: invalid hits have diag 0xFFFFFFFF and sort to the END, so
    # ok hits occupy a prefix of the sorted order.

    # per-hit segment bounds: index of own segment's start (running max
    # of start positions) and of its end (next start - 1) — so segment
    # LENGTH is known per start BEFORE the S-truncation, and sub-
    # MIN_SEGLEN junk (repeat-seeded 1-2 hit runs dominate on Alu-dense
    # genomes) neither occupies S slots nor inflates nsegs into
    # spurious overflow retries (measured 3 seeding round trips per
    # batch at 4x the transfer each)
    startidx = jax.lax.cummax(jnp.where(newseg, hidx, -1), axis=1)
    nxt = jnp.concatenate(
        [jnp.where(newseg, hidx, H)[:, 1:],
         jnp.full((B, 1), H, jnp.int32)], axis=1)
    nextstart = jnp.flip(jax.lax.cummin(jnp.flip(nxt, 1), axis=1), 1)
    endidx = jnp.minimum(nextstart - 1, last_ok[:, None])
    q_at_start = jnp.take_along_axis(qq, jnp.clip(startidx, 0, H - 1), axis=1)
    q_at_end = jnp.take_along_axis(qq, jnp.clip(endidx, 0, H - 1), axis=1)
    longseg = (q_at_end + k - q_at_start) >= MIN_SEGLEN
    kept = newseg & longseg

    start_key = jnp.where(kept, hidx, H)
    # nsegs > S means the [:, :S] truncation below dropped segments
    # (they sort by diagonal, so HIGH-diagonal loci vanish silently);
    # the caller must re-run at a larger S bucket
    nsegs = jnp.sum(kept.astype(jnp.int32), axis=1)
    starts = jnp.sort(start_key, axis=1)[:, :S]          # [B, S] start idx
    seg_valid = starts < H
    sc = jnp.clip(starts, 0, H - 1)
    # segment end = next segment start (kept or not) - 1, via the
    # per-hit endidx (a dropped short segment still BOUNDS its
    # neighbors)
    ends = jnp.take_along_axis(endidx, sc, axis=1)
    ec = jnp.clip(ends, 0, H - 1)
    seg_qstart = jnp.take_along_axis(qq, sc, axis=1)
    seg_qend = jnp.take_along_axis(qq, ec, axis=1) + k
    seg_diag = jnp.take_along_axis(dg, sc, axis=1)
    seg_len = seg_qend - seg_qstart
    seg_valid = seg_valid & (seg_len >= MIN_SEGLEN)

    # order segments by (qstart, diag) for the chain DP
    qkey = jnp.where(seg_valid, seg_qstart, jnp.int32(2**30))
    o1 = jnp.argsort(seg_diag, axis=1, stable=True)
    q1 = jnp.take_along_axis(qkey, o1, axis=1)
    o2 = jnp.argsort(q1, axis=1, stable=True)
    so = jnp.take_along_axis(o1, o2, axis=1)
    seg_qstart = jnp.take_along_axis(seg_qstart, so, axis=1)
    seg_qend = jnp.take_along_axis(seg_qend, so, axis=1)
    seg_diag = jnp.take_along_axis(seg_diag, so, axis=1)
    seg_valid = jnp.take_along_axis(seg_valid, so, axis=1)
    seg_len = jnp.take_along_axis(seg_len, so, axis=1)

    return dict(qstart=seg_qstart, qend=seg_qend, diag=seg_diag,
                valid=seg_valid, nhits=nhits, nsegs=nsegs)


@functools.partial(jax.jit, static_argnames=("k",))
def chain_scores_device(qstart, qend, diag, valid, k: int,
                        max_intronlen):
    """Device sparse chain DP over diagonal segments (stage2.c:2921
    align_compute_scores re-designed): lax.scan over segment index i,
    each step a [B, S] vector recurrence — replaces the host numpy DP
    that measured ~1.5 s per 128-row batch.

    Semantics exactly match chains_from_device's host DP: gain =
    covered query length, intron/insertion transition penalties,
    strict-'>' first-wins ties (argmax picks the FIRST maximum).
    Returns (score, prev) int32[B, S]."""
    B, S = qstart.shape
    NEG = jnp.int32(-(2**28))
    qs = qstart.astype(jnp.int32)
    qe = qend.astype(jnp.int32)
    # biased uint32 diagonals: differences are exact in int32 for
    # within-chromosome transitions
    dg = diag
    seglen = qe - qs
    score0 = jnp.where(valid, seglen, NEG)
    prev0 = jnp.full((B, S), -1, jnp.int32)
    jidx = jnp.arange(S, dtype=jnp.int32)

    def step(carry, i):
        score, prev = carry
        qgap = qs[:, i][:, None] - qe                       # [B, S]
        gd = (dg[:, i][:, None] - dg).astype(jnp.int32)
        ok = (valid & (jidx[None, :] < i)
              & (gd <= jnp.int32(max_intronlen)) & (-gd <= MAX_INSERTLEN)
              & (qgap >= -k))
        gain = seglen[:, i][:, None] + jnp.minimum(qgap, 0)
        pen = jnp.maximum(qgap, 0) + jnp.where(
            gd > 0, jnp.where(gd >= MIN_INTRONLENGTH, 25, 12),
            jnp.where(gd < 0, 12, 0))
        cand = jnp.where(ok, score + gain - pen, NEG)
        j = jnp.argmax(cand, axis=1).astype(jnp.int32)
        cj = jnp.take_along_axis(cand, j[:, None], axis=1)[:, 0]
        upd = valid[:, i] & (cj > score[:, i])
        onehot = jidx[None, :] == i
        score = jnp.where(onehot & upd[:, None], cj[:, None], score)
        prev = jnp.where(onehot & upd[:, None], j[:, None], prev)
        return (score, prev), None

    (score, prev), _ = jax.lax.scan(
        step, (score0, prev0), jnp.arange(1, S, dtype=jnp.int32))
    return score, prev


@functools.partial(jax.jit, static_argnames=("C",))
def chain_backtrack_device(qstart, qend, diag, valid, score, prev,
                           C: int = 192):
    """Device backtrack of the best chain per row (npaths == 1 path).

    Follows prev pointers from the first score maximum (argmax = host
    argsort-stable first-max semantics) for up to C steps and gathers
    the member segments' (qstart, qend, diag) so the host never needs
    the full [B, S] segment + score arrays.  Members emerge END-first;
    the host reverses.  The transfer payload is TWO arrays: qspan
    int32[B, C] = (qstart << 16) | qend per member (-1 in empty slots
    — qstart/qend are query offsets < 2^15) and dg uint32[B, C]; plus
    ``deep`` bool[B], set when the chain walk used ALL C steps with a
    predecessor remaining (the caller must refetch the full arrays —
    the old fixed-C walk silently truncated such chains)."""
    B, S = score.shape
    NEG = jnp.int32(-(2**28))
    sc = jnp.where(valid, score, NEG)
    e = jnp.argmax(sc, axis=1).astype(jnp.int32)
    best = jnp.take_along_axis(sc, e[:, None], axis=1)[:, 0]
    rows = jnp.arange(B, dtype=jnp.int32)
    start = jnp.where(best > NEG // 2, e, -1)

    def step(cur, _):
        nxt = jnp.where(cur >= 0, prev[rows, jnp.clip(cur, 0, S - 1)], -1)
        return nxt.astype(jnp.int32), cur

    last, idxs = jax.lax.scan(step, start, None, length=C)  # [C, B]
    deep = last >= 0
    idxs = idxs.T                                          # [B, C] end-first
    mask = idxs >= 0
    ic = jnp.clip(idxs, 0, S - 1)
    qs = jnp.take_along_axis(qstart, ic, axis=1)
    qe = jnp.take_along_axis(qend, ic, axis=1)
    dg = jnp.take_along_axis(diag, ic, axis=1)
    qspan = jnp.where(mask, (qs << 16) | qe, -1)
    return qspan, dg, deep, best


def pack_dispatch(arrays):
    """Queue the device-side packing of a list of integer arrays into
    one buffer and start its async device->host copy.  Pair with
    pack_finish — splitting lets several packed results' device work
    and transfers overlap instead of serializing one blocking fetch
    per call site."""
    import jax

    flat, metas = [], []
    for a in arrays:
        u32 = a.dtype == jnp.uint32
        v = jax.lax.bitcast_convert_type(a, jnp.int32) if u32 else a
        if v.dtype == jnp.bool_:
            v = v.astype(jnp.int32)
        flat.append(jnp.ravel(v.astype(jnp.int32)))
        metas.append((a.shape, int(np.prod(a.shape, dtype=np.int64)),
                      u32, a.dtype == jnp.bool_))
    buf_d = jnp.concatenate(flat) if flat else None
    if buf_d is not None:
        try:
            buf_d.copy_to_host_async()
        except Exception:
            pass
    return buf_d, metas


def pack_finish(handle):
    """Host side of pack_dispatch: one blocking transfer + unpack."""
    buf_d, metas = handle
    buf = np.asarray(buf_d) if buf_d is not None else np.zeros(0, np.int32)
    out, off = [], 0
    for shape, sz, u32, boolean in metas:
        v = buf[off : off + sz].reshape(shape)
        if u32:
            v = v.view(np.uint32)
        elif boolean:
            v = v.astype(bool)
        out.append(v)
        off += sz
    return out


def fetch_packed(arrays):
    """ONE device->host transfer for a list of integer arrays (one round
    trip instead of one per array; the same trick as
    runner._pack_tree).  uint32 arrays ride as bitcast int32 and are
    viewed back on host."""
    return pack_finish(pack_dispatch(arrays))


def chains_from_device(segs, B: int, Q: int, k: int,
                       max_intronlen: int = 1_000_000, npaths: int = 1,
                       genome_range: "tuple | None" = None,
                       dp_scores: "tuple | None" = None):
    """Host chain DP + backtrack over the device-extracted segments.

    The DP is the stage2-style sparse chaining of gmap.py
    _chain_segments (gain = covered query length, intron-aware
    transition penalties, strict-'>' first-wins ties); with <= S=192
    segments per row it is vectorized-numpy work measured in
    microseconds, far below the device-roundtrip cost of a 192-step
    sequential scan.  Returns per-row lists of up to `npaths` chains
    [(qstart, qend, gstart, diag)] ordered by query position; extra
    chains (score order, segment-disjoint with earlier ones) model the
    reference's multiple gregions (stage1.c Gregion_filter_unique keeps
    the best non-overlapping candidate regions, each of which stage3
    turns into a path)."""
    qstart = np.asarray(segs["qstart"]).astype(np.int64)
    qend = np.asarray(segs["qend"]).astype(np.int64)
    diag = np.asarray(segs["diag"]).astype(np.int64) - Q  # unbias
    valid = np.asarray(segs["valid"])
    if genome_range is not None:
        # gmap -c/--chrsubset: restrict the SEARCH to a genomic window
        # (Chrsubset, stage1.c gregion bounds) — segments outside it
        # never seed chains, so subset-only suboptimal paths surface
        glo, ghi = genome_range
        gs = diag + qstart
        valid = valid & (gs >= glo) & (gs + (qend - qstart) <= ghi)
    S = qstart.shape[1]
    NEG = -(2**60)

    if dp_scores is not None and genome_range is None:
        # DP already ran on device (chain_scores_device) and rode the
        # same packed transfer as the segments
        score_a = np.asarray(dp_scores[0]).astype(np.int64)
        score_a = np.where(valid, score_a, NEG)
        prev_a = np.asarray(dp_scores[1]).astype(np.int64)
    else:
        # host chain DP fallback (genome_range restricts valid AFTER
        # the device arrays were built, so the device DP does not
        # apply).  Batched ACROSS rows: the i loop is inherently
        # sequential (score[i] reads score[:i]) but each step
        # vectorizes over [B, i].
        seglen_a = qend - qstart
        score_a = np.where(valid, seglen_a, NEG)
        prev_a = np.full((B, S), -1, np.int64)
        maxv = int(valid.sum(1).max()) if B else 0
        rows = np.arange(B)
        for i in range(1, maxv):
            act = valid[:, i]
            if not act.any():
                break
            qgap = qstart[:, i : i + 1] - qend[:, :i]
            gd = diag[:, i : i + 1] - diag[:, :i]
            ok = (valid[:, :i] & (gd <= max_intronlen)
                  & (-gd <= MAX_INSERTLEN) & (qgap >= -k))
            gain = seglen_a[:, i : i + 1] + np.minimum(qgap, 0)
            pen = np.maximum(qgap, 0) + np.where(
                gd > 0, np.where(gd >= MIN_INTRONLENGTH, 25, 12),
                np.where(gd < 0, 12, 0))
            cand = np.where(ok, score_a[:, :i] + gain - pen, NEG)
            j = cand.argmax(axis=1)
            cj = cand[rows, j]
            upd = act & (cj > score_a[:, i])
            score_a[:, i] = np.where(upd, cj, score_a[:, i])
            prev_a[:, i] = np.where(upd, j, -1)

    chains = []
    for b in range(B):
        nv = int(valid[b].sum())
        if nv == 0:
            chains.append([])
            continue
        qs, qe, d = qstart[b, :nv], qend[b, :nv], diag[b, :nv]
        score = score_a[b, :nv]
        prev = prev_a[b, :nv]
        row_chains = []
        used = np.zeros(nv, bool)
        best_score = int(score.max())
        for e in np.argsort(-score, kind="stable"):
            if len(row_chains) >= npaths:
                break
            if row_chains and score[int(e)] < MIN_CHAIN_SCORE:
                break    # below the MIN_MATCHES path floor (gmap.c:82)
            if used[int(e)]:
                continue
            idxs = []
            i = int(e)
            while i >= 0 and not used[i]:
                idxs.append(i)
                i = int(prev[i])
            if i >= 0:       # ran into a segment claimed by a better chain
                continue
            used[idxs] = True
            row_chains.append([
                (int(qs[i]), int(qe[i]), int(d[i] + qs[i]), int(d[i]))
                for i in reversed(idxs)])
        chains.append(row_chains)
    return chains


# ---------------------------------------------- dynprog junction rescue

def solve_junction_dynprog(gcodes, qcodes, lo, hi, diagL, diagR,
                           cdna_direction, finalp: bool = True):
    """Single-junction wrapper over solve_junctions_batch."""
    out = solve_junctions_batch(
        gcodes, [(qcodes, lo, hi, diagL, diagR)], cdna_direction, finalp)
    return out[0]


def solve_junctions_batch(gcodes, requests, cdna_direction,
                          finalp: bool = True):
    """Re-solve one messy intron junction with the banded affine DP
    kernels (traverse_genome_gap -> Dynprog_genome_gap semantics,
    stage3.c:5633): the window query [lo, hi) bridges from diagonal
    diagL to diagR allowing indels INSIDE the peeled window, which the
    exact split-point scan cannot represent.

    gcodes/qcodes: uint8 code arrays (genome / aligned query).
    Batched over many junctions at once (one device call set per
    bucket) — per-junction dispatches pay a full device round trip
    each.  requests: list of (qcodes, lo, hi, diagL, diagR).

    Returns a list aligned with requests: (finalscore, pieces,
    introntype) with pieces = diagonal runs covering [lo, hi) in
    aligned query coords, or None for failures.
    """
    return solve_junctions_finish(
        solve_junctions_dispatch(gcodes, requests, cdna_direction, finalp))


def solve_junctions_dispatch(gcodes, requests, cdna_direction,
                             finalp: bool = True):
    """Device half of solve_junctions_batch: queues the DP kernel set
    and the packed transfer, returns a handle for
    solve_junctions_finish.  Lets several direction buckets' device
    work overlap instead of one blocking round trip per bucket."""
    import jax.numpy as jnp

    B = len(requests)
    results = [None] * B
    Ms = [hi - lo for (_, lo, hi, _, _) in requests]
    # Mb is FIXED at 64 (the max window): per-bucket Mb values would
    # compile a fresh kernel set each, dwarfing the extra scan steps of
    # a one-size band sweep
    Mb = 64
    keep = [i for i in range(B) if 2 <= Ms[i] <= Mb]
    if not keep:
        return (None, results, None, None)
    nb = len(keep)
    # bucket the batch dim in x4 steps from 32 — same compile-count
    # rationale; padded rows replicate row 0 and their results are
    # never read (the result loop runs over `keep`)
    nb_real = nb
    b = 32
    while b < nb:
        b *= 4
    nb = b
    NL = Mb + EXTRAMATERIAL_PAIRED
    NR = Mb + EXTRAMATERIAL_PAIRED

    def codes_at(start, n):
        idx = np.arange(start, start + n)
        ok = (idx >= 0) & (idx < len(gcodes))
        out = np.where(ok, gcodes[np.clip(idx, 0, len(gcodes) - 1)], 5)
        return out.astype(np.int32)

    q = np.full((nb, Mb), 5, np.int32)
    qr = np.full((nb, Mb), 5, np.int32)
    gl = np.full((nb, NL), 5, np.int32)
    grv = np.full((nb, NR), 5, np.int32)
    len1 = np.zeros(nb, np.int32)
    len2L = np.zeros(nb, np.int32)
    len2R = np.zeros(nb, np.int32)
    loffs = np.zeros(nb, np.int32)
    roffs = np.zeros(nb, np.int32)
    for bi, i in enumerate(keep):
        qcodes, lo, hi, diagL, diagR = requests[i]
        M = hi - lo
        q[bi, :M] = qcodes[lo:hi].astype(np.int32)
        qr[bi, :M] = qcodes[lo:hi].astype(np.int32)[::-1]
        n_real = M + EXTRAMATERIAL_PAIRED
        gl[bi, :n_real] = codes_at(diagL + lo, n_real)
        grv[bi, :n_real] = codes_at(diagR + hi - n_real, n_real)[::-1]
        len1[bi] = M
        len2L[bi] = len2R[bi] = n_real
        loffs[bi] = diagL + lo
        roffs[bi] = diagR + hi - 1
    for arr in (q, qr, gl, grv, len1, len2L, len2R, loffs, roffs):
        arr[nb_real:] = arr[0]
    lbandL, rbandL = dp.compute_bands(len1, len2L, EXTRABAND_PAIRED)
    lbandR, rbandR = dp.compute_bands(len1, len2R, EXTRABAND_PAIRED)
    # static W for the bucket (max possible band width)
    W = EXTRAMATERIAL_PAIRED + 2 * EXTRABAND_PAIRED + 1
    pairmat = dp.pair_matrix(dp.MISMATCH_HIGHQ)
    late = np.zeros(nb, bool)
    later = np.ones(nb, bool)
    open_, extend = dp.PAIRED_OPEN, dp.PAIRED_EXTEND
    if max(Ms) > 4 * PEEL:
        open_, extend = dp.SINGLE_OPEN, dp.SINGLE_EXTEND

    matsL = dp.banded_matrices(
        jnp.asarray(q), jnp.asarray(gl), len1, len2L, lbandL, rbandL,
        pairmat, late, M=Mb, W=W, open_=open_, extend=extend)
    matsR = dp.banded_matrices(
        jnp.asarray(qr), jnp.asarray(grv), len1, len2R, lbandR, rbandR,
        pairmat, later, M=Mb, W=W, open_=open_, extend=extend)

    leftdi = dp.dinucl_codes_left(jnp.asarray(gl), NL)
    rightdi = dp.dinucl_codes_right(jnp.asarray(grv), NR)
    zL = jnp.zeros((nb, NL + 1), jnp.int32)
    zR = jnp.zeros((nb, NR + 1), jnp.int32)
    from . import gmap_config

    finalp = gmap_config.finalp_allowed(finalp)
    nosplicing = gmap_config.NOSPLICING
    reward = (dp.FINAL_CANONICAL_INTRON_HIGHQ if finalp
              else dp.CANONICAL_INTRON_HIGHQ)
    # bridge results stay ON DEVICE and feed traceback directly; one
    # packed transfer then fetches everything (fetch_packed) instead of
    # ~12 per-array round trips plus a host bounce of the bridge row/col
    # between the two kernels
    fs_d, brL_d, brR_d, bcL_d, bcR_d, ityp_d = dp.bridge_intron(
        matsL[0], matsL[3], matsR[0], matsR[3], jnp.asarray(len1),
        jnp.asarray(len2L), jnp.asarray(len2R),
        jnp.asarray(lbandL), jnp.asarray(lbandR), leftdi, rightdi, zL, zR,
        jnp.asarray(loffs), jnp.asarray(roffs),
        M=Mb, W=W, open_=open_, extend=extend,
        canonical_reward=reward, cdna_direction=cdna_direction,
        finalp=finalp, halfp=False, nosplicing=nosplicing)

    T = Mb + max(NL, NR) + 2
    tbL = dp.traceback(
        matsL[0], matsL[1], matsL[2], brL_d.astype(jnp.int32),
        bcL_d.astype(jnp.int32), jnp.asarray(lbandL), late,
        T=T, W=W, open_=open_, extend=extend)
    tbR = dp.traceback(
        matsR[0], matsR[1], matsR[2], brR_d.astype(jnp.int32),
        bcR_d.astype(jnp.int32), jnp.asarray(lbandR), later,
        T=T, W=W, open_=open_, extend=extend)
    handle = pack_dispatch([fs_d, ityp_d, *tbL, *tbR])
    return (handle, results, keep, requests)


def solve_junctions_finish(dispatched):
    """Host half of solve_junctions_dispatch: one packed transfer +
    piece assembly."""
    handle, results, keep, requests = dispatched
    if handle is None:
        return results
    (fs, ityp, opsL, oprL, opcL, opsR, oprR, opcR) = pack_finish(handle)

    def pieces_from(bi, ops, opr, opc, rev, lo, hi, diagL, diagR):
        # convert diag-run ops into (qpos, gpos) pairs in aligned coords
        pairs = []
        for t in range(ops.shape[1]):
            k = int(ops[bi, t])
            if k == dp.OP_NONE:
                continue
            if k == dp.OP_DIAG:
                r, c = int(opr[bi, t]), int(opc[bi, t])
                if rev:
                    qp = hi - 1 - r
                    gp = (diagR + hi - 1) - c
                else:
                    qp = lo + r
                    gp = diagL + lo + c
                pairs.append((qp, gp))
        return pairs

    for bi, i in enumerate(keep):
        if fs[bi] <= dp.NEG_INF // 2:
            continue
        qcodes, lo, hi, diagL, diagR = requests[i]
        pairs = (pieces_from(bi, opsL, oprL, opcL, False, lo, hi,
                             diagL, diagR)
                 + pieces_from(bi, opsR, oprR, opcR, True, lo, hi,
                               diagL, diagR))
        pairs.sort()
        pieces = []
        for qp, gp in pairs:
            d = gp - qp
            if pieces and pieces[-1][2] == d and pieces[-1][1] == qp:
                pieces[-1] = (pieces[-1][0], qp + 1, d)
            else:
                pieces.append((qp, qp + 1, d))
        results[i] = (int(fs[bi]), pieces, int(ityp[bi]))
    return results
