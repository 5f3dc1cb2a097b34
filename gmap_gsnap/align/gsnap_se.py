"""GSNAP single-end alignment pipeline (mismatch-only slice), batched.

Replaces the reference per-read stage1hr cascade (stage1hr.c:11869
align_end, steps 1-5: spanning-set exact/one-miss/multi-miss + complete-
set mismatch) with a batched, static-shaped seed -> vote -> verify dataflow over a
whole batch of reads at once:

  1. SEED: every query k-mer (all L-k+1 start positions, both strands)
     is looked up in the positional index (two gathers: offsets then a
     capped slice of positions).  Overabundant oligos are skipped, like
     the reference's indexdb_size_threshold policy (gsnap.c:2094-2098,
     stage1hr.c:1029).
  2. VOTE: each (k-mer, genome position) hit votes for a diagonal
     ``left = position - querypos``.  Per-read diagonal lists are sorted
     (jnp.sort over a static-width tensor replaces the heap merge of
     stage1hr.c:3075 identify_all_segments) and run-length counted.
  3. VERIFY: the top-voted diagonals per read are scored exactly with
     the XOR+popcount mismatch kernel on both strands; hits with
     nmismatches <= the budget emerge ranked by (nmm, left, strand).

Completeness: a placement with m mismatches splits the read into <= m+1
clean stretches; the longest has >= (L-m)/(m+1) nt and yields an
index-phase-aligned k-mer seed whenever that length >= k + interval - 1
(pigeonhole, mirroring the reference spanning-set guarantee).  For
L=100, k=12, interval=3 this covers m <= 5; beyond that hits may need
the (future) rescue lane.

Everything is int32/uint32 — independent of
jax_enable_x64.  Composite orderings use stable multi-pass argsorts
instead of wide keys.  Genomes up to 2^32 bp; positions arrays up to
2^31 entries.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import genome as genome_ops
from ..ops import mismatch as mm_ops

INVALID_DIAG = jnp.uint32(0xFFFFFFFF)
BIG_NMM = jnp.int32(10**6)


@jax.tree_util.register_pytree_node_class
@dataclass
class IndexArrays:
    """K-mer positional index as device arrays."""

    offsets: jax.Array    # uint32[4^k + 1] cumulative
    positions: jax.Array  # uint32[N] genome start coords, grouped by oligo
    k: int                # static
    interval: int         # static
    # (start << 8) | min(count, 255) per oligo, when the positions
    # array is small enough (< 2^24 entries) for start to fit 24 bits.
    # Halves the seeding's per-oligo gather volume: one packed fetch
    # instead of offsets[o] + offsets[o+1].
    startcnt: jax.Array | None = None

    def tree_flatten(self):
        return (self.offsets, self.positions, self.startcnt), (
            self.k, self.interval)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children[:2], aux[0], aux[1], children[2])

    @classmethod
    def from_host(cls, offsets: np.ndarray, positions: np.ndarray, k: int, interval: int):
        # pad positions to a multiple of 8 so seeding can gather aligned
        # 8-wide rows (one gather descriptor per 8 entries)
        positions = positions.astype(np.uint32)
        pad = (-len(positions)) % 8
        if pad:
            positions = np.concatenate(
                [positions, np.zeros(pad, np.uint32)]
            )
        off = offsets.astype(np.uint32)
        startcnt = None
        if len(positions) < (1 << 24):
            cnt = np.minimum(np.diff(off.astype(np.int64)), 255)
            startcnt = jnp.asarray(
                ((off[:-1].astype(np.uint32)) << np.uint32(8))
                | cnt.astype(np.uint32))
        return cls(
            offsets=jnp.asarray(off),
            positions=jnp.asarray(positions),
            k=int(k),
            interval=int(interval),
            startcnt=startcnt,
        )


def dynamic_size_threshold(npositions: int, k: int, mode: str) -> int:
    """The reference's overabundance policy (gsnap.c:2094-2098):
    indexdb_size_threshold = 10 * mean positions/oligo, floored at
    MIN_INDEXDB_SIZE_THRESHOLD=100.  The oligo space for cmet/atoi
    modes is 3^k (Indexdb_mean_size, indexdb.c:205-216)."""
    n = 3 ** k if mode != "standard" else 4 ** k
    return max(int(10.0 * npositions / n), 100)


@dataclass(frozen=True)
class GsnapParams:
    """Static pipeline configuration (shapes bake into the jit cache)."""

    seed_total: int = 384      # compact seed-grid slots per read (all
                               # oligos share the budget; 0 = exact,
                               # i.e. S * size_threshold slots)
    size_threshold: int = 100  # skip oligos with more positions than this
    ncand: int = 32            # diagonals verified per read per strand
    maxpaths: int = 100        # hits reported per read
    max_mismatches: int = -1   # -1: auto = (L+2)//12 like gsnap -m default
    subopt_levels: int = 0     # report hits within this score of the best
                               # (gsnap --suboptimal-levels, default 0:
                               # optimal-score hits only, stage3hr.c:3798)
    mode: str = "standard"     # standard | cmet-stranded | atoi-stranded
    snp_tolerant: bool = False # verify against ref AND alt genomes

    # scoring/window knobs, defaults = gsnap.c:83-212 (all static: part
    # of the jit cache key, so changing one recompiles once)
    indel_penalty_middle: int = 2       # gsnap.c:185 (-i)
    indel_penalty_end: int = 2          # gsnap.c:186 (-i)
    min_indel_end_matches: int = 4      # gsnap.c:193 (--indel-endlength)
    max_middle_insertions: int = 9      # gsnap.c:189 (-y)
    max_middle_deletions: int = 30      # gsnap.c:190 (-z)
    max_end_insertions: int = 3         # gsnap.c:191 (-Y)
    max_end_deletions: int = 6          # gsnap.c:192 (-Z)
    localsplicing_penalty: int = 0      # gsnap.c:196 (-e)
    distantsplicing_penalty: int = 1    # gsnap.c:197 (-E)
    min_distant_end_matches: int = 16   # gsnap.c:198 (-K)
    min_shortend: int = 2               # gsnap.c:200 (-l)
    shortsplicedist: int = 200_000      # gsnap.c:194 (-w)
    pairmax_dna: int = 1_000            # gsnap.c:162 (--pairmax-dna)
    pairmax_rna: int = 200_000          # gsnap.c:163 (--pairmax-rna)
    terminal_threshold: int = 2         # gsnap.c:182
    trim_mismatch_score: int = -3       # gsnap.c:146
    trim_indel_score: int = -4          # gsnap.c:147

    # GMAP-rescue lane knobs (gsnap.c:83-98).  gmap_mode is the
    # comma-separated lane list of --gmap-mode; trigger_score_for_gmap
    # gates the PE pairsearch lane exactly like the reference
    # (stage1hr.c:14531: found_score > trigger; found_score is
    # querylength5+querylength3 when no concordant pair exists, which
    # is the only situation our rescue lane runs in).
    gmap_mode: str = "pairsearch,indel_knownsplice,terminal,improvement"
    trigger_score_for_gmap: int = 5     # gsnap.c:98
    max_gmap_pairsearch: int = 10       # gsnap.c:90 (anchors tried)
    max_gmap_terminal: int = 50         # gsnap.c:91 default 5 caps how
                                        # many terminals get a GMAP try;
                                        # our single-GMAP design skips
                                        # the lane past this count
    max_gmap_improvement: int = 5       # gsnap.c:92
    gmap_min_coverage: float = 0.5      # gsnap.c:84
    microexon_spliceprob: float = 0.95  # gsnap.c:94
    # Static data-shape hint, set per batch by the runner: every read
    # in the batch has length == lmax, so the reverse complement is a
    # pure flip (a layout op) instead of a per-row gather.  Purely an
    # optimization flag — both variants produce identical results.
    uniform_len: bool = False

    # Accepted for compatibility; every application site in the
    # reference is disabled with if(0) (stage1hr.c:6343,6480,6815,7058)
    antistranded_penalty: int = 0       # gsnap.c:202
    # Live only in GMAP PE path merging (stage3.c:2818); the gsnap
    # sites are compiled out (USE_BINGO, stage3hr.c:6334)
    expected_pairlength: int = 200      # gsnap.c:165 (--pairexpect)
    pairlength_deviation: int = 25      # gsnap.c:166 (--pairdev)


def _extract_oligos(codes: jax.Array, nflags: jax.Array, lengths: jax.Array, k: int):
    """Pack every k-mer of each read MSB-first.  codes uint8[B, L].
    Returns (oligos int32[B, S], valid bool[B, S]) with S = L - k + 1."""
    b, lmax = codes.shape
    s = lmax - k + 1
    c = codes.astype(jnp.int32)
    oligo = jnp.zeros((b, s), dtype=jnp.int32)
    badcount = jnp.zeros((b, s), dtype=jnp.int32)
    for i in range(k):
        oligo = (oligo << 2) | jax.lax.dynamic_slice_in_dim(c, i, s, axis=1)
        badcount = badcount + jax.lax.dynamic_slice_in_dim(
            nflags.astype(jnp.int32), i, s, axis=1
        )
    qpos = jnp.arange(s, dtype=jnp.int32)[None, :]
    valid = (badcount == 0) & (qpos + k <= lengths[:, None])
    return oligo, valid


def _seed_grid_width(s: int, params: GsnapParams) -> int:
    """Static compact-grid width for S oligos: seed_total slots, or the
    exact maximum (S * size_threshold) when seed_total == 0."""
    wmax = s * params.size_threshold
    return wmax if params.seed_total == 0 else min(params.seed_total, wmax)


def _seed_rank_map(index, oligos, valid, params: GsnapParams):
    """Shared rank->position mapping for the compact seed grid.

    Slot t of read b holds the t-th position (in query-position order)
    of the read's usable oligos; every usable oligo contributes its
    FULL position list (count <= size_threshold — the reference uses
    every position of any in-threshold oligo, stage1hr.c:1029), so the
    only truncation is the shared per-read budget W.

    Returns (gpos int32[B, W] global positions-array indices,
    qpos int32[B, W] owner oligo / query position, valid_slot bool,
    trunc bool[B], count int32[B, S])."""
    b, s = oligos.shape
    sc = getattr(index, "startcnt", None)
    if sc is not None and params.size_threshold < 255:
        packed = sc[oligos]
        start = (packed >> jnp.uint32(8)).astype(jnp.int32)
        count = (packed & jnp.uint32(0xFF)).astype(jnp.int32)  # clamped
    else:
        off = index.offsets
        start = off[oligos].astype(jnp.int32)
        end = off[jnp.minimum(oligos + 1, off.shape[0] - 1)].astype(jnp.int32)
        count = end - start
    usable = valid & (count > 0) & (count <= params.size_threshold)
    ccap = jnp.where(usable, count, 0)
    cum = jnp.cumsum(ccap, axis=1)                      # inclusive [B, S]
    total = cum[:, -1]
    w = _seed_grid_width(s, params)
    trunc = total > w
    t = jnp.arange(w, dtype=jnp.int32)[None, :]         # [1, W]
    # owner oligo of slot t: scatter each contributing oligo's index at
    # its first slot (cum_ex, unique among usable oligos) and
    # forward-fill with a running max — the scatter/cummax idiom that
    # replaced broadcast compare-reduces elsewhere in this codebase
    cum_ex = cum - ccap                                 # exclusive
    rows_b = jnp.broadcast_to(
        jnp.arange(b, dtype=jnp.int32)[:, None], (b, s))
    slot = jnp.where(usable & (cum_ex < w), cum_ex, w)  # w = dropped
    o_iota = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32)[None, :],
                              (b, s))
    valid_slot = t < jnp.minimum(total, w)[:, None]
    # Slot owner + genome index are BOTH piecewise constant over slots:
    # gpos[t] = t + delta[o(t)] with delta = start - cum_ex, and
    # qpos[t] = o(t).  Instead of materializing them via
    # take_along_axis, scatter each usable oligo's STEP at its first
    # slot and integrate with a cumsum.
    # When delta fits 24 bits (same small-genome condition as the
    # packed startcnt table), one scatter of packed (delta*128 + o)
    # carries both; otherwise o rides a second scatter + cummax.
    delta = start - cum_ex

    def stepfill(vals):
        """cumsum-of-scattered-diffs forward fill of a per-usable-oligo
        value over the compact slots."""
        ff = jnp.where(usable, vals, 0)
        have = usable
        step = 1
        while step < s:
            ff_s = jnp.pad(ff, ((0, 0), (step, 0)))[:, :s]
            have_s = jnp.pad(have, ((0, 0), (step, 0)))[:, :s]
            ff = jnp.where(have, ff, ff_s)
            have = have | have_s
            step *= 2
        prev = jnp.pad(ff, ((0, 0), (1, 0)))[:, :s]      # ff[o-1]
        diff = jnp.where(usable, vals - prev, 0)
        steps = jnp.zeros((b, w), jnp.int32).at[rows_b, slot].add(
            diff, mode="drop")
        return jnp.cumsum(steps, axis=1)

    small = sc is not None and params.size_threshold < 255
    if small:
        spow = 128
        assert s < spow
        fill = stepfill(delta * spow + o_iota)
        o_idx = jnp.remainder(fill, spow)
        gpos = t + (fill - o_idx) // spow
        o_idx = jnp.clip(o_idx, 0, s - 1)
    else:
        o_mark = jnp.full((b, w), -1, jnp.int32).at[rows_b, slot].max(
            o_iota, mode="drop")
        o_idx = jnp.clip(jax.lax.cummax(o_mark, axis=1), 0, s - 1)
        gpos = t + stepfill(delta)
    gpos = jnp.where(valid_slot, gpos, 0)
    return gpos, o_idx, valid_slot, trunc, count


def _seed_diagonals(index: IndexArrays, oligos, valid, params: GsnapParams,
                    lengths=None):
    """Candidate diagonals on the compact seed grid.

    Returns ``(diag uint32[B, W], qpos int32[B, W], trunc, nphase_min,
    nph_half)``:

    * ``diag``: pos - querypos per occupied slot (INVALID_DIAG in empty
      slots); W = seed_total slots shared by all of the read's oligos,
      so the ~97%-padding per-oligo slot grid of the old layout (and
      its big gather + sort) disappears.
    * ``qpos``: the owning oligo index (== query position) per slot.
    * ``trunc``: the read's total in-threshold positions exceeded W —
      the wide rescue lane re-runs it with seed_total=0 (exact).
    * ``nphase_min`` int32[B]: min over the ``interval`` sampling phases
      of the number of in-threshold valid oligos in that phase — the
      pigeonhole floor input (stage1hr.c FLOOR_* analog) used to bound
      the mismatches of any diagonal dropped by the top-ncand cut.
    * ``nph_half`` int32[B]: the same min-phase count restricted to the
      weaker read HALF (oligos fully inside [0, L/2) vs [L/2, L)) — the
      per-half floor input matching the reference's terminal/end-lane
      segment filter (identify_all_segments_for_terminals keeps a
      segment iff floor_left <= done || floor_right <= done).  Zero
      when ``lengths`` is not given.

    A ShardedIndexArrays index routes the positions gather through the
    sharded-positions path (parallel.shard.sharded_seed_diagonals)."""
    from ..parallel import shard as shard_mod

    b, s = oligos.shape
    q = index.interval
    qpos_iota = jnp.arange(s, dtype=jnp.int32)

    def phase_min(bound_ok):
        counts = [
            jnp.sum(bound_ok & (qpos_iota[None, :] % q == c), axis=1)
            for c in range(q)
        ]
        return jnp.minimum(
            jnp.min(jnp.stack(counts, axis=1), axis=1).astype(jnp.int32),
            jnp.sum(bound_ok, axis=1).astype(jnp.int32))

    gpos, o_idx, valid_slot, trunc, count = _seed_rank_map(
        index, oligos, valid, params)
    if isinstance(index, shard_mod.ShardedIndexArrays):
        diag = shard_mod.sharded_seed_diagonals(
            index, gpos, o_idx, valid_slot)
    else:
        pos = index.positions[
            jnp.clip(gpos, 0, index.positions.shape[0] - 1)]
        qpos_u = o_idx.astype(jnp.uint32)
        ok = valid_slot & (pos >= qpos_u)
        diag = jnp.where(ok, pos - qpos_u, INVALID_DIAG)
    bound_ok = valid & (count <= params.size_threshold)
    nphase_min = phase_min(bound_ok)
    if lengths is None:
        nph_half = jnp.zeros(b, jnp.int32)
    else:
        halfL = lengths.astype(jnp.int32)[:, None] // 2
        left = bound_ok & (qpos_iota[None, :] + index.k <= halfL)
        right = bound_ok & (qpos_iota[None, :] >= halfL)
        nph_half = jnp.minimum(phase_min(left), phase_min(right))
    return diag, o_idx, trunc, nphase_min, nph_half


def _top_diagonals(diag, ncand: int):
    """Sort diagonals per read, run-length count votes, return the top
    ``ncand`` distinct diagonals ordered by (votes desc, diag asc).
    Returns (diags uint32[B, ncand], votes int32[B, ncand], ndistinct)."""
    d = jnp.sort(diag, axis=1)  # uint32 ascending; INVALID at the end
    n = d.shape[1]
    first = jnp.concatenate(
        [jnp.ones_like(d[:, :1], dtype=bool), d[:, 1:] != d[:, :-1]], axis=1
    )
    idx = jnp.arange(n, dtype=jnp.int32)[None, :]
    start = jax.lax.cummax(jnp.where(first, idx, -1), axis=1)
    is_last = jnp.concatenate([first[:, 1:], jnp.ones_like(first[:, :1])], axis=1)
    last = jnp.flip(
        jax.lax.cummin(
            jnp.flip(jnp.where(is_last, idx, jnp.int32(2**30)), axis=1), axis=1
        ),
        axis=1,
    )
    votes = last - start + 1
    is_head = first & (d != INVALID_DIAG)
    votes = jnp.where(is_head, votes, 0)
    # d is already ascending; top_k breaks vote ties by lower index,
    # which is exactly (votes desc, diag asc) — and a K-selection is
    # much cheaper than the full argsort it replaces
    top_v, order = jax.lax.top_k(votes, ncand)
    top_d = jnp.take_along_axis(d, order, axis=1)
    top_d = jnp.where(top_v > 0, top_d, INVALID_DIAG)
    ndistinct = jnp.sum(is_head, axis=1).astype(jnp.int32)
    return top_d, top_v, ndistinct


def _qpos_ranges(diag_grid, qpos_grid, d_sel):
    """First/last seed query position per selected diagonal — the
    reference Segment querypos5/querypos3 (stage1hr.c:9000) used to
    gate indel pairing.  Computed lazily against the UNSORTED compact
    seed grid (qpos_grid = per-slot owner oligo, _seed_diagonals) only
    for the few diagonals the pair selector kept; a broadcast compare +
    fused min/max reduce is far cheaper than carrying qpos through the
    hot diagonal sort."""
    eq = diag_grid[:, None, :] == d_sel[:, :, None]          # [B, P, W]
    qpos = qpos_grid[:, None, :]
    qp5 = jnp.min(jnp.where(eq, qpos, jnp.int32(2**30)), axis=2)
    qp3 = jnp.max(jnp.where(eq, qpos, jnp.int32(-1)), axis=2)
    return qp5, qp3


def _verify(genome, queries, diags, lengths, conversion=None, alt=None):
    """Exact mismatch counts for candidate diagonals.
    diags uint32[B, NC] -> nmm int32[B, NC] (BIG_NMM where invalid)."""
    b, nc = diags.shape
    glen = jnp.uint32(genome.length)
    ok = (diags != INVALID_DIAG) & (diags + lengths.astype(jnp.uint32)[:, None] <= glen)
    lefts = jnp.where(ok, diags, 0).reshape(-1)
    rep = lambda x: jnp.repeat(x, nc, axis=0)
    q = mm_ops.PackedQueries(
        codes16=rep(queries.codes16),
        nflags16=rep(queries.nflags16),
        length=rep(queries.length),
        lmax=queries.lmax,
    )
    pos5 = jnp.zeros(b * nc, jnp.int32)
    pos3 = rep(lengths)
    nmm = mm_ops.count_mismatches(genome, q, lefts, pos5, pos3, conversion, alt).reshape(b, nc)
    return jnp.where(ok, nmm, BIG_NMM)


_MODE_CONV = {
    # (plus-strand conversion, minus-strand conversion)
    "standard": (None, None),
    "cmet-stranded": ("ct", "ga"),
    "atoi-stranded": ("ag", "tc"),
}


def _convert_codes(codes, conversion):
    """Apply a cmet/atoi nucleotide conversion to unpacked codes."""
    if conversion is None:
        return codes
    src, dst = {"ct": (1, 3), "ga": (2, 0), "ag": (0, 2), "tc": (3, 1)}[conversion]
    return jnp.where(codes == src, jnp.uint8(dst), codes)


@partial(jax.jit, static_argnames=("params",))
def align_batch(
    genome: genome_ops.GenomeArrays,
    index: IndexArrays,
    codes,      # uint8[B, L] read codes (A=0..T=3)
    nflags,     # bool[B, L] read N flags
    lengths,    # int32[B]
    params: GsnapParams = GsnapParams(),
    index_minus: IndexArrays | None = None,  # cmet/atoi: minus-strand index
    alt=None,   # optional (alt_ref16, alt_flag16) for SNP tolerance
):
    """Align a batch of reads; mismatch-only (no indels / splicing).

    Returns dict of arrays (all [B, maxpaths] unless noted):
      left     uint32 - plus-strand genome coordinate of the alignment
               start (for minus hits: of the reversed alignment)
      plusp    bool
      nmm      int32  - mismatch count (BIG_NMM = empty slot)
      npaths   int32[B]
      best_nmm int32[B]
    """
    b, lmax = codes.shape
    lengths = lengths.astype(jnp.int32)

    conv_plus, conv_minus = _MODE_CONV[params.mode]
    if index_minus is None:
        index_minus = index

    queries_fwd = _pack_device(codes, nflags, lengths, lmax)
    codes_rc, nflags_rc = _revcomp_batch(codes, nflags, lengths,
                                         params.uniform_len)
    queries_rev = _pack_device(codes_rc, nflags_rc, lengths, lmax)

    oligos_f, valid_f = _extract_oligos(
        _convert_codes(codes, conv_plus), nflags, lengths, index.k
    )
    oligos_r, valid_r = _extract_oligos(
        _convert_codes(codes_rc, conv_minus), nflags_rc, lengths, index.k
    )

    diag_f, _, trunc_f, _, _ = _seed_diagonals(
        index, oligos_f, valid_f, params)
    diag_r, _, trunc_r, _, _ = _seed_diagonals(
        index_minus, oligos_r, valid_r, params)

    top_f, _, nd_f = _top_diagonals(diag_f, params.ncand)
    top_r, _, nd_r = _top_diagonals(diag_r, params.ncand)

    nmm_f = _verify(genome, queries_fwd, top_f, lengths, conv_plus, alt)
    nmm_r = _verify(genome, queries_rev, top_r, lengths, conv_minus, alt)

    if params.max_mismatches >= 0:
        budget = jnp.full((b,), params.max_mismatches, jnp.int32)
    else:
        # gsnap auto level (stage1hr.c:11900): fast_level =
        # (L + interval - 1)/spansize - NREQUIRED_FAST(2), clamped >= 0,
        # spansize = smallest multiple of interval >= k
        spansize = -(-index.k // index.interval) * index.interval
        budget = jnp.maximum(
            (lengths + index.interval - 1) // spansize - 2, 0
        )

    all_left = jnp.concatenate([top_f, top_r], axis=1)
    all_nmm = jnp.concatenate([nmm_f, nmm_r], axis=1)
    all_plus = jnp.concatenate(
        [jnp.ones_like(nmm_f, bool), jnp.zeros_like(nmm_r, bool)], axis=1
    )
    all_nmm = jnp.where(all_nmm <= budget[:, None], all_nmm, BIG_NMM)

    # rank by (nmm asc, left asc, plus before minus) via stable passes
    take_cols = lambda x, i: jnp.take_along_axis(x, i, axis=1)

    ord1 = jnp.argsort(
        jnp.where(all_plus, jnp.uint32(0), jnp.uint32(1)), axis=1, stable=True
    )
    left1 = take_cols(all_left, ord1)
    ord2 = jnp.argsort(left1, axis=1, stable=True)
    perm2 = take_cols(ord1, ord2)
    left2 = take_cols(all_left, perm2)
    nmm2 = take_cols(all_nmm, perm2)
    plus2 = take_cols(all_plus, perm2)

    # drop duplicates of the same (left, strand) before the final sort
    key = left2 * 2 + jnp.where(plus2, 0, 1)
    dup = jnp.concatenate(
        [jnp.zeros_like(plus2[:, :1]), key[:, 1:] == key[:, :-1]], axis=1
    ) & (nmm2 < BIG_NMM)
    nmm2 = jnp.where(dup, BIG_NMM, nmm2)

    # optimal-score filtering (Stage3end_optimal_score, stage3hr.c:3798):
    # keep only hits within subopt_levels of the best score
    best = jnp.min(nmm2, axis=1, keepdims=True)
    nmm2 = jnp.where(nmm2 > best + params.subopt_levels, BIG_NMM, nmm2)

    ord3 = jnp.argsort(nmm2, axis=1, stable=True)[:, : params.maxpaths]
    left = take_cols(left2, ord3)
    nmm = take_cols(nmm2, ord3)
    plusp = take_cols(plus2, ord3)

    valid_hit = nmm < BIG_NMM
    npaths = jnp.sum(valid_hit, axis=1).astype(jnp.int32)
    best_nmm = jnp.min(nmm, axis=1)
    return {
        "left": jnp.where(valid_hit, left, 0).astype(jnp.uint32),
        "plusp": plusp,
        "nmm": nmm,
        "npaths": npaths,
        "best_nmm": best_nmm,
    }


def _pack_device(codes, nflags, lengths, lmax):
    """Device-side equivalent of mm_ops.pack_queries."""
    b = codes.shape[0]
    w = (lmax + 15) // 16
    pad = w * 16 - lmax
    idx = jnp.arange(lmax, dtype=jnp.int32)[None, :]
    nf = nflags | (idx >= lengths[:, None])
    if pad:
        codes = jnp.pad(codes, ((0, 0), (0, pad)))
        nf = jnp.pad(nf, ((0, 0), (0, pad)), constant_values=True)
    c = codes.astype(jnp.uint32).reshape(b, w, 16)
    f = nf.astype(jnp.uint32).reshape(b, w, 16)
    sh = jnp.arange(16, dtype=jnp.uint32)
    codes16 = jnp.sum(c << (2 * sh), axis=2).astype(jnp.uint32)
    nflags16 = jnp.sum(f << sh, axis=2).astype(jnp.uint32)
    return mm_ops.PackedQueries(codes16, nflags16, lengths, lmax)


def _revcomp_batch(codes, nflags, lengths, uniform: bool = False):
    """Per-read reverse complement honoring individual lengths.

    uniform=True asserts every length == lmax (caller-guaranteed): the
    revcomp is then a flip along the read axis — a cheap layout op —
    instead of a per-row take_along_axis gather."""
    if uniform:
        return jnp.flip(codes, axis=1) ^ 3, jnp.flip(nflags, axis=1)
    b, lmax = codes.shape
    idx = jnp.arange(lmax, dtype=jnp.int32)[None, :]
    src = lengths[:, None] - 1 - idx
    ok = src >= 0
    src = jnp.clip(src, 0, lmax - 1)
    rc = jnp.take_along_axis(codes, src, axis=1) ^ 3
    rn = jnp.take_along_axis(nflags, src, axis=1)
    rc = jnp.where(ok, rc, 0).astype(codes.dtype)
    rn = rn | ~ok
    return rc, rn
