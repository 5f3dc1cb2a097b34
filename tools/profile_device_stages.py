"""Per-stage device timing of the SE gapped cascade.

Times each stage of gsnap_gapped.align_batch_gapped as its own jit
(steady state, outputs reduced to scalars so transfer cost ~0) on the
bench SE workload shapes: B=2048, L=100, chr17test DB.

Usage: python tools/profile_device_stages.py [B]
"""
import sys
import tempfile
import time
from functools import partial

import numpy as np

sys.path.insert(0, "/root/repo")

import jax
import jax.numpy as jnp

from gmap_gsnap.align import gsnap_gapped as gg
from gmap_gsnap.align import gsnap_se as gs
from gmap_gsnap.db import build
from gmap_gsnap.db.datadir import GenomeDB
from gmap_gsnap.utils import jaxenv

jaxenv.enable_compilation_cache()

B = int(sys.argv[1]) if len(sys.argv) > 1 else 2048
L = 100

tmp = tempfile.mkdtemp()
dbdir = build.build_db(
    ["/root/reference/tests/ss.chr17test"], "chr17test", tmp, k=12)
db = GenomeDB.open(dbdir, "chr17test")
seq = db.genome_str
genome = db.device_genome
index = db.device_index

rng = np.random.default_rng(42)
code_of = np.zeros(256, np.uint8)
for i, c in enumerate(b"ACGT"):
    code_of[c] = i
gcodes = code_of[seq.ascii]
lefts = rng.integers(0, len(seq) - L, B)
codes = gcodes[lefts[:, None] + np.arange(L)[None, :]].copy()
nmut = rng.integers(0, 4, B)
for i in range(B):
    for _ in range(nmut[i]):
        codes[i, rng.integers(0, L)] = rng.integers(0, 4)
rc = rng.random(B) < 0.5
codes[rc] = (codes[rc, ::-1] ^ 3).astype(np.uint8)

codes_j = jnp.asarray(codes)
nflags_j = jnp.zeros((B, L), bool)
lengths_j = jnp.full(B, L, jnp.int32)
params = gg.GappedParams()
base = params.base


def timeit(name, fn, *args, reps=10):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(reps):
        out = fn(*args)
        jax.block_until_ready(out)
    dt = (time.time() - t0) / reps
    print(f"  {name:34s} {dt*1e3:8.2f} ms  ({B/dt:9.0f} reads/s)")
    return out


def red(tree):
    """Reduce a pytree to one scalar so fetch cost ~0."""
    leaves = jax.tree_util.tree_leaves(tree)
    return sum(jnp.sum(x.astype(jnp.float32)) for x in leaves)


# ---------------- full pipeline
full = jax.jit(lambda c, n, l: red(
    gg.align_batch_gapped(genome, index, c, n, l, params)))
timeit("FULL align_batch_gapped", full, codes_j, nflags_j, lengths_j)

# ---------------- stage jits
conv_plus, conv_minus = gg._MODE_CONV[base.mode]


@jax.jit
def stage_pack(c, n, l):
    qf = gg._pack_device(c, n, l, L)
    cr, nr = gg._revcomp_batch(c, n, l)
    qr = gg._pack_device(cr, nr, l, L)
    return red((qf, qr))


timeit("pack (fwd+rev)", stage_pack, codes_j, nflags_j, lengths_j)


@jax.jit
def stage_seed(c, n, l):
    o, v = gg._extract_oligos(c, n, l, index.k)
    diag, qpos, trunc, nphase = gg._seed_diagonals(index, o, v, base)
    return red((diag, qpos, trunc, nphase))


timeit("seed (_seed_diagonals) x1 strand", stage_seed, codes_j, nflags_j,
       lengths_j)


@jax.jit
def stage_seed_top(c, n, l):
    o, v = gg._extract_oligos(c, n, l, index.k)
    diag, qpos, trunc, nphase = gg._seed_diagonals(index, o, v, base)
    top_d, votes, nd = gg._top_diagonals(diag, base.ncand)
    return red((top_d, votes, nd))


timeit("seed+top_diagonals x1", stage_seed_top, codes_j, nflags_j, lengths_j)


@jax.jit
def mk_inputs(c, n, l):
    qf = gg._pack_device(c, n, l, L)
    o, v = gg._extract_oligos(c, n, l, index.k)
    diag, qpos, trunc, nphase = gg._seed_diagonals(index, o, v, base)
    top_d, votes, nd = gg._top_diagonals(diag, base.ncand)
    return qf, diag, qpos, top_d, votes


qf, diag, qpos_g, top_d, votes = jax.block_until_ready(
    mk_inputs(codes_j, nflags_j, lengths_j))


@jax.jit
def stage_verify(q, td, l):
    mm, pref = gg._prefix_mm(genome, q, td, l, conv_plus, None)
    return red((mm[:, :, -1], pref[:, :, -1]))


timeit("verify (_prefix_mm NC=%d) x1" % base.ncand, stage_verify, qf, top_d,
       lengths_j)

budget = jnp.maximum(
    (lengths_j + index.interval - 1)
    // (-(-index.k // index.interval) * index.interval) - 2, 0)


@jax.jit
def stage_indels(q, dg, qpg, td, vt, l):
    mm, pref = gg._prefix_mm(genome, q, td, l, conv_plus, None)
    ii, jj, pv = gg._select_pairs(
        td, vt,
        lambda di, dj: (
            ((dj - di).astype(jnp.int32) >= 1)
            & ((dj - di).astype(jnp.int32) <= base.max_middle_deletions))
        | (((di - dj).astype(jnp.int32) >= 1)
           & ((di - dj).astype(jnp.int32) <= base.max_middle_insertions)),
        params.indel_pairs)
    qp5, qp3 = gg._qpos_ranges(dg, qpg, td)
    ind = gg._solve_indels(td, mm, pref, ii, jj, pv, l, budget, L,
                           qp5=qp5, qp3=qp3,
                           max_ins=base.max_middle_insertions,
                           max_del=base.max_middle_deletions,
                           min_end=base.min_indel_end_matches)
    return red(ind)


timeit("verify+pairs+indels x1", stage_indels, qf, diag, qpos_g,
       top_d, votes, lengths_j)


@jax.jit
def stage_lanefeat(q, td, l):
    mm, pref = gg._prefix_mm(genome, q, td, l, conv_plus, None)
    dok = (td != gg.INVALID_DIAG) & (
        td + l.astype(jnp.uint32)[:, None] <= jnp.uint32(genome.length))
    nmm_raw = jnp.where(dok, pref[:, :, -1], gg.BIG_NMM)
    lf = gg._lane_features(mm, pref, nmm_raw, l, index.k, index.interval,
                           base.trim_mismatch_score)
    return red((lf, gg._bitpack_mask(mm)))


timeit("verify+lane_features+bitpack x1", stage_lanefeat, qf, top_d,
       lengths_j)


# ---------------- gather_candidates (both strands, everything pre-rank)
@jax.jit
def stage_gather(c, n, l):
    out, cands = gg.gather_candidates(
        genome, index, None, c, n, l, params, None, None)
    return red((out, cands))


timeit("gather_candidates (2 strands)", stage_gather, codes_j, nflags_j,
       lengths_j)


@jax.jit
def stage_rank(c, n, l):
    out, cands = gg.gather_candidates(
        genome, index, None, c, n, l, params, None, None)
    return red(gg.rank_hits(out, base))


timeit("gather+rank_hits", stage_rank, codes_j, nflags_j, lengths_j)
