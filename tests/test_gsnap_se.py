"""GSNAP SE pipeline tests: seed->vote->verify on the chr17 fixture, and
unit tests for trimming / MD formatting semantics."""

import numpy as np
import pytest

import jax.numpy as jnp

from gmap_gsnap.align import gsnap_se, runner
from gmap_gsnap.db import build, indexdb
from gmap_gsnap.io import sam
from gmap_gsnap.ops import genome as genome_ops
from gmap_gsnap.utils import dna


@pytest.fixture(scope="module")
def chr17db(ref_tests):
    g = build.load_genome_fasta([str(ref_tests / "ss.chr17test")])
    genome = genome_ops.GenomeArrays.from_codes(g.codes, g.flags, g.chr_ends)
    offsets, positions = indexdb.build_index(g.codes, g.flags, g.chr_ends, 12, 3)
    index = gsnap_se.IndexArrays.from_host(offsets, positions, 12, 3)
    return g, genome, index


def test_align_batch_planted(chr17db):
    g, genome, index = chr17db
    rng = np.random.default_rng(5)
    B, L = 16, 100
    lefts = rng.integers(0, len(g.codes) - L, B)
    codes = np.stack([g.codes[l : l + L] for l in lefts])
    planted_nmm = []
    for b in range(B):
        nm = rng.integers(0, 4)
        n_eff = 0
        for _ in range(nm):
            p = rng.integers(0, L)
            old = codes[b, p]
            new = rng.integers(0, 4)
            codes[b, p] = new
        planted_nmm.append(None)
    # half the batch reverse-complemented
    rc = np.arange(B) % 2 == 1
    codes[rc] = (codes[rc, ::-1] ^ 3).astype(np.uint8)
    nflags = np.zeros((B, L), bool)
    lengths = np.full(B, L, np.int32)

    res = gsnap_se.align_batch(
        genome, index, jnp.asarray(codes), jnp.asarray(nflags), jnp.asarray(lengths)
    )
    npaths = np.asarray(res["npaths"])
    left = np.asarray(res["left"])
    plusp = np.asarray(res["plusp"])
    assert (npaths >= 1).all()
    for b in range(B):
        assert left[b, 0] == lefts[b]
        assert plusp[b, 0] == (not rc[b])


def test_align_batch_budget(chr17db):
    # a 36bp read with 2 mismatches must be rejected (auto budget = 1)
    g, genome, index = chr17db
    L = 36
    codes = g.codes[1000 : 1000 + L].copy()[None, :]
    codes = np.repeat(codes, 2, axis=0)
    codes[1, 10] ^= 1
    codes[1, 20] ^= 2
    res = gsnap_se.align_batch(
        genome,
        index,
        jnp.asarray(codes),
        jnp.zeros((2, L), bool),
        jnp.asarray(np.full(2, L, np.int32)),
    )
    npaths = np.asarray(res["npaths"])
    assert npaths[0] >= 1
    assert npaths[1] == 0


def test_optimal_score_filtering(chr17db):
    # exact hit + a 1-mismatch hit elsewhere: only the exact is reported
    g, genome, index = chr17db
    L = 60
    codes = g.codes[5000 : 5000 + L][None, :]
    res = gsnap_se.align_batch(
        genome,
        index,
        jnp.asarray(codes),
        jnp.zeros((1, L), bool),
        jnp.asarray(np.full(1, L, np.int32)),
    )
    nmm = np.asarray(res["nmm"])[0]
    npaths = int(np.asarray(res["npaths"])[0])
    assert npaths >= 1
    valid = nmm[nmm < 10**6]
    assert (valid == valid[0]).all()  # all reported hits share the best score


def test_trim_ends_semantics():
    # replicates substring.c trim scoring: 3 consecutive end mismatches trim
    mm = np.zeros(100, bool)
    mm[[0, 1, 2]] = True
    assert runner.trim_ends(mm) == (3, 0)
    mm = np.zeros(100, bool)
    mm[[97, 98, 99]] = True
    assert runner.trim_ends(mm) == (0, 3)
    # single interior mismatch: no trim
    mm = np.zeros(100, bool)
    mm[50] = True
    assert runner.trim_ends(mm) == (0, 0)
    # single mismatch 3 from the end: trimmed (observed reference behavior)
    mm = np.zeros(75, bool)
    mm[72] = True
    assert runner.trim_ends(mm) == (0, 3)
    # two mismatches 47 + 72: the raw trim is also 3 (the reference's
    # untrimmed 75M output comes from its GMAP improvement pass)
    mm = np.zeros(75, bool)
    mm[[47, 72]] = True
    assert runner.trim_ends(mm) == (0, 3)


def test_md_string_rules():
    assert sam.md_string("ACGT", "ACGT") == ("4", 0)
    assert sam.md_string("ACGT", "AGGT") == ("1G2", 1)
    # leading zero printed, adjacent mismatches without 0, trailing omitted
    assert sam.md_string("ACGT", "GCGT") == ("0G3", 1)
    assert sam.md_string("AACGT", "ATTGT") == ("1TT2", 2)
    assert sam.md_string("ACGT", "ACGA") == ("3A", 1)
    # query N never a mismatch
    assert sam.md_string("ANGT", "ACGT") == ("4", 0)


def test_seed_rank_map_packed_vs_unpacked():
    """The packed single-scatter rank map (small-genome fast path) and
    the two-scatter fallback produce identical compact seed grids."""
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from gmap_gsnap.align import gsnap_se as gs

    rng = np.random.default_rng(3)
    nolig = 4 ** 6
    counts = rng.integers(0, 6, nolig)
    counts[rng.integers(0, nolig, 40)] = rng.integers(30, 140, 40)
    off = np.zeros(nolig + 1, np.uint32)
    off[1:] = np.cumsum(counts)
    pos = rng.integers(0, 50000, int(off[-1])).astype(np.uint32)
    ix_packed = gs.IndexArrays.from_host(off, pos, k=6, interval=3)
    assert ix_packed.startcnt is not None
    ix_plain = dataclasses.replace(ix_packed, startcnt=None)

    B, S = 16, 32
    oligos = jnp.asarray(rng.integers(0, nolig, (B, S)).astype(np.int32))
    valid = jnp.asarray(rng.random((B, S)) < 0.9)
    params = gs.GsnapParams(seed_total=96)
    outs = []
    for ix in (ix_packed, ix_plain):
        gpos, o_idx, vs, trunc, count = gs._seed_rank_map(
            ix, oligos, valid, params)
        outs.append(tuple(np.asarray(x) for x in
                          (gpos, o_idx, vs, trunc, count)))
    for a, b in zip(*outs):
        assert np.array_equal(a, b)
