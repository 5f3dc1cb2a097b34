"""Mismatch kernel tests: packed XOR+popcount vs brute-force string
comparison (the re-derived genome_hr semantics)."""

import numpy as np
import pytest

import jax.numpy as jnp

from gmap_gsnap.ops import genome as genome_ops
from gmap_gsnap.ops import mismatch as mm_ops
from gmap_gsnap.utils import dna


@pytest.fixture(scope="module")
def toy():
    rng = np.random.default_rng(42)
    n = 5000
    codes = rng.integers(0, 4, n).astype(np.uint8)
    flags = rng.random(n) < 0.01  # sprinkle genome Ns
    genome = genome_ops.GenomeArrays.from_codes(codes, flags, [n])
    return codes, flags, genome


def brute_count(codes, flags, qcodes, qn, left, pos5, pos3):
    cnt = 0
    for i in range(pos5, pos3):
        g = left + i
        if qn[i]:
            continue  # query N never mismatches (query_unk_mismatch_p=false)
        if g >= len(codes) or flags[g] or codes[g] != qcodes[i]:
            cnt += 1
    return cnt


def make_queries(rng, codes, flags, B, L, mutate=True):
    lefts = rng.integers(0, len(codes) - L - 1, B).astype(np.uint32)
    q = np.zeros((B, L), dtype=np.uint8)
    qn = np.zeros((B, L), dtype=bool)
    for b in range(B):
        q[b] = codes[lefts[b] : lefts[b] + L]
        if mutate:
            nmut = rng.integers(0, 6)
            for _ in range(nmut):
                p = rng.integers(0, L)
                q[b, p] = rng.integers(0, 4)
            if rng.random() < 0.3:
                qn[b, rng.integers(0, L)] = True
    lengths = np.full(B, L, dtype=np.int64)
    return lefts, q, qn, lengths


def test_count_mismatches_matches_bruteforce(toy):
    codes, flags, genome = toy
    rng = np.random.default_rng(0)
    B, L = 64, 100
    lefts, q, qn, lengths = make_queries(rng, codes, flags, B, L)
    queries = mm_ops.pack_queries(q, qn, lengths)
    pos5 = rng.integers(0, 20, B).astype(np.int32)
    pos3 = L - rng.integers(0, 20, B).astype(np.int32)
    got = np.asarray(
        mm_ops.count_mismatches(
            genome, queries, jnp.asarray(lefts), jnp.asarray(pos5), jnp.asarray(pos3)
        )
    )
    want = np.array(
        [brute_count(codes, flags, q[b], qn[b], int(lefts[b]), int(pos5[b]), int(pos3[b])) for b in range(B)]
    )
    np.testing.assert_array_equal(got, want)


def test_count_mismatches_unaligned_lefts(toy):
    # every possible shift within a word
    codes, flags, genome = toy
    B, L = 16, 33
    lefts = np.arange(100, 100 + B, dtype=np.uint32)
    q = np.stack([codes[l : l + L] for l in lefts])
    qn = np.zeros((B, L), dtype=bool)
    queries = mm_ops.pack_queries(q, qn, np.full(B, L))
    got = np.asarray(
        mm_ops.count_mismatches(
            genome,
            queries,
            jnp.asarray(lefts),
            jnp.zeros(B, jnp.int32),
            jnp.full((B,), L, jnp.int32),
        )
    )
    want = np.array(
        [brute_count(codes, flags, q[b], qn[b], int(lefts[b]), 0, L) for b in range(B)]
    )
    np.testing.assert_array_equal(got, want)


def test_mismatch_positions(toy):
    codes, flags, genome = toy
    rng = np.random.default_rng(7)
    B, L, K = 32, 75, 8
    lefts, q, qn, lengths = make_queries(rng, codes, flags, B, L)
    queries = mm_ops.pack_queries(q, qn, lengths)
    pos5 = np.zeros(B, np.int32)
    pos3 = np.full(B, L, np.int32)
    posL, cntL = mm_ops.mismatch_positions_left(
        genome, queries, jnp.asarray(lefts), jnp.asarray(pos5), jnp.asarray(pos3), K
    )
    posR, cntR = mm_ops.mismatch_positions_right(
        genome, queries, jnp.asarray(lefts), jnp.asarray(pos5), jnp.asarray(pos3), K
    )
    posL, cntL, posR, cntR = map(np.asarray, (posL, cntL, posR, cntR))
    for b in range(B):
        mm = [
            i
            for i in range(L)
            if not qn[b, i] and (flags[lefts[b] + i] or codes[lefts[b] + i] != q[b, i])
        ]
        k = min(len(mm), K)
        assert cntL[b] == k and cntR[b] == k
        np.testing.assert_array_equal(posL[b, :k], mm[:k])
        np.testing.assert_array_equal(posR[b, :k], mm[::-1][:k])


def test_fetch_codes_roundtrip(toy):
    codes, flags, genome = toy
    pos = np.arange(0, 2000, 7, dtype=np.uint32)
    got = np.asarray(genome_ops.fetch_codes(genome.ref16, jnp.asarray(pos)))
    np.testing.assert_array_equal(got, codes[pos])
    gotf = np.asarray(genome_ops.fetch_flags(genome.flag16, jnp.asarray(pos)))
    np.testing.assert_array_equal(gotf, flags[pos])
