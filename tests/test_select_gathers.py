"""Exact selection by gathers in the alignment cascade, against NumPy.

Candidate permutations, pair gathers, shifted prefix reads and maxent
table lookups select values of 16 to 32 significant bits (uint32 genome
coordinates, int32 counts, float32 table factors), so every one must be
bit-exact at the widths the cascade uses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gmap_gsnap.align import gsnap_gapped, gsnap_se
from gmap_gsnap.ops import maxent

B = 16


def _values(rng, dtype, shape):
    if dtype == "uint32":   # full 32-bit range: most values exceed 2^24
        return rng.integers(0, 2**32, shape, dtype=np.uint32)
    if dtype == "uint32_16":  # just above 2^16
        return rng.integers(2**16, 2**17, shape).astype(np.uint32)
    if dtype == "int32":
        return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    if dtype == "bool":
        return rng.random(shape) < 0.5
    t = maxent._tables_np()["acc_score1_plus"].astype(np.float32)
    return t[rng.integers(0, len(t), shape)]


@pytest.mark.parametrize("dtype", ["uint32", "uint32_16", "int32", "bool",
                                   "float32"])
@pytest.mark.parametrize("ncand,trail", [(32, ()), (128, ()), (32, (101,))])
def test_gather_pair_exact(dtype, ncand, trail):
    rng = np.random.default_rng(ncand + len(trail))
    arr = _values(rng, dtype, (B, ncand) + trail)
    idx = rng.integers(0, ncand, (B, 16)).astype(np.int32)
    got = np.asarray(jax.jit(gsnap_gapped._gather_pair)(
        jnp.asarray(arr), jnp.asarray(idx)))
    want = arr[np.arange(B)[:, None], idx]
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("kind", ["donor", "acceptor", "antidonor",
                                  "antiacceptor"])
def test_maxent_table_gathers_exact(kind):
    """The splice solvers look factors up as tables[name][idx] at the
    top candidate positions; the float32 factors must come back
    unrounded."""
    rng = np.random.default_rng(1)
    tables = maxent._tables_jnp()
    for name, _ in maxent._MODELS[kind]:
        t = maxent._tables_np()[name].astype(np.float32)
        idx = rng.integers(0, len(t), (B, 16, 16)).astype(np.int32)
        got = np.asarray(jax.jit(lambda i: tables[name][i])(jnp.asarray(idx)))
        assert np.array_equal(got, t[idx]), name


def test_lane_prefix_counts_match_masks():
    """_lane_features reads [B]-indexed mismatch counts from the prefix
    array; they must equal the masked sums they stand for."""
    rng = np.random.default_rng(2)
    K, L = 8, 100
    mm = rng.random((B, K, L)) < 0.1
    lengths = rng.integers(20, L + 1, B).astype(np.int32)
    mm &= np.arange(L)[None, None, :] < lengths[:, None, None]
    pref = np.concatenate([np.zeros((B, K, 1), np.int32),
                           np.cumsum(mm, axis=2, dtype=np.int32)], axis=2)
    k, interval = 15, 3
    f = gsnap_gapped._lane_features(jnp.asarray(mm), jnp.asarray(pref), None,
                                    jnp.asarray(lengths), k, interval, -3)

    def count_below(idx):  # mismatches at positions < idx, per row
        return (mm & (np.arange(L)[None, None, :] < idx[:, None, None])).sum(2)

    spansize = -(-k // interval) * interval
    lastpos = lengths - k
    mtl = np.minimum(spansize + interval - 1, lengths // 2)
    assert np.array_equal(np.asarray(f["lane_lbc"]),
                          count_below(np.maximum(lastpos - interval - 1, 0)))
    assert np.array_equal(np.asarray(f["lane_cle"]), count_below(mtl + 1))
    assert np.array_equal(np.asarray(f["lane_clt"]),
                          count_below(lengths - mtl))


def test_rank_hits_moves_wide_coordinates_exactly():
    """rank_hits permutes every field through one composed permutation;
    genome coordinates above 2^24 must survive it bit for bit."""
    rng = np.random.default_rng(3)
    n = 64
    left = rng.integers(2**24, 2**32 - 2**20, (B, n), dtype=np.uint32)
    out = {
        "kind": np.zeros((B, n), np.int32),
        "score": rng.integers(0, 4, (B, n)).astype(np.int32),
        "nmm": rng.integers(0, 4, (B, n)).astype(np.int32),
        "left": left, "right": left + np.uint32(1000), "mid": left,
        "split": np.zeros((B, n), np.int32),
        "split2": np.zeros((B, n), np.int32),
        "nindels": np.zeros((B, n), np.int32),
        "sense": np.ones((B, n), bool),
        "prob_d": rng.random((B, n)).astype(np.float32),
        "prob_a": rng.random((B, n)).astype(np.float32),
        "plusp": rng.random((B, n)) < 0.5,
    }
    final = gsnap_gapped.rank_hits({k: jnp.asarray(v) for k, v in out.items()},
                                   gsnap_se.GsnapParams())
    fl = np.asarray(final["left"])
    fpd = np.asarray(final["prob_d"])
    for b in range(B):
        ok = np.arange(fl.shape[1]) < int(final["npaths"][b])
        assert ok.sum() > 0
        src = {int(x): i for i, x in enumerate(left[b])}
        for x, p in zip(fl[b][ok], fpd[b][ok]):
            i = src[int(x)]
            assert out["prob_d"][b, i] == p
        # ranked by (score, left) ascending among the kept hits
        keys = list(zip(np.asarray(final["score"])[b][ok], fl[b][ok]))
        assert keys == sorted(keys)
