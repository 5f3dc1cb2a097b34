"""Scale-out tests on the virtual 8-device CPU mesh: sharded batches
match single-device results; the sharded-index lookup pattern works."""

import numpy as np
import pytest

FIXTURE = "/root/reference/tests/ss.chr17test"


@pytest.fixture(scope="module")
def db():
    from gmap_gsnap.align import gsnap_se
    from gmap_gsnap.db import build, indexdb
    from gmap_gsnap.ops import genome as genome_ops

    g = build.load_genome_fasta([FIXTURE])
    genome = genome_ops.GenomeArrays.from_codes(g.codes, g.flags, g.chr_ends)
    offsets, positions = indexdb.build_index(g.codes, g.flags, g.chr_ends, 12, 3)
    index = gsnap_se.IndexArrays.from_host(offsets, positions, 12, 3)
    return genome, index, g


def test_sharded_alignment_matches_single_device(db):
    import jax
    import jax.numpy as jnp

    from gmap_gsnap.align import gsnap_gapped as gg
    from gmap_gsnap.parallel import shard

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")

    genome, index, g = db
    rng = np.random.default_rng(7)
    B, L = 64, 80
    lefts = rng.integers(0, len(g.codes) - L, B)
    codes = np.stack([g.codes[l : l + L] for l in lefts]).astype(np.uint8)
    for b in range(B):
        for _ in range(rng.integers(0, 3)):
            codes[b, rng.integers(0, L)] = rng.integers(0, 4)
    nflags = np.zeros((B, L), bool)
    lengths = np.full(B, L, np.int32)

    params = gg.GappedParams()
    single = gg.align_batch_gapped(
        genome, index, jnp.asarray(codes), jnp.asarray(nflags),
        jnp.asarray(lengths), params,
    )
    single = {k: np.asarray(v) for k, v in single.items()}

    mesh = shard.reads_mesh()
    genome_r, index_r, _, _, _ = shard.place(mesh, genome, index)
    c, f, l = shard.shard_reads(
        mesh, jnp.asarray(codes), jnp.asarray(nflags), jnp.asarray(lengths)
    )
    multi = gg.align_batch_gapped(genome_r, index_r, c, f, l, params)
    multi = {k: np.asarray(v) for k, v in multi.items()}

    for k in single:
        assert np.array_equal(single[k], multi[k]), k


def test_pad_batch_and_part(db):
    from gmap_gsnap.parallel import shard

    codes = np.zeros((13, 50), np.uint8)
    nflags = np.zeros((13, 50), bool)
    lengths = np.full(13, 50, np.int32)
    c, f, l, b = shard.pad_batch(8, codes, nflags, lengths)
    assert c.shape[0] == 16 and b == 13
    assert (l[13:] == 0).all() and f[13:].all()

    idx = shard.part_indices(1, 3, 10)
    assert list(idx) == [1, 4, 7]


def test_sharded_index_lookup(db):
    import jax.numpy as jnp

    from gmap_gsnap.parallel import shard

    _, index, _ = db
    pos = np.asarray(index.positions)
    nshards = 4
    shard_len = -(-len(pos) // nshards)
    padded = np.concatenate(
        [pos, np.zeros(nshards * shard_len - len(pos), np.uint32)]
    ).reshape(nshards, shard_len)

    rng = np.random.default_rng(3)
    starts = rng.integers(0, len(pos) - 8, 32).astype(np.int32)
    counts = rng.integers(1, 8, 32).astype(np.int32)
    out = np.asarray(shard.shard_index_lookup(
        jnp.asarray(padded), jnp.asarray(starts), jnp.asarray(counts),
        cap=8, nshards=nshards,
    ))
    for i, (s, c) in enumerate(zip(starts, counts)):
        want = pos[s : s + c]
        got = out[i][out[i] != 0xFFFFFFFF]
        # entries that cross a shard boundary wrap within the owner
        # shard; only verify the in-shard prefix (the all-gather pattern)
        inshard = min(c, shard_len - (s % shard_len))
        assert np.array_equal(got[:inshard], want[:inshard])


def test_sharded_index_seeding_matches_replicated():
    """Index sharding wired for real: the sharded-positions seeding
    (pmin-combined shard_map) must equal the replicated-index seeding,
    and the FULL pipeline run with a sharded index must match the
    replicated run end to end."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from gmap_gsnap.align import gsnap_gapped, gsnap_se
    from gmap_gsnap.db import build, indexdb
    from gmap_gsnap.ops import genome as genome_ops
    from gmap_gsnap.parallel import shard

    g = build.load_genome_fasta(["/root/reference/tests/ss.chr17test"])
    genome = genome_ops.GenomeArrays.from_codes(g.codes, g.flags, g.chr_ends)
    offsets, positions = indexdb.build_index(g.codes, g.flags, g.chr_ends, 12, 3)
    index = gsnap_se.IndexArrays.from_host(offsets, positions, 12, 3)

    mesh = shard.reads_mesh()
    sharded = shard.ShardedIndexArrays.from_index(mesh, index)

    rng = np.random.default_rng(3)
    B, L = 32, 100
    lefts = rng.integers(0, len(g.codes) - L, B)
    codes = g.codes[lefts[:, None] + np.arange(L)[None, :]].copy()
    for i in range(B):
        for _ in range(int(rng.integers(0, 3))):
            codes[i, rng.integers(0, L)] = rng.integers(0, 4)
    nflags = np.zeros((B, L), bool)
    lengths = np.full(B, L, np.int32)

    params = gsnap_gapped.GappedParams()
    out_rep = gsnap_gapped.align_batch_gapped(
        genome, index, jnp.asarray(codes), jnp.asarray(nflags),
        jnp.asarray(lengths), params)
    out_sh = gsnap_gapped.align_batch_gapped(
        genome, sharded, jnp.asarray(codes), jnp.asarray(nflags),
        jnp.asarray(lengths), params)
    for k in ("npaths", "left", "kind", "score", "nmm"):
        assert np.array_equal(np.asarray(out_rep[k]), np.asarray(out_sh[k])), k
