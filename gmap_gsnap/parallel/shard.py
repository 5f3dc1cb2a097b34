"""Multi-device scale-out for the alignment pipelines.

The reference's entire parallelism inventory is data parallelism over
reads: a pthread worker pool around a mutex inbuffer (gsnap.c:2432-2487,
inbuffer.c:492) plus `--part i/n` modulus sharding of the input across
processes (gsnap.c:999-1028).  The device mapping (SURVEY.md section 2.7):

  * read batches shard over a 1-D device mesh axis ("reads");
  * genome + k-mer index replicate into every device's memory — the moral
    equivalent of the reference's shared read-only mmap;
  * alignment is embarrassingly parallel per read, so the jit'ed
    pipeline partitions with zero collectives; results come back
    sequence-ordered because array order IS input order (the
    Outbuffer_thread_ordered semantics, outbuffer.c:1949, for free);
  * `--part i/n` keeps its host-level meaning for multi-host runs.

Index sharding (for genomes whose positions array outgrows one HBM) is
expressed with the same API: shard positions over the mesh and
all-gather candidate diagonals per read — see shard_index_lookup.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def reads_mesh(n_devices: int | None = None) -> Mesh:
    """A 1-D mesh over the 'reads' axis (data parallel)."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), axis_names=("reads",))


def place(mesh: Mesh, genome, index, index_minus=None, alt=None, known=None):
    """Replicate the database (genome + index (+ alt/known)) into every
    device's HBM."""
    repl = NamedSharding(mesh, P())
    put = lambda x: None if x is None else jax.device_put(x, repl)
    return (
        put(genome),
        put(index),
        put(index_minus),
        None if alt is None else tuple(put(a) for a in alt),
        None if known is None else tuple(put(k) for k in known),
    )


def shard_reads(mesh: Mesh, *arrays):
    """Shard per-read arrays (leading axis) over the mesh; the batch
    must divide the device count (runners pad batches to a multiple)."""
    dp = NamedSharding(mesh, P("reads"))
    return tuple(jax.device_put(a, dp) for a in arrays)


def pad_batch(n_devices: int, codes, nflags, lengths):
    """Pad a read batch to a multiple of the mesh size with empty reads
    (length 0 -> they produce no hits and are dropped by the caller)."""
    b = codes.shape[0]
    pad = (-b) % n_devices
    if pad == 0:
        return codes, nflags, lengths, b
    codes = np.concatenate([codes, np.zeros((pad,) + codes.shape[1:], codes.dtype)])
    nflags = np.concatenate(
        [nflags, np.ones((pad,) + nflags.shape[1:], nflags.dtype)]
    )
    lengths = np.concatenate([lengths, np.zeros(pad, lengths.dtype)])
    return codes, nflags, lengths, b


def part_indices(i: int, n: int, total: int) -> np.ndarray:
    """gsnap --part=i/n input sharding (modulus over record ids,
    gsnap.c:999-1028)."""
    return np.arange(i, total, n)


@partial(jax.jit, static_argnames=("cap", "nshards"))
def shard_index_lookup(positions_sharded, starts, counts, cap: int, nshards: int):
    """Sharded-index lookup pattern: each shard holds a slice of the
    positions array; per-read candidate lists are fetched from the
    owning shard and all-gathered.  Exercised by tests on a CPU mesh as
    the blueprint for genomes whose index exceeds one HBM."""
    # positions_sharded: [nshards, shard_len]; starts/counts per (read,)
    shard_len = positions_sharded.shape[1]
    owner = (starts // shard_len).astype(jnp.int32)
    local = starts % shard_len
    j = jnp.arange(cap, dtype=jnp.int32)[None, :]
    idx = jnp.clip(local[:, None] + j, 0, shard_len - 1)
    vals = positions_sharded[jnp.clip(owner, 0, nshards - 1)[:, None],
                             idx]
    ok = j < counts[:, None]
    return jnp.where(ok, vals, jnp.uint32(0xFFFFFFFF))


# ------------------------------------------------------- sharded k-mer index

@jax.tree_util.register_pytree_node_class
class ShardedIndexArrays:
    """K-mer positional index with the positions array SHARDED over the
    mesh (for genomes whose index outgrows one HBM; SURVEY.md 2.7
    "shard positions arrays + all-gather candidate lists").

    positions2d: uint32[nshards, shard_len], shard s owning global
    elements [s*shard_len, (s+1)*shard_len); placed with
    NamedSharding(mesh, P('reads', None)) so each device holds one row.
    offsets stay replicated (they are 4^k+1 entries — the positions
    array is the one that scales with genome size).
    """

    def __init__(self, offsets, positions2d, k, interval, mesh):
        self.offsets = offsets
        self.positions2d = positions2d
        self.k = int(k)
        self.interval = int(interval)
        self.mesh = mesh

    def tree_flatten(self):
        return (self.offsets, self.positions2d), (self.k, self.interval,
                                                  self.mesh)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], children[1], aux[0], aux[1], aux[2])

    @classmethod
    def from_index(cls, mesh: Mesh, index):
        """Shard a replicated IndexArrays over the mesh."""
        n = mesh.devices.size
        pos = np.asarray(index.positions)
        shard_len = -(-len(pos) // n)
        shard_len += (-shard_len) % 8  # keep 8-wide row alignment
        pad = n * shard_len - len(pos)
        pos = np.concatenate([pos, np.zeros(pad, np.uint32)])
        pos2d = pos.reshape(n, shard_len)
        sharded = jax.device_put(
            jnp.asarray(pos2d), NamedSharding(mesh, P("reads", None)))
        offsets = jax.device_put(
            index.offsets, NamedSharding(mesh, P()))
        return cls(offsets, sharded, index.k, index.interval, mesh)


def sharded_seed_diagonals(index: "ShardedIndexArrays", gpos, qpos,
                           valid_slot):
    """Compact-grid seeding against a sharded positions array: the
    rank->global-index mapping (gsnap_se._seed_rank_map, computed from
    the replicated offsets) arrives precomputed; every device resolves
    the slots whose global element lives in ITS positions shard and the
    per-slot diagonals combine with a pmin collective (INVALID_DIAG is
    the identity, and each global element is owned by exactly one
    shard) — the all-gather-of-candidates pattern over the device links.

    Matches the unsharded diag output of gsnap_se._seed_diagonals
    exactly.
    """
    from jax import shard_map

    from ..align.gsnap_se import INVALID_DIAG

    mesh = index.mesh
    nshards, shard_len = index.positions2d.shape

    def local(pos_shard, gpos, qpos, valid_slot):
        # pos_shard [1, shard_len]; this device owns global elements
        # [s0, s0 + shard_len)
        sid = jax.lax.axis_index("reads")
        s0 = sid.astype(jnp.int32) * shard_len
        lidx = gpos - s0
        inshard = (lidx >= 0) & (lidx < shard_len)
        pos = pos_shard.reshape(-1)[jnp.clip(lidx, 0, shard_len - 1)]
        qp = qpos.astype(jnp.uint32)
        ok = valid_slot & inshard & (pos >= qp)
        diag = jnp.where(ok, pos - qp, INVALID_DIAG)
        # each global element is owned by one shard: min-combine
        return jax.lax.pmin(diag, "reads")

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P("reads", None), P(), P(), P()),
        out_specs=P(),
    )
    return fn(index.positions2d, gpos, qpos, valid_slot)
