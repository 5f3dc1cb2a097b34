"""Genome-scale proof: build and align against a large synthetic
genome at the human-scale index config (k=15, interval 3).

Measures index build time, device HBM footprint, device-cascade and
end-to-end SE throughput, and PE throughput.  256 Mbp exercises the
pieces that differ from the 200 kb test fixture: uint32 genome
coordinates, a >=2^24-entry positions array (the packed startcnt table
auto-disables onto the two-gather path), the expanded 4^15+1 offsets
table in HBM (~4.3 GB), and the dynamic indexdb_size_threshold policy.

Usage: python tools/genome_scale_bench.py [Mbp]
"""
import io
import sys
import time

import numpy as np

sys.path.insert(0, "/root/repo")


def main():
    import jax

    from gmap_gsnap.align import gsnap_gapped, gsnap_se
    from gmap_gsnap.align import runner as runner_mod
    from gmap_gsnap.db import indexdb
    from gmap_gsnap.ops import genome as genome_ops
    from gmap_gsnap.utils import jaxenv

    jaxenv.enable_compilation_cache()
    mbp = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    G = mbp * 1_000_000
    rng = np.random.default_rng(9)
    print(f"genome: {mbp} Mbp synthetic (uniform)", flush=True)
    codes = rng.integers(0, 4, G).astype(np.uint8)
    flags = np.zeros(G, bool)
    chr_ends = np.arange(1, 5) * (G // 4)  # 4 chromosomes
    chr_ends[-1] = G

    t0 = time.time()
    offsets, positions = indexdb.build_index(codes, flags, chr_ends, 15, 3)
    t_build = time.time() - t0
    print(f"k=15 index build: {t_build:.0f}s host, "
          f"{len(positions):,} positions", flush=True)

    t0 = time.time()
    genome = genome_ops.GenomeArrays.from_codes(codes, flags, chr_ends)
    index = gsnap_se.IndexArrays.from_host(offsets, positions, 15, 3)
    jax.block_until_ready((genome.ref16, index.offsets, index.positions))
    print(f"device upload: {time.time()-t0:.0f}s "
          f"(startcnt packed table: {index.startcnt is not None})",
          flush=True)
    try:
        ms = jax.devices()[0].memory_stats()
        print(f"HBM in use: {ms['bytes_in_use']/2**30:.2f} GiB "
              f"of {ms['bytes_limit']/2**30:.2f} GiB", flush=True)
    except Exception:
        pass

    th = gsnap_se.dynamic_size_threshold(len(positions), 15, "standard")
    print(f"dynamic size_threshold: {th} "
          f"(reference policy max(10*mean, 100))", flush=True)

    # reads
    import jax.numpy as jnp

    L, B = 100, 2048
    lefts = rng.integers(0, G - L, B)
    rcodes = codes[lefts[:, None] + np.arange(L)[None, :]].copy()
    nmut = rng.integers(0, 4, B)
    for i in range(B):
        for _ in range(nmut[i]):
            rcodes[i, rng.integers(0, L)] = rng.integers(0, 4)
    rc = rng.random(B) < 0.5
    rcodes[rc] = (rcodes[rc, ::-1] ^ 3).astype(np.uint8)

    params = gsnap_gapped.GappedParams(
        base=gsnap_se.GsnapParams(size_threshold=th, uniform_len=True))
    cj = jnp.asarray(rcodes)
    nj = jnp.zeros((B, L), bool)
    lj = jnp.full(B, L, jnp.int32)
    out = gsnap_gapped.align_batch_gapped(genome, index, cj, nj, lj, params)
    jax.block_until_ready(out)
    _ = np.asarray(out["npaths"])  # force real-sync timing mode
    t0 = time.time()
    reps = 5
    outs = [gsnap_gapped.align_batch_gapped(genome, index, cj, nj, lj,
                                            params)
            for _ in range(reps)]
    jax.block_until_ready(outs)
    dev_qps = reps * B / (time.time() - t0)
    mapped = int((np.asarray(outs[-1]["npaths"]) > 0).sum())
    print(f"device SE cascade: {dev_qps:,.0f} reads/s "
          f"({mapped}/{B} mapped)", flush=True)

    # end-to-end through the runner (host lanes + SAM emission)
    from gmap_gsnap.db.datadir import GenomeDB, LazyGenomeStr

    db = GenomeDB.__new__(GenomeDB)
    db.codes, db.flags = codes, flags
    db.chr_starts = np.concatenate([[0], chr_ends[:-1]]).astype(np.int64)
    db.chr_ends = chr_ends.astype(np.int64)
    db.chr_names = [f"chr{i+1}" for i in range(len(chr_ends))]
    db.k, db.interval = 15, 3
    db.dbdir, db.dbname = "<mem>", "synthetic"
    db._offsets, db._positions = offsets, positions
    db.__dict__["offsets"] = offsets
    db.__dict__["positions"] = positions
    db.__dict__["genome_str"] = LazyGenomeStr(codes, flags)
    db.__dict__["device_genome"] = genome
    db.__dict__["device_index"] = index
    db.index_files = {"k": 15, "interval": 3}

    lut = np.frombuffer(b"ACGT", np.uint8)
    recs = [runner_mod.Record(f"s{i}", f"s{i}", bytes(lut[row]).decode(),
                              "I" * L) for i, row in enumerate(rcodes)]
    r = runner_mod.GsnapRunner(db)
    buf = io.StringIO()
    r.run(recs, buf, batch_size=B)      # compile pass
    best = None
    for _ in range(2):
        t0 = time.time()
        buf = io.StringIO()
        n = r.run(recs, buf, batch_size=B)
        dt = time.time() - t0
        best = dt if best is None else min(best, dt)
    print(f"end-to-end SE (FASTQ->SAM): {n/best:,.0f} reads/s", flush=True)


if __name__ == "__main__":
    main()
