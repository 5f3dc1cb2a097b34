"""Profile the end-to-end SE/PE paths on the bench workloads.

Usage: python tools/profile_e2e.py [se|pe|gmap] [--cprofile]
Mirrors bench.py's workload construction exactly.
"""
import cProfile
import io
import pstats
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, "/root/repo")


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "se"
    use_cprofile = "--cprofile" in sys.argv

    from gmap_gsnap.align import runner as runner_mod
    from gmap_gsnap.db import build
    from gmap_gsnap.db.datadir import GenomeDB
    from gmap_gsnap.utils import jaxenv
    import bench

    jaxenv.enable_compilation_cache()
    tmp = tempfile.mkdtemp()
    dbdir = build.build_db(
        ["/root/reference/tests/ss.chr17test"], "chr17test", tmp, k=12)
    db = GenomeDB.open(dbdir, "chr17test")
    seq = db.genome_str
    L = bench.L
    BATCH = bench.BATCH
    runner = runner_mod.GsnapRunner(db)

    if which == "pe":
        rng = np.random.default_rng(7)
        npairs = 8192
        r5, r3 = bench.make_pe_workload(seq, npairs, rng)
        recs5 = [runner_mod.Record(f"b{i}", f"b{i}", s, "I" * L)
                 for i, s in enumerate(r5)]
        recs3 = [runner_mod.Record(f"b{i}", f"b{i}", s, "I" * L)
                 for i, s in enumerate(r3)]
        runner.warmup(batch_size=min(BATCH, npairs), pe=True)
        out = io.StringIO()
        t0 = time.time()
        if use_cprofile:
            pr = cProfile.Profile()
            pr.enable()
        n = runner.run_pe(recs5, recs3, out, batch_size=BATCH)
        if use_cprofile:
            pr.disable()
        dt = time.time() - t0
        print(f"PE: {n} pairs in {dt:.3f}s = {n/dt:.1f} pairs/s")
        print("batch times:", [(round(t, 3), n_) for t, n_ in runner.batch_times])
        if use_cprofile:
            st = pstats.Stats(pr)
            st.sort_stats("cumulative").print_stats(40)
    elif which == "se":
        rng = np.random.default_rng(42)
        nreads = 4096
        code_of = np.zeros(256, np.uint8)
        for i, c in enumerate(b"ACGT"):
            code_of[c] = i
        gcodes = code_of[seq.ascii]
        lefts = rng.integers(0, len(seq) - L, nreads)
        codes = gcodes[lefts[:, None] + np.arange(L)[None, :]].copy()
        nmut = rng.integers(0, 4, nreads)
        for i in range(nreads):
            for _ in range(nmut[i]):
                codes[i, rng.integers(0, L)] = rng.integers(0, 4)
        rc = rng.random(nreads) < 0.5
        codes[rc] = (codes[rc, ::-1] ^ 3).astype(np.uint8)
        lut = np.frombuffer(b"ACGT", np.uint8)
        se_recs = [
            runner_mod.Record(f"s{i}", f"s{i}", bytes(lut[row]).decode(),
                              "I" * L)
            for i, row in enumerate(codes)
        ]
        out = io.StringIO()
        runner.run(se_recs[:min(BATCH, nreads)], out,
                   batch_size=min(BATCH, nreads))  # warmup
        out = io.StringIO()
        t0 = time.time()
        if use_cprofile:
            pr = cProfile.Profile()
            pr.enable()
        n = runner.run(se_recs, out, batch_size=BATCH)
        if use_cprofile:
            pr.disable()
        dt = time.time() - t0
        print(f"SE: {n} reads in {dt:.3f}s = {n/dt:.1f} reads/s")
        print("batch times:", [(round(t, 3), n_) for t, n_ in runner.batch_times])
        if use_cprofile:
            st = pstats.Stats(pr)
            st.sort_stats("cumulative").print_stats(40)
    elif which == "gmap":
        from gmap_gsnap.align import gmap as gmap_mod
        rng = np.random.default_rng(7)
        queries = bench.make_gmap_workload(seq, 64, rng)
        gmap_mod.align_cdna_batch(db, queries)  # warmup
        t0 = time.time()
        if use_cprofile:
            pr = cProfile.Profile()
            pr.enable()
        paths = gmap_mod.align_cdna_batch(db, queries)
        if use_cprofile:
            pr.disable()
        dt = time.time() - t0
        print(f"GMAP: {len(queries)} queries in {dt:.3f}s = "
              f"{len(queries)/dt:.1f} q/s")
        if use_cprofile:
            st = pstats.Stats(pr)
            st.sort_stats("cumulative").print_stats(40)


if __name__ == "__main__":
    main()
