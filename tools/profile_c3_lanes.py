"""Config-3 (PE novel splicing) lane profile: where does run_pe spend
time on the spliced workload?  Same wrapping approach as
profile_pe_lanes.py but with novelsplicing=True and the spliced
workload from bench_workloads."""
import cProfile
import io
import pstats
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, "/root/repo")


def main():
    from gmap_gsnap.align import runner as runner_mod
    from gmap_gsnap.db import build
    from gmap_gsnap.db.datadir import GenomeDB
    from gmap_gsnap.utils import jaxenv
    import bench
    import bench_workloads as bw

    jaxenv.enable_compilation_cache()
    tmp = tempfile.mkdtemp()
    dbdir = build.build_db(
        ["/root/reference/tests/ss.chr17test"], "chr17test", tmp, k=12)
    db = GenomeDB.open(dbdir, "chr17test")
    seq = db.genome_str
    seq = seq[0 : len(seq)]
    L, BATCH = bench.L, bench.BATCH
    rng = np.random.default_rng(7)
    npairs = 4096
    jx = bw.find_junctions(seq)
    r5s, r3s = bw.make_pe_splice_workload(seq, npairs, rng, jx)
    recs5 = [runner_mod.Record(f"s{i}", f"s{i}", s, "I" * L)
             for i, s in enumerate(r5s)]
    recs3 = [runner_mod.Record(f"s{i}", f"s{i}", s, "I" * L)
             for i, s in enumerate(r3s)]
    runner = runner_mod.GsnapRunner(db, novelsplicing=True)
    runner.warmup(batch_size=min(BATCH, npairs), pe=True)

    stats = {}

    def wrap(obj, name):
        fn = getattr(obj, name)

        def wrapped(*a, **kw):
            t0 = time.time()
            r = fn(*a, **kw)
            dt = time.time() - t0
            tot, cnt = stats.get(name, (0.0, 0))
            stats[name] = (tot + dt, cnt + 1)
            return r
        setattr(obj, name, wrapped)

    for name in ("fetch_pairs", "fetch_pair_rows", "dispatch_pairs",
                 "_dispatch_wide_pe", "_pe_sam_fast", "sam_pe_records",
                 "prefetch_gmap", "_prime_rows", "_hit_details",
                 "_gmap_rescue_batch", "_junction_rescue"):
        if hasattr(runner, name):
            wrap(runner, name)

    # rep 1: absorb any residual mid-run compiles; rep 2 is steady state
    n = runner.run_pe(recs5, recs3, io.StringIO(), batch_size=BATCH)
    stats.clear()
    out = io.StringIO()
    prof = cProfile.Profile()
    t0 = time.time()
    prof.enable()
    n = runner.run_pe(recs5, recs3, out, batch_size=BATCH)
    prof.disable()
    dt = time.time() - t0
    print(f"C3 PE: {n} pairs in {dt:.3f}s = {n/dt:.1f} pairs/s")
    if hasattr(runner, "batch_times"):
        print("batch times:",
              [(round(t, 3), n_) for t, n_ in runner.batch_times])
    for k, (tot, cnt) in sorted(stats.items(), key=lambda x: -x[1][0]):
        print(f"  {k:22s} {tot:7.3f}s over {cnt} calls")
    ps = pstats.Stats(prof)
    ps.sort_stats("cumulative")
    print("\n=== cProfile top cumulative ===")
    ps.print_stats(40)
    print("\n=== callers of blocking device->host transfers ===")
    ps.print_callers("array.py.*_value")
    ps.print_callers("_fetch_tree")
    ps.print_callers("profiler.py.*wrapper")


if __name__ == "__main__":
    main()
