"""Where does a steady-state run_pe batch spend time?  Wraps the
runner's fetch/dispatch entry points with timers on the bench workload."""
import io
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

    jaxenv.enable_compilation_cache()
    tmp = tempfile.mkdtemp()
    dbdir = build.build_db(
        ["/root/reference/tests/ss.chr17test"], "chr17test", tmp, k=12)
    db = GenomeDB.open(dbdir, "chr17test")
    seq = db.genome_str
    L, BATCH = bench.L, bench.BATCH
    runner = runner_mod.GsnapRunner(db)
    rng = np.random.default_rng(7)
    npairs = 8192
    r5, r3 = bench.make_pe_workload(seq, npairs, rng)
    recs5 = [runner_mod.Record(f"b{i}", f"b{i}", s, "I" * L)
             for i, s in enumerate(r5)]
    recs3 = [runner_mod.Record(f"b{i}", f"b{i}", s, "I" * L)
             for i, s in enumerate(r3)]
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
                 "prefetch_gmap", "_prime_rows"):
        wrap(runner, name)

    out = io.StringIO()
    t0 = time.time()
    n = runner.run_pe(recs5, recs3, out, batch_size=BATCH)
    dt = time.time() - t0
    print(f"PE: {n} pairs in {dt:.3f}s = {n/dt:.1f} pairs/s")
    print("batch times:", [(round(t, 3), n_) for t, n_ in runner.batch_times])
    for k, (tot, cnt) in sorted(stats.items(), key=lambda x: -x[1][0]):
        print(f"  {k:22s} {tot:7.3f}s over {cnt} calls")


if __name__ == "__main__":
    main()
