"""Find where SE end-to-end time goes: wrap the rescue-lane entry
points with timers and count calls/compiles."""

import io
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, "/root/repo")


def main():
    import jax

    from gmap_gsnap.align import runner as runner_mod
    from gmap_gsnap.db import build
    from gmap_gsnap.db.datadir import GenomeDB
    from gmap_gsnap.utils import jaxenv

    jaxenv.enable_compilation_cache()

    tmp = tempfile.mkdtemp()
    dbdir = build.build_db(
        ["/root/reference/tests/ss.chr17test"], "chr17test", tmp, k=12)
    db = GenomeDB.open(dbdir, "chr17test")
    seq = db.genome_str

    L = 100
    NSE = 1024
    BATCH = 256
    code_of = np.zeros(256, np.uint8)
    for i, c in enumerate(b"ACGT"):
        code_of[c] = i
    gcodes = code_of[seq.ascii]
    rng = np.random.default_rng(42)
    lefts = rng.integers(0, len(seq) - L, NSE)
    codes = gcodes[lefts[:, None] + np.arange(L)[None, :]].copy()
    nmut = rng.integers(0, 4, NSE)
    for i in range(NSE):
        for _ in range(nmut[i]):
            codes[i, rng.integers(0, L)] = rng.integers(0, 4)
    rc = rng.random(NSE) < 0.5
    codes[rc] = (codes[rc, ::-1] ^ 3).astype(np.uint8)
    lut = np.frombuffer(b"ACGT", np.uint8)
    se_recs = [
        runner_mod.Record(f"s{i}", f"s{i}", bytes(lut[row]).decode(), "I" * L)
        for i, row in enumerate(codes)
    ]
    runner = runner_mod.GsnapRunner(db)

    stats = {}

    def wrap(obj, name):
        fn = getattr(obj, name)

        def wrapped(*a, **kw):
            t0 = time.time()
            r = fn(*a, **kw)
            dt = time.time() - t0
            tot, cnt, mx = stats.get(name, (0.0, 0, 0.0))
            stats[name] = (tot + dt, cnt + 1, max(mx, dt))
            return r
        setattr(obj, name, wrapped)

    for name in ("prefetch_gmap", "_dispatch_wide", "fetch_records",
                 "fetch_record_rows", "dispatch_records", "_se_sam_fast",
                 "sam_records", "_se_done_level"):
        wrap(runner, name)

    out = io.StringIO()
    t0 = time.time()
    runner.run(se_recs[:BATCH], out)
    print(f"warmup: {time.time()-t0:.1f} s")
    for k, (tot, cnt, mx) in sorted(stats.items(), key=lambda x: -x[1][0]):
        print(f"  {k}: {tot:.2f}s over {cnt} calls (max {mx:.2f}s)")
    stats.clear()

    t0 = time.time()
    out = io.StringIO()
    runner.run(se_recs, out, batch_size=BATCH)
    dt = time.time() - t0
    print(f"SE e2e: {NSE/dt:.0f} reads/s  ({dt:.2f} s total)")
    for k, (tot, cnt, mx) in sorted(stats.items(), key=lambda x: -x[1][0]):
        print(f"  {k}: {tot:.2f}s over {cnt} calls (max {mx:.2f}s)")

    # second pass: everything should be warm now
    stats.clear()
    t0 = time.time()
    out = io.StringIO()
    runner.run(se_recs, out, batch_size=BATCH)
    dt = time.time() - t0
    print(f"SE e2e pass2: {NSE/dt:.0f} reads/s  ({dt:.2f} s total)")
    for k, (tot, cnt, mx) in sorted(stats.items(), key=lambda x: -x[1][0]):
        print(f"  {k}: {tot:.2f}s over {cnt} calls (max {mx:.2f}s)")


if __name__ == "__main__":
    main()
