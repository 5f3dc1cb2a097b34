"""Count why SE rows fall off the fast path on the bench workload."""
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, "/root/repo")

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
runner = runner_mod.GsnapRunner(db)

rng = np.random.default_rng(42)
nreads = 2048
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
recs = [runner_mod.Record(f"s{i}", f"s{i}", bytes(lut[row]).decode(), "I" * L)
        for i, row in enumerate(codes)]

res = runner.fetch_records(runner.dispatch_records(recs))
np_a = np.asarray(res["npaths"])[:nreads]
done_a = runner._se_done_level(recs, res)
noop_a = np.asarray(res.get("lane_noop", np.zeros(nreads, bool)))[:nreads]
ovf = np.asarray(res.get("overflow", np.zeros(nreads, bool)))[:nreads]
KTOP = runner_mod.PAIR_KTOP
print(f"nreads          : {nreads}")
print(f"np==0           : {(np_a == 0).sum()}")
print(f"np>KTOP({KTOP})    : {(np_a > KTOP).sum()}")
print(f"done>=2         : {(done_a >= 2).sum()}")
print(f"done>=2 & ~noop : {((done_a >= 2) & ~noop_a).sum()}")
print(f"noop            : {noop_a.sum()}")
print(f"overflow        : {ovf.sum()}")
need_full = ((np_a == 0) | (np_a > KTOP) | ((done_a >= 2) & ~noop_a))
print(f"need_full       : {need_full.sum()}")
print(f"np==1           : {(np_a == 1).sum()}")
fast = (np_a == 1) & ~need_full & ~ovf
print(f"fast path       : {fast.sum()}")
# distribution of done level among non-noop
for d in range(0, 7):
    sel = (done_a == d)
    print(f"  done=={d}: n={sel.sum()} noop={noop_a[sel].sum()} "
          f"np>1={(np_a[sel] > 1).sum()}")

# --- overflow split + does the wide rerun change anything? ---
tr = np.asarray(res.get("overflow_trunc", np.zeros(nreads, bool)))[:nreads]
print(f"overflow_trunc  : {(ovf & tr).sum()}  (fullwide lane)")
print(f"overflow_cand   : {(ovf & ~tr).sum()}  (widecand lane)")
rows = np.flatnonzero(ovf)
if len(rows):
    t0 = time.time()
    sub = [recs[int(j)] for j in rows]
    wres = runner.fetch_records(runner._dispatch_wide(sub, widen_seeds=True))
    print(f"wide rerun of {len(rows)} rows: {time.time()-t0:.2f}s")
    wn = np.asarray(wres["npaths"])[:len(rows)]
    ws = np.asarray(wres["score"])[:len(rows), 0]
    wl = np.asarray(wres["left"])[:len(rows), 0]
    on = np_a[rows]; os_ = np.asarray(res["score"])[rows, 0]
    ol = np.asarray(res["left"])[rows, 0]
    changed = (wn != on) | (ws != os_) | (wl != ol)
    print(f"wide changed np/score/left for {changed.sum()}/{len(rows)} rows")
    ch = np.flatnonzero(changed)[:10]
    for j in ch:
        print(f"  row {rows[j]}: np {on[j]}->{wn[j]} score {os_[j]}->{ws[j]}"
              f" left {ol[j]}->{wl[j]}")
