"""Time each device stage of the GMAP batch pipeline separately."""
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, "/root/repo")

import jax
import jax.numpy as jnp

from gmap_gsnap.align import gmap as gmap_mod
from gmap_gsnap.align import gmap_engine
from gmap_gsnap.db import build
from gmap_gsnap.db.datadir import GenomeDB
from gmap_gsnap.utils import dna, jaxenv
import bench

jaxenv.enable_compilation_cache()
tmp = tempfile.mkdtemp()
dbdir = build.build_db(
    ["/root/reference/tests/ss.chr17test"], "chr17test", tmp, k=12)
db = GenomeDB.open(dbdir, "chr17test")
seq = db.genome_str
rng = np.random.default_rng(7)
queries = bench.make_gmap_workload(seq, 64, rng)

k = db.k
qstrs = []
for q in queries:
    qu = q.upper()
    qstrs.append(qu)
    qstrs.append(dna.revcomp_str(qu))
maxq = max(len(q) - k + 1 for q in qstrs)
Q = gmap_mod._bucket_q(maxq)
rows_b = gmap_mod._bucket(len(qstrs), lo=8)
oligos = np.zeros((rows_b, Q), np.int64)
valid = np.zeros((rows_b, Q), bool)
for i, qs in enumerate(qstrs):
    qcodes, qflags = dna.encode(qs)
    n = len(qcodes) - k + 1
    if n <= 0:
        continue
    oligos[i, :n] = dna.pack_kmers(qcodes, k)
    bad = np.convolve(qflags.astype(int), np.ones(k, int), "valid") > 0
    valid[i, :n] = ~bad
index = db.device_index
oligos_d = jnp.asarray(oligos.astype(np.int32))
valid_d = jnp.asarray(valid)
H = 8 * Q
S = 1024
print(f"rows_b={rows_b} Q={Q} H={H} S={S}")

def t(name, fn, reps=3):
    out = fn()
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(reps):
        out = fn()
        jax.block_until_ready(out)
    print(f"{name:28s} {(time.time()-t0)/reps*1000:8.1f} ms")
    return out

segs = t("seed_segments_device", lambda: gmap_engine.seed_segments_device(
    index.offsets, index.positions, oligos_d, valid_d,
    k=k, H=H, S=S, threshold=100))
dp = t("chain_scores_device", lambda: gmap_engine.chain_scores_device(
    segs["qstart"], segs["qend"], segs["diag"], segs["valid"],
    k=k, max_intronlen=1_000_000))
bt = t("chain_backtrack_device", lambda: gmap_engine.chain_backtrack_device(
    segs["qstart"], segs["qend"], segs["diag"], segs["valid"],
    dp[0], dp[1]))

t0 = time.time()
vals = gmap_engine.fetch_packed(
    list(bt) + [segs["nhits"], segs["nsegs"]])
print(f"{'fetch_packed (transfer)':28s} {(time.time()-t0)*1000:8.1f} ms")
tot = sum(int(np.prod(v.shape)) * v.dtype.itemsize for v in vals)
print(f"transfer bytes: {tot/1e6:.2f} MB")
