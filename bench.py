"""Benchmark: end-to-end GSNAP paired-end throughput (FASTQ -> SAM),
plus device-only SE and batched GMAP cDNA rates.

Primary metric (BASELINE.md: "GSNAP reads/s/chip (100 bp PE)"):
GsnapRunner.run_pe measured INPUT->SAM-text, i.e. including parsing,
host post-processing, rescue lanes and SAM emission — the same
protocol as the reference's self-reported queries/sec
(src/gsnap.c:2493-2494).

Reference numbers measured on THIS host (reference binaries built in
/tmp/refbuild, single worker thread, chr17test DB):

  gsnap -t 1 --format=sam b_1.fq b_2.fq   (4096 pairs, 100 bp,
      0-3 mutations/end, inserts 200-600, seed 7)
      -> "Processed 4096 queries in 0.55 seconds (7447.27 queries/sec)"
  gsnap -t 1 --format=sam bench.fq        (8192 SE reads, seed 42)
      -> 1460.25 queries/sec
  gmap -t 1 -f samse q.fa                 (64 spliced 3-exon cDNAs,
      seed 7) -> 45.6 queries/sec

Prints ONE JSON line {metric, value, unit, vs_baseline, extra}.
"""

import json
import sys
import time

import numpy as np


# Reference single-thread queries/sec, re-measured 2026-08-20 on THIS
# host, idle, best-of-2 (tools/measure_reference.py + /tmp/meas12
# protocol; self-reported queries/sec line, src/gsnap.c:2493-2494).
# Config 3's baseline excludes the ~4% of pairs the reference itself
# segfaults on (its own memory-corruption bugs; crash-free subset
# found by bisection) — OUR timed run includes them.
BASELINE_PE_QPS = 7347.0    # gsnap -t 1 PE substitutions (seed 7)
BASELINE_SE_QPS = 6026.0    # gsnap -t 1 SE (config 2, seed 42)
BASELINE_GMAP_QPS = 74.0    # gmap -t 1 -f samse spliced cDNAs (seed 7)
BASELINE_C3_QPS = 2841.0    # gsnap -t 1 -N 1 PE novel splicing (seed 7)
BASELINE_C4_QPS = 3127.0    # gsnap -t 1 -v snps -s ss (seed 11)
BASELINE_C5_QPS = 8031.0    # gsnap -t 1 --mode=cmet-stranded (seed 5)

NPAIRS = 8192
BATCH = 2048
L = 100


def make_pe_workload(seq, npairs, rng):
    comp = str.maketrans("ACGT", "TGCA")
    r5, r3 = [], []
    for i in range(npairs):
        p = int(rng.integers(0, len(seq) - 700))
        ins = int(rng.integers(2 * L, 600))
        a = list(seq[p : p + L])
        b = list(seq[p + ins - L : p + ins])
        for r in (a, b):
            for _ in range(int(rng.integers(0, 4))):
                r[int(rng.integers(0, L))] = "ACGT"[int(rng.integers(0, 4))]
        r5.append("".join(a))
        r3.append("".join(b).translate(comp)[::-1])
    return r5, r3


def make_gmap_workload(seq, nq, rng):
    out = []
    for i in range(nq):
        p = int(rng.integers(0, len(seq) - 30000))
        exlens = rng.integers(200, 800, 3)
        gaps = rng.integers(500, 8000, 2)
        parts = []
        g = p
        for j, el in enumerate(exlens):
            parts.append(seq[g : g + int(el)])
            g += int(el) + (int(gaps[j]) if j < 2 else 0)
        q = list("".join(parts))
        for _ in range(int(rng.integers(0, 5))):
            q[int(rng.integers(0, len(q)))] = "ACGT"[int(rng.integers(0, 4))]
        out.append("".join(q))
    return out


def main() -> int:
    import io
    import tempfile

    import jax

    if jax.devices()[0].platform != "gpu":
        print(f"bench: needs a GPU; JAX found {jax.devices()[0].platform}",
              file=sys.stderr)
        return 1
    npairs = NPAIRS
    nreads_dev = 4 * 2048
    nreads_e2e = 4096
    gmap_n = 64
    import jax.numpy as jnp

    from gmap_gsnap.align import gmap as gmap_mod
    from gmap_gsnap.align import gsnap_gapped, gsnap_se
    from gmap_gsnap.align import runner as runner_mod
    from gmap_gsnap.db import build, indexdb
    from gmap_gsnap.db.datadir import GenomeDB
    from gmap_gsnap.ops import genome as genome_ops
    from gmap_gsnap.utils import jaxenv

    jaxenv.enable_compilation_cache()

    tmp = tempfile.mkdtemp()
    dbdir = build.build_db(
        ["/root/reference/tests/ss.chr17test"], "chr17test", tmp, k=12)
    db = GenomeDB.open(dbdir, "chr17test")
    seq = db.genome_str

    # ---------------------------------------------- end-to-end PE (primary)
    rng = np.random.default_rng(7)
    r5, r3 = make_pe_workload(seq, npairs, rng)
    recs5 = [runner_mod.Record(f"b{i}", f"b{i}", s, "I" * L)
             for i, s in enumerate(r5)]
    recs3 = [runner_mod.Record(f"b{i}", f"b{i}", s, "I" * L)
             for i, s in enumerate(r3)]
    runner = runner_mod.GsnapRunner(db)
    # pre-compile EVERY lane shape (wide caps, GMAP rescue buckets,
    # dynprog junction buckets) so no compile lands in the timed region
    runner.warmup(batch_size=min(BATCH, npairs), pe=True)
    best = None
    for _rep in range(2):
        t0 = time.time()
        out = io.StringIO()
        n = runner.run_pe(recs5, recs3, out, batch_size=BATCH)
        dt = time.time() - t0
        assert n == npairs
        best = dt if best is None else min(best, dt)
    dt = best
    sam_lines = sum(1 for l in out.getvalue().splitlines()
                    if not l.startswith("@"))
    assert sam_lines >= 2 * npairs
    pe_qps = npairs / dt

    # ---------------------------------------------- device-only SE
    rng = np.random.default_rng(42)
    g = db
    genome = db.device_genome
    index = db.device_index
    nreads = nreads_dev
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
    nflags = np.zeros((nreads, L), bool)
    lengths = np.full(nreads, L, np.int32)
    params = gsnap_gapped.GappedParams(
        base=gsnap_se.GsnapParams(uniform_len=True))
    dev_batches = [
        (jnp.asarray(codes[i : i + 2048]), jnp.asarray(nflags[i : i + 2048]),
         jnp.asarray(lengths[i : i + 2048]))
        for i in range(0, nreads, 2048)
    ]
    o = gsnap_gapped.align_batch_gapped(genome, index, *dev_batches[0], params)
    jax.block_until_ready(o)
    t0 = time.time()
    reps = 3
    for _ in range(reps):
        outs = [gsnap_gapped.align_batch_gapped(genome, index, *b_, params)
                for b_ in dev_batches]
        jax.block_until_ready(outs)
    se_qps = reps * nreads / (time.time() - t0)
    mapped = int(np.asarray(outs[-1]["npaths"] > 0).sum())
    assert mapped > 0.95 * 2048, f"only {mapped}/2048 reads mapped"

    # ------------------------------------------ end-to-end SE (FASTQ -> SAM)
    lut = np.frombuffer(b"ACGT", np.uint8)
    se_recs = [
        runner_mod.Record(f"s{i}", f"s{i}", bytes(lut[row]).decode(), "I" * L)
        for i, row in enumerate(codes[:nreads_e2e])
    ]
    out = io.StringIO()
    runner.run(se_recs[: min(BATCH, nreads_e2e)], out,
               batch_size=min(BATCH, nreads_e2e))  # warmup / compile
    se_best = None
    for _rep in range(2):
        t0 = time.time()
        out = io.StringIO()
        n = runner.run(se_recs, out, batch_size=BATCH)
        dt_se = time.time() - t0
        assert n == len(se_recs)
        se_best = dt_se if se_best is None else min(se_best, dt_se)
    se_e2e_qps = len(se_recs) / se_best

    # ---------------------------------------------- batched GMAP cDNA
    rng = np.random.default_rng(7)
    queries = make_gmap_workload(seq, gmap_n, rng)
    paths = gmap_mod.align_cdna_batch(db, queries)  # warmup
    t0 = time.time()
    paths = gmap_mod.align_cdna_batch(db, queries)
    gmap_qps = len(queries) / (time.time() - t0)
    nmapped = sum(1 for p in paths if p is not None)
    assert nmapped >= 0.9 * len(queries), f"gmap mapped {nmapped}"

    # ------------------------------------------- configs 3/4/5 (BASELINE.md)
    import bench_workloads as bw

    # plain str (db.genome_str is a LazyGenomeStr window view)
    seq = seq[0 : len(seq)]

    def timed_run(r, recs_a, recs_b=None, reps=2):
        best = None
        for _ in range(reps):
            buf = io.StringIO()
            t0 = time.time()
            if recs_b is None:
                n_ = r.run(recs_a, buf, batch_size=BATCH)
            else:
                n_ = r.run_pe(recs_a, recs_b, buf, batch_size=BATCH)
            dt_ = time.time() - t0
            assert n_ == len(recs_a)
            best = dt_ if best is None else min(best, dt_)
        return len(recs_a) / best

    def recs_of(reads, pfx):
        return [runner_mod.Record(f"{pfx}{i}", f"{pfx}{i}", s, "I" * L)
                for i, s in enumerate(reads)]

    # config 3: PE novel splicing (-N 1)
    rng = np.random.default_rng(7)
    jx = bw.find_junctions(seq)
    r5s, r3s = bw.make_pe_splice_workload(seq, 4096, rng, jx)
    r3_ns = runner_mod.GsnapRunner(db, novelsplicing=True)
    r3_ns.warmup(batch_size=BATCH, pe=True)
    c3_qps = timed_run(r3_ns, recs_of(r5s, "s"), recs_of(r3s, "s"))

    # configs 4/5 DB artifacts (our iit_store/snpindex/cmetindex)
    import pathlib

    from gmap_gsnap.cli import cmetindex as cmetindex_cli
    from gmap_gsnap.cli import snpindex as snpindex_cli
    from gmap_gsnap.db.iit_text import iit_from_text

    rng = np.random.default_rng(11)
    ss_txt, snp_txt, juncs, snps = bw.known_snp_setup(seq, rng)
    maps = pathlib.Path(dbdir) / "chr17test.maps"
    maps.mkdir(exist_ok=True)
    iit_from_text(ss_txt).write(str(maps / "ss.iit"))
    iit_from_text(snp_txt).write(str(maps / "snps.iit"))
    snpindex_cli.main(["-D", tmp, "-d", "chr17test", "-v", "snps",
                       str(maps / "snps.iit")])
    cmetindex_cli.main(["-D", tmp, "-d", "chr17test"])
    db45 = GenomeDB.open(dbdir, "chr17test")

    # config 4: known splicesites + SNP-tolerant index
    rng = np.random.default_rng(11)
    ks_reads = bw.make_known_snp_workload(seq, 4096, rng, juncs, snps)
    r4 = runner_mod.GsnapRunner(db45, snpsdb="snps", splicesdb="ss")
    r4.warmup(batch_size=BATCH)
    c4_qps = timed_run(r4, recs_of(ks_reads, "k"))

    # config 5: bisulfite (cmet-stranded)
    rng = np.random.default_rng(5)
    cm_reads = bw.make_cmet_workload(seq, 4096, rng)
    p5 = gsnap_se.GsnapParams(
        mode="cmet-stranded",
        size_threshold=gsnap_se.dynamic_size_threshold(
            int(db45.offsets[-1]), db45.k, "cmet-stranded"))
    r5r = runner_mod.GsnapRunner(db45, params=p5)
    r5r.warmup(batch_size=BATCH)
    c5_qps = timed_run(r5r, recs_of(cm_reads, "c"))

    # ------------------------------------------- dynprog kernel micro-bench
    from gmap_gsnap.ops import dynprog as dp

    rng = np.random.default_rng(5)
    B, M, N = 4096, 32, 40
    q = rng.integers(0, 4, (B, M)).astype(np.int32)
    gmat = rng.integers(0, 4, (B, N)).astype(np.int32)
    len1 = np.full(B, M, np.int32)
    len2 = np.full(B, N, np.int32)
    lband, rband = dp.compute_bands(len1, len2, 7)
    W = int((lband + rband).max()) + 1
    pairmat = dp.pair_matrix(dp.MISMATCH_HIGHQ)
    late = np.zeros(B, bool)
    mats = dp.banded_matrices(q, gmat, len1, len2, lband, rband, pairmat,
                              late, M=M, W=W, open_=dp.PAIRED_OPEN,
                              extend=dp.PAIRED_EXTEND)
    jax.block_until_ready(mats)
    t0 = time.time()
    reps = 10
    for _ in range(reps):
        mats = dp.banded_matrices(q, gmat, len1, len2, lband, rband,
                                  pairmat, late, M=M, W=W,
                                  open_=dp.PAIRED_OPEN,
                                  extend=dp.PAIRED_EXTEND)
        jax.block_until_ready(mats)
    dyn_per_sec = reps * B / (time.time() - t0)

    platform = jax.devices()[0].platform
    extra = {
        "gsnap_pe_sub_pairs_per_sec": round(pe_qps, 1),
        "gsnap_pe_sub_vs_baseline": round(pe_qps / BASELINE_PE_QPS, 2),
        "gsnap_se_device_reads_per_sec": round(se_qps, 1),
        "gsnap_se_device_vs_baseline": round(se_qps / BASELINE_SE_QPS, 2),
        "gsnap_se_end_to_end_reads_per_sec": round(se_e2e_qps, 1),
        "gsnap_se_end_to_end_vs_baseline": round(
            se_e2e_qps / BASELINE_SE_QPS, 2),
        "gmap_cdna_per_sec": round(gmap_qps, 1),
        "gmap_cdna_vs_baseline": round(gmap_qps / BASELINE_GMAP_QPS, 2),
        "dynprog_banded_gaps_per_sec": round(dyn_per_sec, 1),
        "platform": platform,
    }
    extra["config3_pe_novelsplice_pairs_per_sec"] = round(c3_qps, 1)
    extra["config3_vs_baseline"] = round(c3_qps / BASELINE_C3_QPS, 2)
    extra["config4_known_snp_reads_per_sec"] = round(c4_qps, 1)
    extra["config4_vs_baseline"] = round(c4_qps / BASELINE_C4_QPS, 2)
    extra["config5_cmet_reads_per_sec"] = round(c5_qps, 1)
    extra["config5_vs_baseline"] = round(c5_qps / BASELINE_C5_QPS, 2)
    # headline = config 3 (PE novel splicing, the BASELINE.md RNA-seq
    # config)
    headline, base = c3_qps, BASELINE_C3_QPS
    metric = "gsnap_pe_100bp_novelsplice_end_to_end_pairs_per_sec"
    print(json.dumps({
        "metric": metric,
        "value": round(headline, 1),
        "unit": "pairs/s",
        "vs_baseline": round(headline / base, 2),
        "extra": extra,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
