"""Smoke run of GSNAP and GMAP on one GPU, through the command-line entry
points, on a seeded 256 Mbp genome indexed at k=15, interval 3.

    python chip_smoke.py            # phases 1-5 on one GPU
    python chip_smoke.py --four     # phase 1, then the 4-GPU mesh check

Phases:
  1. genome + database: a seeded 256 Mbp, 4-chromosome genome with 2,000
     planted genes (db/synth.py), built with gmap_build -k 15 -q 3
  2. GSNAP paired-end novel splicing (-N 1): 16,384 pairs of 2x100 bp
  3. GSNAP single-end, mismatch only: 16,384 x 100 bp reads
  4. GMAP cDNA (-f samse): 64 spliced cDNAs of planted genes
  5. parity on the device: exact gathers, maxent probabilities, banded
     dynprog matrices, and whole-program SAM digests on a small database
     against the digests in tests/sam_digests.json
  6. (--four only) the phase-2 workload over a 4-device reads mesh and on
     one device must give identical SAM; sharded-index seeding must match
     replicated seeding

Each phase prints its wall seconds, compile seconds and the device's peak
bytes in use.  SAM goes to files in a work directory, never to stdout.
The last line of stdout is one JSON object, printed only when every phase
passed; without a GPU the script exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Bars for the main-path phases.  The CPU rehearsal (16 Mbp genome of
# 125 genes, k=15, 2,048 pairs / reads, 64 cDNAs, same generators) gave
# 0.966 of pairs at origin, 0.929 of 803 junction-crossing ends with the
# planted intron, 1.0 of SE reads at origin and 1.0 of cDNAs exact.  Each
# bar is that rate less a margin: three points for the PE shares, one for
# SE, five for GMAP (one of 64 cDNAs is 1.6 points).
PE_PLACED_BAR = 0.93          # pairs with both ends at their origin
PE_JUNCTION_BAR = 0.90        # junction-crossing ends with the intron as N
SE_PLACED_BAR = 0.99          # reads at their origin
GMAP_EXACT_BAR = 0.95         # cDNAs whose introns equal the planted ones

# Device maxent probabilities are float32 products of up to six table
# factors followed by odds / (1 + odds); each step rounds by at most
# 2^-24 relative, so |p_device - p_float64| stays below 8 * 2^-24 ~ 5e-7.
MAXENT_ATOL = 1e-6

NAME = "synth"    # database name of phases 1-4 and 6
K = 15            # index k-mer size, the reference's human setting
BATCH = 2048      # gsnap --batch-size
CDNAS = 64        # GMAP queries of phase 4

# The small database of the digest check.  Fixed, not --seed: the
# digests in tests/sam_digests.json were made from exactly this input.
DIGEST_GENOME = dict(total_len=2_000_000, nchrom=4, ngenes=40, seed=5)
DIGEST_READS = 256
DIGEST_FILE = os.path.join(ROOT, "tests", "sam_digests.json")


# ------------------------------------------------------------ bookkeeping

class Phases:
    """Runs named phases, printing wall and compile seconds and the
    device's peak bytes for each; a failed phase is recorded and the run
    goes on so one report shows every failure."""

    def __init__(self):
        import jax
        from jax import monitoring

        self.compile_s = 0.0
        self.failed: list[str] = []
        self.device = jax.devices()[0]
        monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event.startswith("/jax/core/compile/"):
            self.compile_s += duration

    @contextlib.contextmanager
    def run(self, name):
        t0, c0 = time.time(), self.compile_s
        ok = True
        try:
            yield
        except Exception:
            ok = False
            self.failed.append(name)
            traceback.print_exc()
        stats = self.device.memory_stats() or {}
        print(f"phase {name}: {'ok' if ok else 'FAILED'} "
              f"wall_s={time.time() - t0:.1f} "
              f"compile_s={self.compile_s - c0:.1f} "
              f"peak_bytes_in_use={stats.get('peak_bytes_in_use')}",
              flush=True)


def card_line() -> str:
    """The card's name and power limit, from nvidia-smi in a child
    process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def require_gpu():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devs[0].platform}",
              file=sys.stderr)
        sys.exit(1)
    return devs


# ------------------------------------------------------------------- SAM

_CIGAR = re.compile(r"(\d+)([MIDNSHP=X])")


def sam_primaries(path: str):
    """(number of primary records, {(qname, end): (rname, pos, cigar)})
    where end is 1/2 for paired ends and 0 for single reads."""
    n = 0
    recs = {}
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            q, flag, rname, pos, _, cigar = line.split("\t", 6)[:6]
            flag = int(flag)
            if flag & 0x900:
                continue
            n += 1
            end = 1 if flag & 0x40 else 2 if flag & 0x80 else 0
            recs[(q, end)] = (rname, int(pos), cigar)
    return n, recs


def aligned_left(pos: int, cigar: str) -> int:
    """0-based genomic coordinate of the read's first base, counting a
    leading soft clip as aligned."""
    ops = _CIGAR.findall(cigar)
    clip = int(ops[0][0]) if ops and ops[0][1] == "S" else 0
    return pos - 1 - clip


def cigar_introns(pos: int, cigar: str) -> list[tuple[int, int]]:
    """N operations as 0-based half-open genomic intervals."""
    ref = pos - 1
    out = []
    for n, op in _CIGAR.findall(cigar):
        n = int(n)
        if op == "N":
            out.append((ref, ref + n))
        if op in "MDN=X":
            ref += n
    return out


def placed(rec, truth, names) -> bool:
    return (rec is not None and rec[0] == names[truth.chrom]
            and rec[2] != "*" and aligned_left(rec[1], rec[2]) == truth.left)


def sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def cli_to_file(main, argv, out_path):
    """Run a CLI main() with its stdout sent to out_path."""
    with open(out_path, "w") as f, contextlib.redirect_stdout(f):
        rc = main(argv)
    if rc:
        raise RuntimeError(f"{argv[:4]}... exited {rc}")


# ----------------------------------------------------------------- phases

def build_genome(work, total_len, nchrom, ngenes, seed, k):
    """Phase 1: write the seeded genome as FASTA and build its database
    with gmap_build.  Returns the SynthGenome."""
    from gmap_gsnap.cli import gmap_build
    from gmap_gsnap.db import synth

    t0 = time.time()
    g = synth.make_genome(total_len, nchrom, ngenes, seed)
    fa = os.path.join(work, f"{NAME}.fa")
    g.write_fasta(fa)
    print(f"genome: {total_len} nt, {nchrom} chromosomes, "
          f"{len(g.genes)} genes, {time.time() - t0:.1f} s", flush=True)
    t0 = time.time()
    rc = gmap_build.main(["-D", work, "-d", NAME, "-k", str(k), "-q", "3",
                          fa])
    if rc:
        raise RuntimeError(f"gmap_build exited {rc}")
    os.remove(fa)
    print(f"gmap_build -k {k} -q 3: {time.time() - t0:.1f} s", flush=True)
    return g


def open_on_device(work):
    """Open the database and place genome and index on the device;
    returns (GenomeDB, bytes the device then holds)."""
    import jax

    from gmap_gsnap.db.datadir import GenomeDB

    db = GenomeDB.open(work, NAME)
    jax.block_until_ready((db.device_genome, db.device_index))
    stats = jax.devices()[0].memory_stats() or {}
    return db, stats.get("bytes_in_use")


def pe_splice(work, g, npairs, seed, k, batch, tag="pe"):
    """Phase 2: GSNAP -N 1 on simulated pairs.  Returns (sam path,
    primary records, placed share, junction share, junction ends)."""
    from gmap_gsnap.cli import gsnap
    from gmap_gsnap.db import synth

    r1, r2, t1, t2 = synth.simulate_pairs(g, npairs, seed)
    f1, f2 = (os.path.join(work, f"{tag}_{i}.fq") for i in (1, 2))
    synth.write_fastq(f1, r1, "p")
    synth.write_fastq(f2, r2, "p")
    sam = os.path.join(work, f"{tag}.sam")
    cli_to_file(gsnap.main, ["-D", work, "-d", NAME, "-k", str(k), "-N", "1",
                             "--batch-size", str(batch), "--format=sam",
                             f1, f2], sam)
    n, recs = sam_primaries(sam)
    ok_pairs = sum(
        placed(recs.get((f"p{i}", 1)), t1[i], g.names)
        and placed(recs.get((f"p{i}", 2)), t2[i], g.names)
        for i in range(npairs))
    jends = jok = 0
    for i in range(npairs):
        for end, t in ((1, t1[i]), (2, t2[i])):
            if not t.introns:
                continue
            jends += 1
            rec = recs.get((f"p{i}", end))
            if rec is not None and rec[2] != "*" and rec[0] == g.names[t.chrom]:
                jok += set(t.introns) <= set(cigar_introns(rec[1], rec[2]))
    return sam, n, ok_pairs / npairs, jok / max(jends, 1), jends


def se_mismatch(work, g, nreads, seed, k, batch):
    """Phase 3: GSNAP single-end.  Returns (primary records, placed
    share)."""
    from gmap_gsnap.cli import gsnap
    from gmap_gsnap.db import synth

    reads, truths = synth.simulate_single(g, nreads, seed)
    fq = os.path.join(work, "se.fq")
    synth.write_fastq(fq, reads, "s")
    sam = os.path.join(work, "se.sam")
    cli_to_file(gsnap.main, ["-D", work, "-d", NAME, "-k", str(k),
                             "--batch-size", str(batch), "--format=sam", fq],
                sam)
    n, recs = sam_primaries(sam)
    ok = sum(placed(recs.get((f"s{i}", 0)), t, g.names)
             for i, t in enumerate(truths))
    return n, ok / nreads


def gmap_cdna(work, g, n, seed, k):
    """Phase 4: GMAP -f samse on full-length cDNAs.  Returns the share
    whose introns equal the planted ones."""
    from gmap_gsnap.cli import gmap
    from gmap_gsnap.db import synth

    seqs, genes = synth.simulate_cdnas(g, n, seed)
    fa = os.path.join(work, "cdna.fa")
    synth.write_fasta_queries(fa, seqs, "c")
    sam = os.path.join(work, "cdna.sam")
    cli_to_file(gmap.main, ["-D", work, "-d", NAME, "-k", str(k),
                            "-f", "samse", fa], sam)
    _, recs = sam_primaries(sam)
    exact = 0
    for i, gene in enumerate(genes):
        rec = recs.get((f"c{i}", 0))
        exact += (rec is not None and rec[2] != "*"
                  and rec[0] == g.names[gene.chrom]
                  and cigar_introns(rec[1], rec[2]) == gene.introns)
    return exact / n


# ---------------------------------------------------------- phase 5 parity

def selection_parity(batch=2048, seed=0):
    """Gathers as the alignment cascade makes them, on the device,
    against NumPy fancy indexing: candidate columns (ncand 32 and 128),
    prefix rows of npos = L + 1 = 101, and the 16,384-entry maxent
    tables.  Returns the number of mismatching elements."""
    import jax
    import jax.numpy as jnp

    from gmap_gsnap.ops import maxent

    rng = np.random.default_rng(seed)
    take = jax.jit(lambda x, i: jnp.take_along_axis(x, i, axis=1))
    bad = 0
    for n in (32, 101, 128):
        idx = rng.integers(0, n, (batch, n)).astype(np.int32)
        for x in (rng.integers(0, 2**32, (batch, n), dtype=np.uint32),
                  rng.integers(-2**31, 2**31, (batch, n), dtype=np.int32),
                  rng.random((batch, n)) < 0.5,
                  rng.random((batch, n)).astype(np.float32)):
            got = np.asarray(take(jnp.asarray(x), jnp.asarray(idx)))
            bad += int((got != np.take_along_axis(x, idx, axis=1)).sum())
    lookup = jax.jit(lambda t, i: t[i])
    for table in maxent._tables_np().values():
        t32 = table.astype(np.float32)
        idx = rng.integers(0, len(t32), (batch, 101)).astype(np.int32)
        got = np.asarray(lookup(jnp.asarray(t32), jnp.asarray(idx)))
        bad += int((got != t32[idx]).sum())
    return bad


def maxent_parity(n=65536, seed=0):
    """Device maxent probabilities against the host float64 model at n
    random genome positions per model; returns the largest absolute
    difference."""
    import jax.numpy as jnp

    from gmap_gsnap.ops import genome as genome_ops
    from gmap_gsnap.ops import maxent

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, 1 << 20).astype(np.uint8)
    genome = genome_ops.GenomeArrays.from_codes(
        codes, np.zeros(len(codes), bool), np.array([len(codes)]))
    pos = rng.integers(30, len(codes) - 30, n).astype(np.uint32)
    worst = 0.0
    for kind in ("donor", "acceptor", "antidonor", "antiacceptor"):
        dev = np.asarray(maxent.splice_prob(genome, jnp.asarray(pos), kind))
        host = maxent.splice_prob_np(codes, pos.astype(np.int64), kind)
        worst = max(worst, float(np.abs(dev.astype(np.float64) - host).max()))
    return worst


def dynprog_parity(nprob=64, seed=7):
    """ops.dynprog.banded_matrices against the dense oracle of
    tests/dynprog_oracle.py at read-scale problems (up to 100 x 120);
    returns the number of band cells that differ."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import dynprog_oracle as oracle

    from gmap_gsnap.ops import dynprog as dp

    rng = np.random.default_rng(seed)
    problems = []
    for _ in range(nprob):
        m, n = int(rng.integers(60, 101)), int(rng.integers(60, 121))
        g = rng.integers(0, 4, n).astype(np.int32)
        q = (g[:m].copy() if m <= n else rng.integers(0, 4, m)).astype(np.int32)
        for _ in range(int(rng.integers(0, 4))):
            q[rng.integers(0, m)] = rng.integers(0, 4)
        problems.append((q, g))
    M = max(len(p[0]) for p in problems)
    N = max(len(p[1]) for p in problems)
    B = len(problems)
    q = np.full((B, M), 5, np.int32)
    g = np.full((B, N), 5, np.int32)
    len1 = np.array([len(p[0]) for p in problems], np.int32)
    len2 = np.array([len(p[1]) for p in problems], np.int32)
    for i, (qi, gi) in enumerate(problems):
        q[i, :len(qi)] = qi
        g[i, :len(gi)] = gi
    extraband = 3
    lband, rband = dp.compute_bands(len1, len2, extraband)
    W = int((lband + rband).max()) + 1
    pairmat = dp.pair_matrix(dp.MISMATCH_HIGHQ)
    late = np.zeros(B, bool)
    dev = [np.asarray(x) for x in dp.banded_matrices(
        q, g, len1, len2, lband, rband, pairmat, late, M=M, W=W,
        open_=dp.SINGLE_OPEN, extend=dp.SINGLE_EXTEND)[:3]]
    bad = 0
    for i, (qi, gi) in enumerate(problems):
        ora = oracle.compute_matrices(qi, gi, dp.SINGLE_OPEN,
                                      dp.SINGLE_EXTEND, pairmat, extraband,
                                      False)[:3]
        for r in range(len1[i] + 1):
            for c in range(max(0, r - lband[i]),
                           min(len2[i], r + rband[i]) + 1):
                kk = c - r + lband[i]
                for d, o in zip(dev, ora):
                    o = int(o[r][c])
                    d = int(d[i, r, kk])
                    bad += (d > oracle.NEG_INF + 100 if o <= oracle.NEG_INF
                            else d != o)
    return bad


def known_sites_setup(work, g, name, seed, nsnps=64):
    """Config-4 database material: every planted intron as a known splice
    site (maps/ss.iit) and nsnps SNPs (maps/snps.iit + snpindex).
    Returns the SNPs as [(chrom, pos, alt code)]."""
    from gmap_gsnap.cli import cmetindex, snpindex
    from gmap_gsnap.db.iit_text import iit_from_text

    rng = np.random.default_rng(seed)
    ss = []
    for j, gene in enumerate(g.genes):
        chrom = g.names[gene.chrom]
        for i, (a, b) in enumerate(gene.introns):
            ss.append(f">g{j}.{i}.d {chrom}:{a}..{a + 1} donor")
            ss.append(f">g{j}.{i}.a {chrom}:{b}..{b + 1} acceptor")
    snps, lines = [], []
    for i in range(nsnps):
        c = int(rng.integers(0, len(g.names)))
        chrom = g.chrom_codes(c)
        p = int(rng.integers(200, len(chrom) - 200))
        alt = (int(chrom[p]) + int(rng.integers(1, 4))) % 4
        snps.append((c, p, alt))
        lines.append(f">rs{i} {g.names[c]}:{p + 1} "
                     f"{'ACGT'[chrom[p]]}{'ACGT'[alt]}")
    maps = os.path.join(work, name, f"{name}.maps")
    iit_from_text("\n".join(ss) + "\n").write(os.path.join(maps, "ss.iit"))
    iit_from_text("\n".join(lines) + "\n").write(
        os.path.join(maps, "snps.iit"))
    snpindex.main(["-D", work, "-d", name, "-v", "snps",
                   os.path.join(maps, "snps.iit")])
    cmetindex.main(["-D", work, "-d", name])
    return snps


def known_sites_reads(g, snps, n, seed):
    """Config-4 reads: a quarter across planted junctions, a quarter
    carrying a SNP's alternative allele, the rest plain."""
    from gmap_gsnap.db import synth

    rng = np.random.default_rng(seed)
    spliced = synth.simulate_pairs(g, n, seed, spliced_share=1.0, nsub=2)[0]
    plain = synth.simulate_single(g, n, seed + 1, nsub=2)[0]
    out = []
    for i in range(n):
        if i % 4 == 0:
            out.append(spliced[i])
        elif i % 4 == 1:
            c, p, alt = snps[int(rng.integers(0, len(snps)))]
            off = int(rng.integers(10, 90))
            r = g.chrom_codes(c)[p - off:p - off + 100].copy()
            r[off] = alt
            out.append(synth.to_str(r))
        else:
            out.append(plain[i])
    return out


def cmet_reads(g, n, seed):
    """Config-5 reads: read 1 of a stranded bisulfite library, from
    either strand, every C read as T."""
    from gmap_gsnap.db import synth

    return [r.replace("C", "T")
            for r in synth.simulate_single(g, n, seed, nsub=2)[0]]


def sam_digests(work, n=DIGEST_READS, configs=None):
    """Phase 5, whole program: SAM sha256 of the five deployment configs
    on the small seeded database.  Returns {config: digest}."""
    from gmap_gsnap.cli import gsnap
    from gmap_gsnap.db import synth

    name = "digest"
    os.makedirs(work, exist_ok=True)
    g = synth.make_genome(**DIGEST_GENOME)
    fa = os.path.join(work, "digest.fa")
    g.write_fasta(fa)
    from gmap_gsnap.cli import gmap_build

    gmap_build.main(["-D", work, "-d", name, "-k", "12", "-q", "3", fa])
    snps = known_sites_setup(work, g, name, seed=11)

    def fq(tag, reads, prefix="r"):
        path = os.path.join(work, f"digest_{tag}.fq")
        synth.write_fastq(path, reads, prefix)
        return path

    sub = synth.simulate_pairs(g, n, 21, spliced_share=0.0)
    spl = synth.simulate_pairs(g, n, 22)
    runs = {
        "se": ["--format=sam", fq("s", synth.simulate_single(g, n, 20)[0])],
        "pe": ["--format=sam", fq("a", sub[0]), fq("b", sub[1])],
        "pe_novelsplice": ["-N", "1", "--format=sam", fq("c", spl[0]),
                           fq("d", spl[1])],
        "known_splice_snp": ["-s", "ss", "-v", "snps", "--format=sam",
                             fq("k", known_sites_reads(g, snps, n, 23))],
        "cmet_stranded": ["--mode", "cmet-stranded", "--format=sam",
                          fq("m", cmet_reads(g, n, 24))],
    }
    out = {}
    for cfg, args in runs.items():
        if configs is not None and cfg not in configs:
            continue
        sam = os.path.join(work, f"digest_{cfg}.sam")
        cli_to_file(gsnap.main, ["-D", work, "-d", name, "-k", "12"] + args,
                    sam)
        out[cfg] = sha256(sam)
    return out


# ------------------------------------------------------------- phase 6

def four_devices(work, g, npairs, seed, k, batch):
    """The phase-2 workload through the reads mesh over every device and
    through one device; the SAM must be identical.  Then sharded-index
    seeding against replicated seeding on the same database."""
    import jax
    import jax.numpy as jnp

    from gmap_gsnap.align import gsnap_gapped, gsnap_se
    from gmap_gsnap.parallel import shard

    ndev = len(jax.devices())
    sam_mesh = pe_splice(work, g, npairs, seed, k, batch, tag="mesh")[0]
    orig = jax.devices
    try:
        jax.devices = lambda *a, **kw: orig(*a, **kw)[:1]
        sam_one = pe_splice(work, g, npairs, seed, k, batch, tag="one")[0]
    finally:
        jax.devices = orig
    same = sha256(sam_mesh) == sha256(sam_one)
    print(f"four: SAM over {ndev} devices "
          f"{'identical to' if same else 'DIFFERS from'} one device "
          f"({npairs} pairs)", flush=True)

    db, _ = open_on_device(work)
    mesh = shard.reads_mesh()
    genome, index, _, _, _ = shard.place(mesh, db.device_genome,
                                         db.device_index)
    sharded = shard.ShardedIndexArrays.from_index(mesh, db.device_index)
    from gmap_gsnap.db import synth
    from gmap_gsnap.utils import dna

    reads = synth.simulate_single(g, 64 * ndev, seed + 5)[0]
    codes = np.stack([dna.encode(r)[0] for r in reads])
    c, f, l = shard.shard_reads(
        mesh, jnp.asarray(codes), jnp.zeros(codes.shape, bool),
        jnp.full(len(reads), codes.shape[1], jnp.int32))
    params = gsnap_gapped.GappedParams(base=gsnap_se.GsnapParams(
        size_threshold=gsnap_se.dynamic_size_threshold(
            len(db.positions), k, "standard")))
    rep = gsnap_gapped.align_batch_gapped(genome, index, c, f, l, params)
    shd = gsnap_gapped.align_batch_gapped(genome, sharded, c, f, l, params)
    seed_same = all(np.array_equal(np.asarray(rep[key]), np.asarray(shd[key]))
                    for key in ("npaths", "left"))
    print(f"four: sharded-index seeding "
          f"{'matches' if seed_same else 'DIFFERS from'} replicated "
          f"({len(reads)} reads)", flush=True)
    if not (same and seed_same):
        raise AssertionError("four-device results differ")


# ------------------------------------------------------------------ main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-device mesh check (after phase 1)")
    ap.add_argument("--mbp", type=int, default=256,
                    help="genome size in Mbp, with 2,000 genes per 256 Mbp")
    ap.add_argument("--reads", type=int, default=16384,
                    help="PE pairs of phase 2 and SE reads of phase 3")
    ap.add_argument("--workdir", default=None,
                    help="where the database and SAM files go "
                         "(default: a temporary directory, removed after)")
    args = ap.parse_args(argv)

    if not args.four:
        # the default run uses one card even where the host has more
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    devs = require_gpu()
    if args.four and len(devs) < 4:
        print(f"chip_smoke: --four needs 4 GPUs, found {len(devs)}",
              file=sys.stderr)
        return 1
    print(card_line(), flush=True)
    print(f"device_kind: {devs[0].device_kind} ({len(devs)} visible)",
          flush=True)

    from gmap_gsnap.native import get_lib

    print(f"native host library: "
          f"{'loaded' if get_lib() is not None else 'unavailable'}",
          flush=True)
    ph = Phases()
    work = args.workdir or tempfile.mkdtemp(prefix="chip_smoke_")
    os.makedirs(work, exist_ok=True)
    batch = min(BATCH, args.reads)
    ngenes = max(16, 2000 * args.mbp // 256)
    try:
        g = None
        with ph.run("1_genome_db"):
            g = build_genome(work, args.mbp * 1_000_000, 4, ngenes,
                             args.seed, K)
            db, nbytes = open_on_device(work)
            print(f"database: {len(db.positions)} positions, "
                  f"{nbytes} device bytes in use after open", flush=True)
            del db
        if g is None:
            return 1
        if args.four:
            with ph.run("6_four_devices"):
                four_devices(work, g, args.reads, args.seed + 1, K, batch)
        else:
            with ph.run("2_gsnap_pe_novelsplice"):
                _, n, share, jshare, jends = pe_splice(
                    work, g, args.reads, args.seed + 1, K, batch)
                print(f"pe: {n} primary records, {share:.4f} of pairs at "
                      f"origin (bar {PE_PLACED_BAR}), {jshare:.4f} of "
                      f"{jends} junction ends with the intron as N "
                      f"(bar {PE_JUNCTION_BAR})", flush=True)
                assert n == 2 * args.reads, n
                assert share >= PE_PLACED_BAR and jshare >= PE_JUNCTION_BAR
            with ph.run("3_gsnap_se"):
                n, share = se_mismatch(work, g, args.reads, args.seed + 2,
                                       K, batch)
                print(f"se: {n} primary records, {share:.4f} at origin "
                      f"(bar {SE_PLACED_BAR})", flush=True)
                assert n == args.reads, n
                assert share >= SE_PLACED_BAR
            with ph.run("4_gmap_cdna"):
                share = gmap_cdna(work, g, CDNAS, args.seed + 3, K)
                print(f"gmap: {share:.4f} of cDNAs with the planted introns "
                      f"(bar {GMAP_EXACT_BAR})", flush=True)
                assert share >= GMAP_EXACT_BAR
            with ph.run("5_parity"):
                bad = selection_parity()
                print(f"parity: selection {bad} elements differ", flush=True)
                worst = maxent_parity()
                print(f"parity: maxent max |dp| {worst:.3g} "
                      f"(tolerance {MAXENT_ATOL})", flush=True)
                cells = dynprog_parity()
                print(f"parity: dynprog {cells} cells differ", flush=True)
                with open(DIGEST_FILE) as f:
                    want = json.load(f)
                got = sam_digests(os.path.join(work, "digest"))
                for cfg in want:
                    print(f"parity: SAM {cfg} "
                          f"{'equal' if got.get(cfg) == want[cfg] else 'DIFFERS'}",
                          flush=True)
                assert bad == 0 and cells == 0 and worst <= MAXENT_ATOL
                assert got == want
    finally:
        if args.workdir is None:
            shutil.rmtree(work, ignore_errors=True)
    if ph.failed:
        print(f"chip_smoke: failed phases: {', '.join(ph.failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
