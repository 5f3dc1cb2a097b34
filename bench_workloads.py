"""Deterministic workload generators for the five BASELINE.md bench
configs, shared by bench.py (our engine) and
tools/measure_reference.py (the reference binaries).

All generators take the chr17test genome string + a seeded Generator so
both sides measure on byte-identical FASTQ inputs.

Configs (BASELINE.md):
  1. GMAP cDNA spliced alignment          (bench.make_gmap_workload)
  2. GSNAP SE mismatch-only               (make_se_workload)
  3. GSNAP PE novel splicing (-N 1)       (make_pe_splice_workload)
  4. GSNAP known splicesites + SNPs       (make_known_snp_workload)
  5. GSNAP bisulfite (cmet-stranded)      (make_cmet_workload)
"""

from __future__ import annotations

import numpy as np

L = 100
COMP = str.maketrans("ACGT", "TGCA")


def _codes(seq: str) -> np.ndarray:
    code_of = np.zeros(256, np.uint8)
    for i, c in enumerate(b"ACGT"):
        code_of[c] = i
    return code_of[np.frombuffer(seq.encode(), np.uint8)]


def _mutate(rng, read: list, nmax: int = 3):
    for _ in range(int(rng.integers(0, nmax + 1))):
        read[int(rng.integers(0, len(read)))] = "ACGT"[int(rng.integers(0, 4))]


def make_se_workload(seq: str, nreads: int, rng) -> list[str]:
    """Config 2: substitution-only SE reads, half reverse-complemented.
    Exactly bench.py's historical SE workload (same rng call order) —
    proven not to trip the reference's own crash bugs at seed 42."""
    gcodes = _codes(seq)
    lefts = rng.integers(0, len(seq) - L, nreads)
    codes = gcodes[lefts[:, None] + np.arange(L)[None, :]].copy()
    nmut = rng.integers(0, 4, nreads)
    for i in range(nreads):
        for _ in range(nmut[i]):
            codes[i, rng.integers(0, L)] = rng.integers(0, 4)
    rc = rng.random(nreads) < 0.5
    codes[rc] = (codes[rc, ::-1] ^ 3).astype(np.uint8)
    lut = np.frombuffer(b"ACGT", np.uint8)
    return [bytes(lut[row]).decode() for row in codes]


# chr17test junctions the REFERENCE gsnap -N 1 segfaults on (its own
# memory-corruption bugs — each verified with an isolated 64-pair run,
# tools/screen output 2026-08-20); excluded from the config-3 workload
# so both aligners measure the identical crash-free set
REF_TOXIC_JUNCTIONS = {
    (1782, 2154), (4734, 5039), (5692, 6113), (6166, 6475),
    (6223, 6542), (10413, 10880), (11850, 12163), (13681, 14122),
    (13693, 14122), (13756, 14122), (15142, 15551), (15662, 16103),
    (16371, 16746), (20620, 21034), (25385, 25870), (25860, 26164),
    (26464, 26869), (27092, 27613), (28985, 29353), (29096, 29500),
    (30946, 31347), (31676, 32121), (37639, 37953), (38239, 38597),
    (43193, 43503), (45214, 45595), (46047, 46363), (48786, 49122),
}


def find_junctions(seq: str, min_prob: float = 0.90,
                   intron_lo: int = 300, intron_hi: int = 5000,
                   max_n: int = 256) -> list[tuple[int, int]]:
    """Genomic GT..AG pairs whose maxent donor/acceptor probabilities
    both exceed min_prob — junctions the reference's novel-splicing
    maxent scan can discover.  Returns [(intron_start, intron_end)),
    0-based, intron = seq[s:e], excluding REF_TOXIC_JUNCTIONS."""
    from gmap_gsnap.ops.maxent import splice_prob_np

    codes = _codes(seq)
    sb = seq.encode()
    gt = np.array([i for i in range(50, len(seq) - 50)
                   if sb[i : i + 2] == b"GT"], np.int64)
    ag = np.array([j for j in range(50, len(seq) - 50)
                   if sb[j - 2 : j] == b"AG"], np.int64)
    pd = splice_prob_np(codes, gt, "donor")
    pa = splice_prob_np(codes, ag, "acceptor")
    gt = gt[pd >= min_prob]
    ag = ag[pa >= min_prob]
    out = []
    for s in gt:
        lo = np.searchsorted(ag, s + intron_lo)
        hi = np.searchsorted(ag, s + intron_hi)
        for j in ag[lo:hi]:
            if (int(s), int(j)) not in REF_TOXIC_JUNCTIONS:
                out.append((int(s), int(j)))
            break  # nearest acceptable acceptor per donor
        if len(out) >= max_n:
            break
    return out


def make_pe_splice_workload(seq: str, npairs: int, rng,
                            junctions=None) -> tuple[list[str], list[str]]:
    """Config 3: paired-end reads over spliced transcripts (50%) mixed
    with plain genomic pairs (50%); run with -N 1."""
    if junctions is None:
        junctions = find_junctions(seq)
    assert junctions, "no high-probability junctions in genome"
    r5, r3 = [], []
    exon = 220
    for i in range(npairs):
        if i % 2 == 0 and junctions:
            s, e = junctions[int(rng.integers(0, len(junctions)))]
            if s - exon < 0 or e + exon > len(seq):
                s, e = junctions[0]
            tx = seq[s - exon : s] + seq[e : e + exon]
        else:
            p = int(rng.integers(0, len(seq) - 700))
            tx = seq[p : p + 2 * exon]
        ins = int(rng.integers(2 * L, min(len(tx), 2 * exon) - 2))
        off = int(rng.integers(0, len(tx) - ins))
        a = list(tx[off : off + L])
        b = list(tx[off + ins - L : off + ins])
        _mutate(rng, a)
        _mutate(rng, b)
        r5.append("".join(a))
        r3.append("".join(b).translate(COMP)[::-1])
    return r5, r3


def known_snp_setup(seq: str, rng, nsites: int = 32, nsnps: int = 64):
    """Config 4 DB material: known splice junctions (low-prob ones the
    maxent scan would MISS, so -s is load-bearing) + SNP definitions.

    Returns (ss_iit_text, snps_iit_text, junctions, snps) where snps is
    [(pos0, ref, alt)] (0-based)."""
    import re

    flip = {"A": "G", "G": "A", "C": "T", "T": "C"}
    juncs = []
    p = 1000
    while len(juncs) < nsites and p < len(seq) - 6000:
        g = seq[p : p + 3000]
        m = re.search("GT", g)
        if m:
            s = p + m.start()
            e = seq.find("AG", s + 400, s + 3000)
            if e > 0:
                juncs.append((s, e + 2))
        p += 3000
    ss_lines = []
    for i, (s, e) in enumerate(juncs):
        ss_lines.append(f">j{i}.d chr17test:{s}..{s + 1} donor")
        ss_lines.append(f">j{i}.a chr17test:{e}..{e + 1} acceptor")
    snps = []
    for i in range(nsnps):
        pos = int(rng.integers(100, len(seq) - 100))
        ref = seq[pos]
        snps.append((pos, ref, flip[ref]))
    snp_lines = [f">rs{i} chr17test:{pos + 1} {ref}{alt}"
                 for i, (pos, ref, alt) in enumerate(snps)]
    return ("\n".join(ss_lines) + "\n", "\n".join(snp_lines) + "\n",
            juncs, snps)


def make_known_snp_workload(seq: str, nreads: int, rng, juncs, snps):
    """Config 4 reads: 25% across a known junction, 25% carrying an ALT
    allele, 50% plain (all with 0-2 extra mismatches)."""
    out = []
    for i in range(nreads):
        kind = i % 4
        if kind == 0 and juncs:
            s, e = juncs[int(rng.integers(0, len(juncs)))]
            off = int(rng.integers(20, 80))
            r = list(seq[s - off : s] + seq[e : e + (L - off)])
        elif kind == 1 and snps:
            pos, ref, alt = snps[int(rng.integers(0, len(snps)))]
            off = int(rng.integers(10, 90))
            start = pos - off
            if start < 0 or start + L > len(seq):
                start = max(0, min(pos - 50, len(seq) - L))
                off = pos - start
            r = list(seq[start : start + L])
            r[off] = alt
        else:
            p = int(rng.integers(0, len(seq) - L))
            r = list(seq[p : p + L])
        _mutate(rng, r, 2)
        s_ = "".join(r)
        if rng.random() < 0.5:
            s_ = s_.translate(COMP)[::-1]
        out.append(s_)
    return out


def make_cmet_workload(seq: str, nreads: int, rng) -> list[str]:
    """Config 5: bisulfite reads for --mode=cmet-stranded.  Read 1 of a
    stranded protocol: fragments of EITHER genome strand, fully C->T
    converted in read space, 0-2 extra mismatches."""
    out = []
    for _ in range(nreads):
        p = int(rng.integers(0, len(seq) - L))
        frag = seq[p : p + L]
        if rng.random() < 0.5:
            frag = frag.translate(COMP)[::-1]
        r = list(frag.replace("C", "T"))
        _mutate(rng, r, 2)
        out.append("".join(r))
    return out


def write_fastq(path, reads, prefix="r"):
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@{prefix}{i}\n{r}\n+\n{'I' * len(r)}\n")


def write_pe_fastq(p1, p2, r5, r3, prefix="p"):
    write_fastq(p1, r5, prefix)
    write_fastq(p2, r3, prefix)
