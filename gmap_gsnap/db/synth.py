"""Seeded synthetic genomes with planted genes, and reads simulated from them.

A genome is uniform random sequence split into chromosomes, with genes of
several exons planted on the plus strand.  Every intron is canonical GT-AG
and carries strong donor and acceptor consensus sequences, so the maxent
splice models score it high and novel-splice detection can find it.
Everything derives from one ``seed``: the same arguments give the same
genome, genes and reads.

Coordinates are 0-based and chromosome-relative unless named ``universal``;
exons and introns are half-open ``(start, end)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_LUT = np.frombuffer(b"ACGT", np.uint8)
_CODE = np.zeros(256, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i

# donor: exon ends ...CAG, intron starts GTAAGT (maxent donor window is
# 3 exonic + 6 intronic nt); acceptor: intron ends with a pyrimidine tract
# and CAG, exon starts with G (window 20 intronic + 3 exonic nt)
DONOR_EXON = b"CAG"
DONOR_INTRON = b"GTAAGT"
ACCEPTOR_INTRON = b"TTTCTTTTCCTTTTTTCCAG"
ACCEPTOR_EXON = b"G"

EXONS = (3, 8)              # exons per gene, inclusive
EXON_LEN = (80, 300)        # nt, inclusive
INTRON_LEN = (80, 10_000)   # nt, log-uniform
READ_LEN = 100
INSERT = (200, 600)         # fragment length, inclusive
MIN_OVERHANG = 15           # nt each side for a read to count as spliced


@dataclass
class Gene:
    chrom: int                      # index into SynthGenome.names
    exons: list[tuple[int, int]]    # ascending, chromosome-relative

    @property
    def introns(self) -> list[tuple[int, int]]:
        return [(a[1], b[0]) for a, b in zip(self.exons, self.exons[1:])]


@dataclass
class SynthGenome:
    names: list[str]
    codes: np.ndarray               # uint8 2-bit codes, chromosomes concatenated
    chr_starts: np.ndarray          # int64 universal start of each chromosome
    genes: list[Gene]

    @property
    def chr_ends(self) -> np.ndarray:
        return np.append(self.chr_starts[1:], len(self.codes))

    def chrom_codes(self, c: int) -> np.ndarray:
        return self.codes[self.chr_starts[c]:self.chr_ends[c]]

    def write_fasta(self, path: str, width: int = 80) -> None:
        """One record per chromosome, ``width`` nt per line."""
        with open(path, "wb") as f:
            for c, name in enumerate(self.names):
                f.write(b">" + name.encode() + b"\n")
                seq = _LUT[self.chrom_codes(c)]
                full = len(seq) // width * width
                rows = np.empty((full // width, width + 1), np.uint8)
                rows[:, :width] = seq[:full].reshape(-1, width)
                rows[:, width] = ord("\n")
                f.write(rows.tobytes())
                if full < len(seq):
                    f.write(seq[full:].tobytes() + b"\n")

    def transcript(self, gene: Gene) -> np.ndarray:
        chrom = self.chrom_codes(gene.chrom)
        return np.concatenate([chrom[s:e] for s, e in gene.exons])


def _plant(chrom: np.ndarray, at: int, motif: bytes) -> None:
    chrom[at:at + len(motif)] = _CODE[np.frombuffer(motif, np.uint8)]


def make_genome(total_len: int, nchrom: int, ngenes: int,
                seed: int) -> SynthGenome:
    """Uniform random genome of ``total_len`` nt in ``nchrom`` chromosomes
    named chr1.., with ``ngenes`` plus-strand genes of EXONS exons of
    EXON_LEN nt.  Intron lengths are log-uniform over INTRON_LEN; genes
    never overlap and keep 1 kb from chromosome ends."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, total_len, dtype=np.uint8)
    bounds = np.linspace(0, total_len, nchrom + 1).astype(np.int64)
    chr_starts = bounds[:-1]
    names = [f"chr{i + 1}" for i in range(nchrom)]

    # per chromosome, genes go into equal slots, one gene per slot
    per_chrom = np.bincount(np.arange(ngenes) % nchrom, minlength=nchrom)
    genes: list[Gene] = []
    for c in range(nchrom):
        chrom = codes[bounds[c]:bounds[c + 1]]
        n = int(per_chrom[c])
        if n == 0:
            continue
        slot = (len(chrom) - 2000) // n
        for g in range(n):
            nex = int(rng.integers(EXONS[0], EXONS[1] + 1))
            elen = rng.integers(EXON_LEN[0], EXON_LEN[1] + 1, nex)
            ilen = np.exp(rng.uniform(np.log(INTRON_LEN[0]),
                                      np.log(INTRON_LEN[1]), nex - 1))
            ilen = ilen.astype(np.int64)
            span = int(elen.sum() + ilen.sum())
            if span > slot:
                raise ValueError(f"genome too small for {ngenes} genes")
            pos = 1000 + g * slot + int(rng.integers(0, slot - span + 1))
            exs = []
            for j in range(nex):
                exs.append((pos, pos + int(elen[j])))
                pos += int(elen[j])
                if j < nex - 1:
                    pos += int(ilen[j])
            for (_, d), (a, _) in zip(exs, exs[1:]):
                _plant(chrom, d - len(DONOR_EXON), DONOR_EXON + DONOR_INTRON)
                _plant(chrom, a - len(ACCEPTOR_INTRON),
                       ACCEPTOR_INTRON + ACCEPTOR_EXON)
            genes.append(Gene(c, exs))
    return SynthGenome(names, codes, chr_starts, genes)


# ------------------------------------------------------------------ reads

def _revcomp(codes: np.ndarray) -> np.ndarray:
    return codes[::-1] ^ np.uint8(3)


def _substitute(rng, codes: np.ndarray, nmax: int) -> np.ndarray:
    """Copy with 0..nmax substitutions, each to a different base."""
    out = codes.copy()
    for p in rng.choice(len(out), int(rng.integers(0, nmax + 1)),
                        replace=False):
        out[p] = (out[p] + rng.integers(1, 4)) % 4
    return out


def to_str(codes: np.ndarray) -> str:
    return _LUT[codes].tobytes().decode()


@dataclass
class ReadTruth:
    """Where a simulated read came from: its leftmost genomic base and
    the planted introns it crosses with at least MIN_OVERHANG nt on each
    side."""
    chrom: int
    left: int                       # chromosome-relative, 0-based
    introns: list[tuple[int, int]]


def _tx_to_genome(gene: Gene, t0: int, t1: int):
    """Map transcript interval [t0, t1) to (leftmost genomic base,
    introns crossed with >= MIN_OVERHANG nt of the interval on each
    side)."""
    cum = np.cumsum([0] + [e - s for s, e in gene.exons])
    j = int(np.searchsorted(cum, t0, side="right")) - 1
    left = gene.exons[j][0] + (t0 - int(cum[j]))
    introns = []
    for i, (a, b) in enumerate(gene.introns):
        jx = int(cum[i + 1])        # transcript coordinate of the junction
        if t0 + MIN_OVERHANG <= jx <= t1 - MIN_OVERHANG:
            introns.append((a, b))
    return left, introns


def simulate_pairs(g: SynthGenome, npairs: int, seed: int,
                   spliced_share: float = 0.3, nsub: int = 3):
    """Paired-end FR reads of READ_LEN nt from fragments of INSERT nt,
    0..nsub substitutions per end.  About ``spliced_share`` of the pairs
    come from planted transcripts, with read 1 across an exon junction
    with at least MIN_OVERHANG nt each side; the rest from uniform
    genomic positions.  Each fragment is flipped to the minus strand
    with probability 1/2.  Returns (reads1, reads2, truths1, truths2)."""
    rng = np.random.default_rng(seed)
    r1, r2, t1, t2 = [], [], [], []
    txs = [g.transcript(x) for x in g.genes]

    def spliced_fragment(ins):
        # draw genes until one has a junction that read 1 can cover with
        # the fragment still inside the transcript
        for _ in range(100):
            gi = int(rng.integers(0, len(g.genes)))
            gene, tx = g.genes[gi], txs[gi]
            cum = np.cumsum([e - s for s, e in gene.exons])[:-1]
            jx = int(cum[rng.integers(0, len(cum))])
            lo = max(0, jx - READ_LEN + MIN_OVERHANG)
            hi = min(jx - MIN_OVERHANG, len(tx) - ins)
            if lo <= hi:
                f0 = int(rng.integers(lo, hi + 1))
                fa = (f0, f0 + READ_LEN)
                fb = (f0 + ins - READ_LEN, f0 + ins)
                return (tx[slice(*fa)], tx[slice(*fb)],
                        ReadTruth(gene.chrom, *_tx_to_genome(gene, *fa)),
                        ReadTruth(gene.chrom, *_tx_to_genome(gene, *fb)))
        raise ValueError("no planted transcript fits the insert length")

    for _ in range(npairs):
        ins = int(rng.integers(INSERT[0], INSERT[1] + 1))
        if rng.random() < spliced_share:
            a, b, ta, tb = spliced_fragment(ins)
        else:
            c = int(rng.integers(0, len(g.names)))
            chrom = g.chrom_codes(c)
            p = int(rng.integers(0, len(chrom) - ins))
            a, b = chrom[p:p + READ_LEN], chrom[p + ins - READ_LEN:p + ins]
            ta, tb = ReadTruth(c, p, []), ReadTruth(c, p + ins - READ_LEN, [])
        b = _revcomp(b)
        if rng.random() < 0.5:
            a, b, ta, tb = b, a, tb, ta
        r1.append(to_str(_substitute(rng, a, nsub)))
        r2.append(to_str(_substitute(rng, b, nsub)))
        t1.append(ta)
        t2.append(tb)
    return r1, r2, t1, t2


def simulate_single(g: SynthGenome, nreads: int, seed: int, nsub: int = 3):
    """Single-end reads of READ_LEN nt from uniform genomic positions,
    0..nsub substitutions, half reverse-complemented.  Returns (reads,
    truths)."""
    rng = np.random.default_rng(seed)
    reads, truths = [], []
    for _ in range(nreads):
        c = int(rng.integers(0, len(g.names)))
        chrom = g.chrom_codes(c)
        p = int(rng.integers(0, len(chrom) - READ_LEN))
        r = chrom[p:p + READ_LEN]
        if rng.random() < 0.5:
            r = _revcomp(r)
        reads.append(to_str(_substitute(rng, r, nsub)))
        truths.append(ReadTruth(c, p, []))
    return reads, truths


def simulate_cdnas(g: SynthGenome, n: int, seed: int, nsub: int = 2):
    """Full-length spliced cDNAs of ``n`` distinct planted genes, 0..nsub
    substitutions.  Returns (sequences, genes)."""
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(g.genes), n, replace=False)
    genes = [g.genes[int(i)] for i in pick]
    seqs = [to_str(_substitute(rng, g.transcript(x), nsub)) for x in genes]
    return seqs, genes


def write_fastq(path: str, reads: list[str], prefix: str) -> None:
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@{prefix}{i}\n{r}\n+\n{'I' * len(r)}\n")


def write_fasta_queries(path: str, seqs: list[str], prefix: str) -> None:
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            f.write(f">{prefix}{i}\n{s}\n")
