"""Seeded synthetic genome and read simulation (db/synth.py)."""

import numpy as np
import pytest

from gmap_gsnap.db import synth
from gmap_gsnap.ops.maxent import splice_prob_np


@pytest.fixture(scope="module")
def genome():
    return synth.make_genome(1_000_000, 4, 24, seed=3)


def test_deterministic(genome):
    again = synth.make_genome(1_000_000, 4, 24, seed=3)
    assert np.array_equal(again.codes, genome.codes)
    assert [g.exons for g in again.genes] == [g.exons for g in genome.genes]
    other = synth.make_genome(1_000_000, 4, 24, seed=4)
    assert not np.array_equal(other.codes, genome.codes)
    a = synth.simulate_pairs(genome, 32, 9)
    b = synth.simulate_pairs(genome, 32, 9)
    assert a[0] == b[0] and a[1] == b[1]


def test_chromosome_sizes(genome):
    assert genome.names == ["chr1", "chr2", "chr3", "chr4"]
    sizes = genome.chr_ends - genome.chr_starts
    assert sizes.sum() == 1_000_000 and set(sizes) == {250_000}


def test_genes_have_gt_ag_introns(genome):
    assert len(genome.genes) == 24
    for g in genome.genes:
        assert 3 <= len(g.exons) <= 8
        chrom = synth.to_str(genome.chrom_codes(g.chrom))
        for a, b in g.introns:
            assert 80 <= b - a <= 10_000
            assert chrom[a:a + 2] == "GT" and chrom[b - 2:b] == "AG"
        for s, e in g.exons:
            assert 80 <= e - s <= 300
    # genes do not overlap
    spans = sorted((g.chrom, g.exons[0][0], g.exons[-1][1])
                   for g in genome.genes)
    for x, y in zip(spans, spans[1:]):
        assert x[0] != y[0] or x[2] <= y[1]


def test_planted_sites_score_high(genome):
    don, acc = [], []
    for g in genome.genes:
        base = int(genome.chr_starts[g.chrom])
        don += [base + a for a, _ in g.introns]
        acc += [base + b for _, b in g.introns]
    assert splice_prob_np(genome.codes, np.array(don), "donor").min() > 0.99
    assert splice_prob_np(genome.codes, np.array(acc), "acceptor").min() > 0.99


def test_fasta_roundtrip(genome, tmp_path):
    from gmap_gsnap.db import build

    path = tmp_path / "g.fa"
    genome.write_fasta(str(path))
    g = build.load_genome_fasta([str(path)])
    assert g.chr_names == genome.names
    assert np.array_equal(g.codes, genome.codes)
    assert np.array_equal(g.chr_ends, genome.chr_ends)


def test_pair_truths_match_sequence(genome):
    """With no substitutions each read equals the genome at its truth:
    its left end, then the listed introns skipped.  Only reads whose
    span crosses an intron by less than the minimum overhang (which the
    truth does not list) may differ."""
    r1, r2, t1, t2 = synth.simulate_pairs(genome, 200, 5, nsub=0)
    assert 0.2 < np.mean([bool(t.introns) for t in t1 + t2]) < 0.5
    comp = str.maketrans("ACGT", "TGCA")
    matched = 0
    for r, t in zip(r1 + r2, t1 + t2):
        chrom = synth.to_str(genome.chrom_codes(t.chrom))
        pieces, pos, need = [], t.left, len(r)
        for a, b in t.introns:
            pieces.append(chrom[pos:a])
            need -= a - pos
            pos = b
        pieces.append(chrom[pos:pos + need])
        fwd = "".join(pieces)
        ok = r in (fwd, fwd[::-1].translate(comp))
        assert ok or not t.introns
        matched += ok
    assert matched >= 0.9 * len(r1 + r2)


def test_cdnas_are_transcripts(genome):
    seqs, genes = synth.simulate_cdnas(genome, 5, 2, nsub=0)
    for s, g in zip(seqs, genes):
        assert s == synth.to_str(genome.transcript(g))
