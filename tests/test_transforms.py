"""cmet/atoi/snp index transforms and mode-converted alignment tests."""

import numpy as np
import pytest

import jax.numpy as jnp

from gmap_gsnap.db import build, indexdb, transforms
from gmap_gsnap.db.iit import IIT, Interval
from gmap_gsnap.ops import genome as genome_ops
from gmap_gsnap.ops import mismatch as mm_ops
from gmap_gsnap.utils import dna


def test_convert_words_matches_scalar():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, 64).astype(np.uint8)
    packed, _ = genome_ops.pack16(codes, np.zeros(64, bool))
    for name, conv in [("ct", "ct"), ("ga", "ga"), ("ag", "ag"), ("tc", "tc")]:
        got = np.asarray(mm_ops.convert_words(jnp.asarray(packed), conv))
        want_codes = transforms.convert_codes(
            codes, {"ct": "metct", "ga": "metga", "ag": "a2iag", "tc": "a2itc"}[name]
        )
        want, _ = genome_ops.pack16(want_codes, np.zeros(64, bool))
        np.testing.assert_array_equal(got, want)


def test_cmet_mode_alignment(ref_tests):
    # a bisulfite-converted read aligns cleanly in cmet mode only
    from gmap_gsnap.align import gsnap_se

    g = build.load_genome_fasta([str(ref_tests / "ss.chr17test")])
    genome = genome_ops.GenomeArrays.from_codes(g.codes, g.flags, g.chr_ends)
    oc, pc = transforms.build_converted_index(g.codes, g.flags, g.chr_ends, "metct")
    og, pg = transforms.build_converted_index(g.codes, g.flags, g.chr_ends, "metga")
    idx_ct = gsnap_se.IndexArrays.from_host(oc, pc, 12, 3)
    idx_ga = gsnap_se.IndexArrays.from_host(og, pg, 12, 3)

    L = 100
    read = g.codes[10000 : 10000 + L].copy()
    read[read == dna.C] = dna.T  # bisulfite conversion
    codes = read[None, :]
    params = gsnap_se.GsnapParams(mode="cmet-stranded")
    res = gsnap_se.align_batch(
        genome, idx_ct, jnp.asarray(codes), jnp.zeros((1, L), bool),
        jnp.asarray(np.array([L], np.int32)), params, index_minus=idx_ga,
    )
    assert int(np.asarray(res["npaths"])[0]) >= 1
    assert int(np.asarray(res["left"])[0, 0]) == 10000
    assert int(np.asarray(res["nmm"])[0, 0]) == 0


def test_snp_alt_genome_and_tolerance(ref_tests):
    from gmap_gsnap.align import gsnap_se

    g = build.load_genome_fasta([str(ref_tests / "ss.chr17test")])
    # one SNP at position 5000 (0-based): ref base -> other allele
    snps = IIT()
    refbase = "ACGT"[g.codes[5000]]
    altbase = {"A": "G", "G": "A", "C": "T", "T": "C"}[refbase]
    t = snps.type_index(refbase + altbase)
    snps.add("chr17test", "rs1", Interval.new(5001, 5001, t))
    alt = transforms.alt_genome_from_snps(g.codes, snps, g.chr_names,
                                          np.array([0]))
    assert alt[5000] != g.codes[5000]
    assert (alt != g.codes).sum() == 1

    # a read carrying the alt allele verifies with 0 both-diff mismatches
    genome = genome_ops.GenomeArrays.from_codes(g.codes, g.flags, g.chr_ends)
    alt16, _ = genome_ops.pack16(alt, g.flags)
    alt16 = genome_ops._pad_rows(alt16, 0xFFFFFFFF)
    L = 100
    read = alt[4950 : 4950 + L][None, :]
    q = mm_ops.pack_queries(read.astype(np.uint8), np.zeros((1, L), bool),
                            np.array([L]))
    nmm_ref = mm_ops.count_mismatches(
        genome, q, jnp.asarray(np.array([4950], np.uint32)),
        jnp.zeros(1, jnp.int32), jnp.asarray(np.array([L], np.int32)),
    )
    nmm_both = mm_ops.count_mismatches(
        genome, q, jnp.asarray(np.array([4950], np.uint32)),
        jnp.zeros(1, jnp.int32), jnp.asarray(np.array([L], np.int32)),
        alt=(jnp.asarray(alt16), genome.flag16),
    )
    assert int(np.asarray(nmm_ref)[0]) == 1
    assert int(np.asarray(nmm_both)[0]) == 0


def test_snp_kmer_pairs_block_combinations():
    # two SNPs within k generate all 3 non-ref combinations per window
    codes, flags = dna.encode("A" * 40)
    pairs = transforms.snp_kmer_pairs(
        codes, flags, [40], snp_pos=[10, 12], snp_alt=[dna.C, dna.G],
        k=6, interval=1,
    )
    # window starting at 10 covers both SNPs
    oligos_at_10 = {o for o, s in pairs if s == 10}
    assert len(oligos_at_10) == 3  # C only, G only, C+G