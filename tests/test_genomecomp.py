"""Byte-parity of the 2-bit genome store vs the reference golden file."""

import numpy as np

from gmap_gsnap.db import genomecomp
from gmap_gsnap.io import fasta
from gmap_gsnap.utils import dna


def test_genomecomp_byte_parity(ref_tests, tmp_path):
    recs = list(fasta.read_fasta(str(ref_tests / "ss.chr17test")))
    assert len(recs) == 1 and recs[0].label == "chr17test"
    codes, flags = dna.encode(recs[0].seq)
    out = tmp_path / "chr17test.genomecomp"
    genomecomp.write(str(out), codes, flags)
    golden = (ref_tests / "setup.genomecomp.ok").read_bytes()
    assert out.read_bytes() == golden


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    n = 1000
    codes = rng.integers(0, 4, n).astype(np.uint8)
    flags = rng.random(n) < 0.05
    # flags force code to A or T on disk per the format: emulate N/X input
    codes[flags & (codes == 1)] = 0
    codes[flags & (codes == 2)] = 3
    words = genomecomp.pack(codes, flags)
    codes2, flags2 = genomecomp.unpack(words, n)
    np.testing.assert_array_equal(codes, codes2)
    np.testing.assert_array_equal(flags, flags2)


def test_decode_n_and_x():
    codes, flags = dna.encode("ACGTNX")
    assert dna.decode(codes, flags) == "ACGTNX"
    assert dna.decode(codes) == "ACGTAT"
