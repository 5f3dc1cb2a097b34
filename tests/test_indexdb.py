"""Byte-parity of the k-mer positions index vs the reference golden file,
plus gamma offsets roundtrip."""

import numpy as np

from gmap_gsnap.db import build, indexdb
from gmap_gsnap.io import fasta
from gmap_gsnap.utils import dna


def _chr17(ref_tests):
    rec = next(fasta.read_fasta(str(ref_tests / "ss.chr17test")))
    codes, flags = dna.encode(rec.seq)
    return codes, flags, np.array([len(codes)], dtype=np.int64)


def test_positions_byte_parity(ref_tests, tmp_path):
    codes, flags, ends = _chr17(ref_tests)
    offsets, positions = indexdb.build_index(codes, flags, ends, k=12, interval=3)
    out = tmp_path / "pos"
    indexdb.write_positions(str(out), positions)
    golden = (ref_tests / "setup.ref123positions.ok").read_bytes()
    assert out.read_bytes() == golden
    assert int(offsets[-1]) == len(positions)


def test_gamma_offsets_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    k, basesize = 7, 5
    oligospace = 4**k
    counts = rng.poisson(0.3, oligospace)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.uint32)
    gp, oc = str(tmp_path / "gp"), str(tmp_path / "oc")
    indexdb.write_offsets_gamma(gp, oc, offsets, basesize, k)
    back = indexdb.read_offsets_gamma(gp, oc, basesize, k)
    np.testing.assert_array_equal(offsets, back)


def test_build_db_and_discover(ref_tests, tmp_path):
    dbdir = build.build_db([str(ref_tests / "ss.chr17test")], "chr17test", str(tmp_path), k=12)
    files = indexdb.index_filenames(dbdir, "chr17test")
    assert files is not None and files["k"] == 12 and files["interval"] == 3
    offsets = indexdb.read_offsets(files)
    positions = indexdb.read_positions(files["positions"])
    golden = (ref_tests / "setup.ref123positions.ok").read_bytes()
    assert positions.astype("<u4").tobytes() == golden
    assert int(offsets[-1]) == len(positions)


def test_fa_coords_parity(ref_tests):
    text = build.fa_coords_text([str(ref_tests / "ss.chr17test")])
    golden = (ref_tests / "coords1.test.ok").read_text()
    assert text == golden


def test_index_respects_chromosome_boundaries():
    # two chromosomes; k-mers may not span the boundary and sampling restarts
    codes1, flags1 = dna.encode("ACGTACGTACGT")  # 12
    codes2, flags2 = dna.encode("GGGGCCCCAAAATTTT")  # 16
    codes = np.concatenate([codes1, codes2])
    flags = np.concatenate([flags1, flags2])
    ends = np.array([12, 28], dtype=np.int64)
    offsets, positions = indexdb.build_index(codes, flags, ends, k=6, interval=3)
    # all stored positions must have their 6-mer inside one chromosome
    for p in positions:
        assert (p + 6 <= 12) or (p >= 12)
    # chromosome-relative sampling: (pos - chrstart) % 3 == 0
    for p in positions:
        start = 0 if p + 6 <= 12 else 12
        assert (p - start) % 3 == 0
