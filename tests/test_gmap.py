"""GMAP spliced-alignment tests against the shipped golden fixtures
(tests/map.test.ok — byte parity; align.test.ok — exon structure)."""

import re

import numpy as np
import pytest

from gmap_gsnap.align import gmap as gmap_mod
from gmap_gsnap.align import translation as tr
from gmap_gsnap.db import build
from gmap_gsnap.db.datadir import GenomeDB
from gmap_gsnap.io import fasta, gmap_out
from gmap_gsnap.utils import dna


@pytest.fixture(scope="module")
def chr17db(ref_tests, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gmapdb")
    dbdir = build.build_db([str(ref_tests / "ss.chr17test")], "chr17test", str(tmp), k=12)
    return GenomeDB.open(dbdir, "chr17test")


@pytest.fixture(scope="module")
def her2_path(chr17db, ref_tests):
    rec = next(fasta.read_fasta(str(ref_tests / "ss.her2")))
    return rec, gmap_mod.align_cdna(chr17db, rec.seq)


def test_her2_exon_structure(her2_path, ref_tests):
    # golden exon table from align.test.ok: "    109781-110091  (1-311)   100%"
    golden = []
    for line in (ref_tests / "align.test.ok").read_text().splitlines():
        m = re.match(r"\s+(\d+)-(\d+)\s+\((\d+)-(\d+)\)\s+100%", line)
        if m:
            golden.append(tuple(int(x) for x in m.groups()))
    assert len(golden) == 27
    rec, path = her2_path
    assert path is not None and path.watsonp and path.cdna_direction > 0
    got = [(e.gstart + 1, e.gend, e.qstart + 1, e.qend) for e in path.exons]
    assert got == golden
    assert path.matches == 4624 and path.mismatches == 0
    assert all(t == "canonical" for t in path.intron_types)


def test_her2_summary_byte_parity(her2_path, chr17db, ref_tests):
    rec, path = her2_path
    gstr = dna.decode(chr17db.codes, chr17db.flags)
    out = gmap_out.paths_output(
        rec.header, [path], "chr17test", 200000, rec.seq.upper(), gstr, dbmode=True
    )
    golden = (ref_tests / "map.test.ok").read_text()
    assert out == golden


def test_translation_orf():
    assert tr.get_codon("A", "T", "G") == "M"
    assert tr.get_codon("T", "A", "G") == "*"
    assert tr.get_codon("T", "G", "G") == "W"

    # post-stop ORFs require a Met; the initial ORF does not.
    # Build an aa-column array directly: frame 0 = F G * M P A *,
    # other frames blank.
    aa = [" "] * 21
    for i, c in zip(range(0, 21, 3), "FG*MPA*"):
        aa[i] = c
    frame, starti, endi, length, endstopp = tr.find_bounds_forward(aa)
    assert frame == 0
    assert (starti, endi) == (9, 18)  # M..* (post-stop ORF starts at M)
    assert length == 4 and endstopp  # M P A * = 4 incl stop

    # without any M, only the initial ORF counts
    aa2 = [" "] * 15
    for i, c in zip(range(0, 15, 3), "F*GGG"):
        aa2[i] = c
    f2, s2, e2, l2, stop2 = tr.find_bounds_forward(aa2)
    assert f2 == 0 and (s2, e2, l2) == (0, 3, 2) and stop2


def test_gmap_minus_strand(chr17db):
    # a revcomp'd spliced query maps to the minus strand
    gstr = dna.decode(chr17db.codes, chr17db.flags)
    q = gstr[50000:50200] + gstr[51000:51200]
    # only meaningful if the plus junction is intron-like; use revcomp
    qrc = dna.revcomp_str(q)
    path = gmap_mod.align_cdna(chr17db, qrc)
    assert path is not None
    assert not path.watsonp
    assert path.gstart == 50000 and path.gend == 51200


def test_gmap_samse_oracle_parity(chr17db, ref_tests, tmp_path):
    """gmap -f samse byte parity vs the reference binary (HER2 both
    strands + mutated / deletion-bearing queries)."""
    import os
    import pathlib
    import random
    import subprocess
    import sys

    oracle = "/tmp/refbuild/src/gmap"
    odb = "/tmp/refbuild/trytest/gdb"
    if not os.path.exists(oracle):
        pytest.skip("reference oracle binaries not built")

    random.seed(31)
    seq = "".join(
        l.strip() for l in open(ref_tests / "ss.chr17test") if not l.startswith(">")
    ).upper()
    her2 = next(fasta.read_fasta(str(ref_tests / "ss.her2")))
    queries = [("her2", her2.seq), ("her2rc", dna.revcomp_str(her2.seq.upper()))]
    q = list(seq[120000:120800])
    for _ in range(8):
        q[random.randrange(len(q))] = random.choice("ACGT")
    queries.append(("mut800", "".join(q)))
    queries.append(("del5", seq[130000:130400] + seq[130405:130800]))

    fa = tmp_path / "q.fa"
    with open(fa, "w") as f:
        for n, s in queries:
            f.write(f">{n}\n{s}\n")

    ref = subprocess.run(
        [oracle, "-D", odb, "-d", "chr17test", "-f", "samse", str(fa)],
        capture_output=True, text=True, check=True,
    ).stdout
    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(repo))
    mine = subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.gmap", "-D", odb,
         "-d", "chr17test", "-f", "samse", str(fa)],
        capture_output=True, text=True, env=env, check=True,
    ).stdout
    assert ref.splitlines() == mine.splitlines()


def test_align_golden_byte_parity(ref_tests, tmp_path):
    """gmap -A -g == tests/align.test.ok (the shipped ALIGNMENT golden)."""
    import os
    import pathlib
    import subprocess
    import sys

    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(repo))
    out = subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.gmap", "-A", "-g",
         str(ref_tests / "ss.chr17test"), str(ref_tests / "ss.her2")],
        capture_output=True, text=True, env=env, check=True,
    ).stdout
    golden = open(ref_tests / "align.test.ok").read()
    assert out == golden


def test_gmap_formats_oracle_parity(ref_tests):
    """psl/splicesites/introns/map/compressed/exons/protein formats vs
    the reference binary on HER2 (both strands where supported)."""
    import os
    import pathlib
    import subprocess
    import sys

    oracle = "/tmp/refbuild/src/gmap"
    odb = "/tmp/refbuild/trytest/gdb"
    if not os.path.exists(oracle):
        pytest.skip("reference oracle not built")
    her2 = str(ref_tests / "ss.her2")
    rc = dna.revcomp_str(next(fasta.read_fasta(her2)).seq.upper())
    import tempfile

    rcfa = tempfile.NamedTemporaryFile("w", suffix=".fa", delete=False)
    rcfa.write(">her2rc\n" + rc + "\n")
    rcfa.close()
    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(repo))

    both = [her2, rcfa.name]
    cases = [(["-f", "psl"], both), (["-f", "splicesites"], both),
             (["-f", "introns"], both), (["-f", "map_genes"], both),
             (["-f", "map_exons"], both), (["-Z"], both),
             (["-E", "cdna"], [her2]), (["-E", "genomic"], [her2]),
             (["-P"], [her2]), (["-Q"], [her2]),
             (["-3"], both), (["-4"], [her2]), (["-f", "sampe"], both)]
    for opts, inputs in cases:
        ref = subprocess.run(
            [oracle, "-D", odb, "-d", "chr17test", *opts, *inputs],
            capture_output=True, text=True, check=True,
        ).stdout
        mine = subprocess.run(
            [sys.executable, "-m", "gmap_gsnap.cli.gmap", "-D", odb,
             "-d", "chr17test", *opts, *inputs],
            capture_output=True, text=True, env=env, check=True,
        ).stdout
        assert mine == ref, opts


def test_summary_and_minus_strand_formats(ref_tests, tmp_path):
    """gmap -S (summary + exon table with probs), and minus-strand
    -S/-P/-Q/-E: antisense display direction, signed genomic span,
    backward translation coordinates, phase omission rules."""
    import os
    import pathlib
    import subprocess
    import sys

    oracle = "/tmp/refbuild/src/gmap"
    odb = "/tmp/refbuild/trytest/gdb"
    if not os.path.exists(oracle):
        pytest.skip("reference oracle binaries not built")

    her2 = str(ref_tests / "ss.her2")
    lines = open(her2).read().split("\n")
    seq = "".join(l for l in lines[1:] if l)
    rc = seq[:1200].translate(str.maketrans("ACGTacgt", "TGCAtgca"))[::-1]
    fam = tmp_path / "her2m.fa"
    with open(fam, "w") as f:
        f.write(">her2m test minus\n")
        for i in range(0, len(rc), 60):
            f.write(rc[i : i + 60] + "\n")
    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(repo))
    cases = [(["-S"], her2), (["-S"], str(fam)), (["-P"], str(fam)),
             (["-Q"], str(fam)), (["-E", "cdna"], str(fam)),
             (["-E", "genomic"], str(fam))]
    for opts, inp in cases:
        ref = subprocess.run(
            [oracle, "-D", odb, "-d", "chr17test", *opts, inp],
            capture_output=True, text=True, check=True,
        ).stdout
        mine = subprocess.run(
            [sys.executable, "-m", "gmap_gsnap.cli.gmap", "-D", odb,
             "-d", "chr17test", *opts, inp],
            capture_output=True, text=True, env=env, check=True,
        ).stdout
        assert ref.splitlines() == mine.splitlines(), (opts, inp)


def test_gff3_match_and_coords_formats(ref_tests, tmp_path):
    """gff3_match_cdna / gff3_match_est / coords byte parity on plus,
    minus, and indel-bearing queries (Gap attributes, '?' strand for
    intron-less paths, dual-phase coords rows around indels)."""
    import os
    import pathlib
    import subprocess
    import sys

    oracle = "/tmp/refbuild/src/gmap"
    odb = "/tmp/refbuild/trytest/gdb"
    if not os.path.exists(oracle):
        pytest.skip("reference oracle binaries not built")

    her2 = str(ref_tests / "ss.her2")
    lines = open(her2).read().split("\n")
    hseq = "".join(l for l in lines[1:] if l)
    rcq = hseq[:1200].translate(str.maketrans("ACGTacgt", "TGCAtgca"))[::-1]
    seq = "".join(
        l.strip() for l in open(ref_tests / "ss.chr17test")
        if not l.startswith(">")
    ).upper()
    qfa = tmp_path / "q.fa"
    with open(qfa, "w") as f:
        f.write(">her2m test minus\n" + rcq + "\n")
        f.write(">del5\n" + seq[130000:130400] + seq[130405:130800] + "\n")
        f.write(">ins5\n" + seq[140000:140300] + "ACGTA"
                + seq[140300:140600] + "\n")
    repo = pathlib.Path(__file__).resolve().parent.parent
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(repo))
    for opts in (["-f", "gff3_match_cdna"], ["-f", "gff3_match_est"],
                 ["-f", "coords"], ["-Z"]):
        for inp in (her2, str(qfa)):
            ref = subprocess.run(
                [oracle, "-D", odb, "-d", "chr17test", *opts, inp],
                capture_output=True, text=True, check=True,
            ).stdout
            mine = subprocess.run(
                [sys.executable, "-m", "gmap_gsnap.cli.gmap", "-D", odb,
                 "-d", "chr17test", *opts, inp],
                capture_output=True, text=True, env=env, check=True,
            ).stdout
            assert ref.splitlines() == mine.splitlines(), (opts, inp)
