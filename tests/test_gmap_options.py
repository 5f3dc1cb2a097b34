"""gmap CLI option-surface parity: the round-2 flag batch (pruning,
nosplicing, canonical-mode, suboptimal-score, cdsstart/truncate,
version/cmdline, output routing, SAM options) diffed against the
reference gmap binary where its output is sane, with pinned
expectations where the 2012 reference is buggy."""

import os
import pathlib
import subprocess
import sys

import pytest

ORACLE_GMAP = "/tmp/refbuild/src/gmap"
ORACLE_DB = "/tmp/refbuild/trytest/gdb"
REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = "/root/reference/tests/ss.chr17test"
HER2 = "/root/reference/tests/ss.her2"

needs_oracle = pytest.mark.skipif(
    not (os.path.exists(ORACLE_GMAP) and os.path.isdir(ORACLE_DB)),
    reason="reference oracle binaries not built",
)


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))


def _ours(*args):
    return subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.gmap", *args],
        capture_output=True, text=True, env=_env(), check=True,
    ).stdout


def _ref(*args):
    return subprocess.run(
        [ORACLE_GMAP, *args], capture_output=True, text=True, check=True,
    ).stdout


def _genomic_query(tmp_path):
    seq = "".join(
        l.strip() for l in open(FIXTURE) if not l.startswith(">")
    ).upper()
    fa = tmp_path / "gq.fa"
    fa.write_text(">gq\n" + seq[120000:121500] + "\n")
    return str(fa)


@needs_oracle
@pytest.mark.parametrize("flags", [
    [],                       # segment-overflow regression: this repeat-
                              # family query needs the S rescue loop
    ["--nosplicing"],
    ["-p", "1"],
    ["--canonical-mode", "0"],
    ["--suboptimal-score", "5"],
    ["--min-intronlength", "20"],
    ["-n", "1"],
    ["-S"],
    ["-f", "samse"],
])
def test_genomic_query_flag_parity(tmp_path, flags):
    fa = _genomic_query(tmp_path)
    base = ["-D", ORACLE_DB, "-d", "chr17test", *flags, fa]
    assert _ours(*base) == _ref(*base)


@needs_oracle
@pytest.mark.parametrize("flags", [
    ["-a", "181"],
    ["-Y"],
    ["-F", "-a", "181"],
])
def test_her2_translation_flag_parity(flags):
    base = ["-D", ORACLE_DB, "-d", "chr17test", "-S", *flags, HER2]
    assert _ours(*base) == _ref(*base)


@needs_oracle
def test_truncate():
    """-T truncates each path around the full-length protein
    (truncate_fulllength, stage3.c:4101).  The query-side truncation
    matches the reference; the reference's printed GENOMIC coordinates
    after -T are corrupted (stale gregion-window offsets: it reports
    chr17test:100,237 where the alignment demonstrably starts at
    110,019), so this pins OUR correct coordinates and checks the
    query range against the reference's."""
    out = _ours("-D", ORACLE_DB, "-d", "chr17test", "-S", "-T", HER2)
    ref = _ref("-D", ORACLE_DB, "-d", "chr17test", "-S", "-T", HER2)
    assert "query 239..4006 (3768 bp)" in out
    assert "query 239..4006 (3768 bp)" in ref
    assert "chr17test:110,019..137,824" in out
    assert "Translation: 239..4006 (1255 aa)" in out
    assert "Translation: 239..4006 (1255 aa)" in ref


def test_version_and_cmdline(tmp_path):
    v = _ours("--version")
    assert "GMAP" in v
    seq = "".join(
        l.strip() for l in open(FIXTURE) if not l.startswith(">")
    ).upper()
    gs = seq[120000:120400]
    out = _ours("--cmdline", f"{gs},{gs[50:350]}")
    assert "Paths (1):" in out
    assert "query 1..300 (300 bp)" in out


@needs_oracle
def test_split_output_and_fails(tmp_path):
    """--split-output routes per-category files (.uniq/.mult/.nomapping,
    outbuffer.c:560-650); --fails-as-input emits .nomapping.fa."""
    seq = "".join(
        l.strip() for l in open(FIXTURE) if not l.startswith(">")
    ).upper()
    fa = tmp_path / "mix.fa"
    fa.write_text(
        ">hit\n" + seq[120000:120400] + "\n"
        ">miss\n" + "ACGT" * 100 + "\n")
    root = str(tmp_path / "out")
    _ours("-D", ORACLE_DB, "-d", "chr17test",
          "--split-output", root, str(fa))
    uniq = open(root + ".uniq").read()
    nomap = open(root + ".nomapping").read()
    assert ">hit" in uniq and ">miss" not in uniq
    assert ">miss" in nomap and "Paths (0):" in nomap
    # fails-as-input: failed reads re-emitted as FASTA
    _ours("-D", ORACLE_DB, "-d", "chr17test",
          "--split-output", root + "2", "--fails-as-input", str(fa))
    fails = open(root + "2.nomapping.fa").read()
    assert fails.startswith(">miss\n")
    # failsonly / nofails on stdout
    only = _ours("-D", ORACLE_DB, "-d", "chr17test", "--failsonly", str(fa))
    assert ">miss" in only and ">hit" not in only
    none = _ours("-D", ORACLE_DB, "-d", "chr17test", "--nofails", str(fa))
    assert ">hit" in none and ">miss" not in none


@needs_oracle
def test_sam_options(tmp_path):
    seq = "".join(
        l.strip() for l in open(FIXTURE) if not l.startswith(">")
    ).upper()
    fa = tmp_path / "q.fa"
    fa.write_text(">q1\n" + seq[120000:120400] + "\n")
    out = _ours("-D", ORACLE_DB, "-d", "chr17test", "-f", "samse",
                "--read-group-id", "rg1", "--read-group-name", "s1",
                str(fa))
    assert "@RG\tID:rg1\tSM:s1" in out
    body = [l for l in out.splitlines() if not l.startswith("@")]
    assert all("RG:Z:rg1" in l for l in body)
    out2 = _ours("-D", ORACLE_DB, "-d", "chr17test", "-f", "samse",
                 "--no-sam-headers", str(fa))
    assert not out2.startswith("@")


@needs_oracle
def test_quiet_if_excessive(tmp_path):
    """--quiet-if-excessive: no output when npaths > -n (printp=false,
    outbuffer.c:1610); samse emits a nomapping record instead."""
    seq = "".join(
        l.strip() for l in open(FIXTURE) if not l.startswith(">")
    ).upper()
    # a repetitive query with many paths
    fa = tmp_path / "rep.fa"
    fa.write_text(">rep\n" + seq[700:1100] + "\n")
    loud = _ours("-D", ORACLE_DB, "-d", "chr17test", "-n", "1", str(fa))
    quiet = _ours("-D", ORACLE_DB, "-d", "chr17test", "-n", "1",
                  "--quiet-if-excessive", str(fa))
    if "Paths (1):" in loud:
        pytest.skip("query not multimapping in this DB")
    assert quiet.strip() == ""


@needs_oracle
def test_mapexons(tmp_path):
    """-e/--mapexons: one map-hit block per exon (print_exon_map,
    stage3.c:4674), diffed against the reference binary."""
    import shutil

    gdb = tmp_path / "gdb"
    dbdir = gdb / "chr17test"
    shutil.copytree(f"{ORACLE_DB}/chr17test", dbdir)
    mapsdir = dbdir / "chr17test.maps"
    mapsdir.mkdir(exist_ok=True)
    from gmap_gsnap.db.iit_text import iit_from_text

    iit_from_text(
        ">g1 chr17test:109700..110200 first\n"
        ">g2 chr17test:116000..130000 middle\n"
        ">g3 chr17test:137000..138500 last\n"
    ).write(str(mapsdir / "genes.iit"))
    base = ["-D", str(gdb), "-d", "chr17test", "-S", "-m", "genes",
            "-e", HER2]
    assert _ours(*base) == _ref(*base)
