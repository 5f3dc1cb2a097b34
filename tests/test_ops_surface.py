"""Runtime/ops surface: --split-output, --fails-as-input, read groups,
--quality-protocol, --failsonly/--nofails, --time."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
ORACLE_DB = "/tmp/refbuild/trytest/gdb"

needs_db = pytest.mark.skipif(
    not os.path.isdir(ORACLE_DB), reason="oracle DB not built")


def _genome_seq():
    return "".join(
        l.strip() for l in open("/root/reference/tests/ss.chr17test")
        if not l.startswith(">")
    ).upper()


def _make_fq(path, n=20, seed=5):
    rng = np.random.default_rng(seed)
    seq = _genome_seq()
    comp = str.maketrans("ACGT", "TGCA")
    with open(path, "w") as f:
        for i in range(n):
            L = 100
            if i % 5 == 4:
                r = "".join("ACGT"[int(c)] for c in rng.integers(0, 4, L))
            else:
                p = int(rng.integers(0, len(seq) - L))
                r = seq[p : p + L]
                if rng.random() < 0.5:
                    r = r.translate(comp)[::-1]
            f.write(f"@r{i}\n{r}\n+\n{'I' * L}\n")


def _run(args, **kw):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.gsnap", "-D", ORACLE_DB,
         "-d", "chr17test", *args],
        capture_output=True, text=True, env=env, check=True, **kw)


@needs_db
def test_split_output_and_fails_as_input(tmp_path):
    fq = tmp_path / "t.fq"
    _make_fq(str(fq))
    root = str(tmp_path / "out")
    _run(["--split-output", root, "--fails-as-input", str(fq)])
    # mapped uniquely -> unpaired_uniq; random reads -> nomapping.fq
    uniq = open(root + ".unpaired_uniq").read()
    assert uniq.startswith("@SQ") and "\tchr17test\t" in uniq
    fails = open(root + ".nomapping.fq").read()
    assert fails.count("@r") == 4  # the 4 random reads, in input format
    assert "\t" not in fails
    # plain run line count == sum of split data lines (minus headers)
    plain = _run([str(fq)]).stdout
    plain_n = sum(1 for l in plain.splitlines() if not l.startswith("@"))
    split_n = sum(
        1 for suf in ("unpaired_uniq", "unpaired_mult", "unpaired_transloc")
        if os.path.exists(root + "." + suf)
        for l in open(root + "." + suf)
        if not l.startswith("@"))
    assert plain_n == split_n + 4


@needs_db
def test_failsonly_nofails(tmp_path):
    fq = tmp_path / "t.fq"
    _make_fq(str(fq))
    only = _run(["--failsonly", str(fq)]).stdout
    only_reads = [l for l in only.splitlines() if not l.startswith("@")]
    assert len(only_reads) == 4
    assert all("\t4\t" in l.replace("\t*\t", "\t*\t") and l.split("\t")[1] == "4"
               for l in only_reads)
    nof = _run(["--nofails", str(fq)]).stdout
    nof_reads = [l for l in nof.splitlines() if not l.startswith("@")]
    assert all(l.split("\t")[1] != "4" for l in nof_reads)


@needs_db
def test_read_group_and_quality_shift(tmp_path):
    fq = tmp_path / "t.fq"
    _make_fq(str(fq), n=5, seed=9)
    out = _run(["--read-group-id", "rg1", "--read-group-name", "sample1",
                "-j", "-5", str(fq)]).stdout
    lines = out.splitlines()
    assert any(l.startswith("@RG\tID:rg1\tSM:sample1") for l in lines)
    body = [l for l in lines if not l.startswith("@")]
    assert body and all(l.endswith("RG:Z:rg1") for l in body)
    # qualities were 'I' (73); shifted by -5 -> 'D'
    assert all(set(l.split("\t")[10]) == {"D"} for l in body)


@needs_db
def test_time_flag(tmp_path):
    fq = tmp_path / "t.fq"
    _make_fq(str(fq), n=5, seed=9)
    r = _run(["--time", str(fq)])
    assert "ms/read" in r.stderr


@needs_db
def test_input_options_barcode_chastity_gunzip(tmp_path):
    """--barcode-length strips read prefixes, --filter-chastity skips
    Illumina chastity-failed reads, --gunzip accepts gzipped input
    (shortread.c:307 chastity parse; gsnap.c:131 barcode_length)."""
    import gzip
    import subprocess as sp

    seq = _genome_seq()
    fq = tmp_path / "opt.fq"
    with open(fq, "w") as f:
        f.write(f"@r1 1:N:0:ACGT\nCCCCC{seq[30000:30095]}\n+\n{'I' * 100}\n")
        f.write(f"@r2 1:Y:0:ACGT\nCCCCC{seq[31000:31095]}\n+\n{'I' * 100}\n")
    with open(fq, "rb") as f:
        gz = tmp_path / "opt.fq.gz"
        with gzip.open(gz, "wb") as g:
            g.write(f.read())
    common = ["--format=sam", "--barcode-length=5",
              "--filter-chastity=either", "--gunzip", str(gz)]
    mine = [l for l in _run(common).stdout.splitlines()
            if not l.startswith("@")]
    ref = sp.run(
        ["/tmp/refbuild/src/gsnap", "-D", ORACLE_DB, "-d", "chr17test",
         *common], capture_output=True, text=True, check=True).stdout
    refl = [l for l in ref.splitlines() if not l.startswith("@")]
    assert mine == refl
    assert len(mine) == 1 and mine[0].split("\t")[5] == "95M"


def test_gmapindex_compress_uncompress(tmp_path):
    """gmapindex -C / -U round the genomecomp codec through text,
    byte-identical to the reference actions (gmapindex.c:986-1008)."""
    import subprocess as sp

    raw = tmp_path / "raw.txt"
    raw.write_text(_genome_seq()[:100000] + "NNXN" + _genome_seq()[:37])
    env = dict(os.environ, PYTHONPATH=str(REPO))
    mine = sp.run(
        [sys.executable, "-m", "gmap_gsnap.cli.gmapindex", "-C",
         str(raw)], capture_output=True, env=env, check=True).stdout
    if os.path.exists("/tmp/refbuild/src/gmapindex"):
        ref = sp.run(["/tmp/refbuild/src/gmapindex", "-C", str(raw)],
                     capture_output=True, check=True).stdout
        assert mine == ref
    back = sp.run(
        [sys.executable, "-m", "gmap_gsnap.cli.gmapindex", "-U",
         "-w", "60"], input=mine, capture_output=True, env=env,
        check=True).stdout.decode()
    flat = back.replace("\n", "")
    orig = raw.read_text().replace("N", "N").upper()
    # trailing block pads as X
    assert flat[: len(orig)].replace("X", "N") == orig.replace("X", "N")
