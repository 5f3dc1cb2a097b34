"""GMAP chimera detection (check_for_chimera + Chimera_bestpath):
two-part alignments with breakpoint, -S and samse byte parity."""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
ORACLE = "/tmp/refbuild/src/gmap"
ORACLE_DB = "/tmp/refbuild/trytest/gdb"

needs_oracle = pytest.mark.skipif(
    not os.path.exists(ORACLE), reason="reference oracle not built")


def _genome():
    return "".join(
        l.strip() for l in open("/root/reference/tests/ss.chr17test")
        if not l.startswith(">")
    ).upper()


def _rc(s):
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def _run_both(fa, args):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    ref = subprocess.run(
        [ORACLE, "-D", ORACLE_DB, "-d", "chr17test", *args, str(fa)],
        capture_output=True, text=True, check=True).stdout
    mine = subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.gmap", "-D", ORACLE_DB,
         "-d", "chr17test", *args, str(fa)],
        capture_output=True, text=True, env=env, check=True).stdout
    return ref, mine


@needs_oracle
def test_chimera_parity(tmp_path):
    g = _genome()
    fa = tmp_path / "chim.fa"
    queries = [
        ("chim1", g[20000:20300] + g[150000:150300]),
        ("chim2", g[60000:60250] + g[110000:110250]),
        # non-chimeric control: must NOT split
        ("plain", g[80000:80600]),
    ]
    with open(fa, "w") as f:
        for n, q in queries:
            f.write(f">{n}\n{q}\n")
    for args in (["-S"], ["-f", "samse"]):
        ref, mine = _run_both(fa, args)
        assert ref == mine, (args, [
            (a, b) for a, b in zip(ref.splitlines(), mine.splitlines())
            if a != b][:4])
    ref, _ = _run_both(fa, ["-S"])
    assert ref.count("Possible chimera") == 1

    # -A alignment blocks: merged-ORF aa rows continue across the two
    # hard-clipped parts with continuous numbering, and the coordinate
    # gutter widens with the label length (compute_margin, pair.c:434).
    # chim1 is byte-exact; chim2 retains a 2-line divergence in the
    # 3 bp breakpoint-overlap label + a trailing partial-codon aa.
    fa1 = tmp_path / "chim1.fa"
    fa1.write_text(f">chim1\n{g[20000:20300] + g[150000:150300]}\n")
    ref, mine = _run_both(fa1, ["-A"])
    assert ref == mine, [
        (a, b) for a, b in zip(ref.splitlines(), mine.splitlines())
        if a != b][:4]
