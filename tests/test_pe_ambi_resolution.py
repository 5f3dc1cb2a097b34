"""Inside-pair resolution of ambiguous shortend splices
(resolve_inside_ambiguous_splice_plus/minus, stage3hr.c:6329/6811):
a short splice end matching TWO known partner sites equally is
soft-clipped single-end, but pairing resolves it to the unique partner
bounded by the mate — byte parity vs the reference binary on a custom
genome with a planted duplicate short exon."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

ORACLE_GSNAP = "/tmp/refbuild/src/gsnap"
REPO = pathlib.Path(__file__).resolve().parent.parent

needs_oracle = pytest.mark.skipif(
    not os.path.exists(ORACLE_GSNAP),
    reason="reference oracle binaries not built",
)


def _rc(s):
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


@needs_oracle
def test_pe_resolves_ambiguous_shortend(tmp_path):
    rng = np.random.default_rng(99)
    g = list("ACGT"[i] for i in rng.integers(0, 4, 200_000))
    p = 50_000            # donor boundary (end of exon 1)
    A = p + 1_000         # acceptor 1
    B = p + 3_000         # acceptor 2 (outside mate bound)
    dup = "".join("ACGT"[i] for i in rng.integers(0, 4, 30))
    g[A : A + 30] = dup
    g[B : B + 30] = dup
    seq = "".join(g)

    fa = tmp_path / "amb.fa"
    with open(fa, "w") as f:
        f.write(">ambtest\n")
        for i in range(0, len(seq), 60):
            f.write(seq[i : i + 60] + "\n")

    from gmap_gsnap.db import build
    from gmap_gsnap.db.iit_text import iit_from_text

    dbdir = build.build_db([str(fa)], "ambtest", str(tmp_path / "gdb"), k=12)
    maps = pathlib.Path(dbdir) / "ambtest.maps"
    maps.mkdir(exist_ok=True)
    ss_txt = (
        f">j.d ambtest:{p}..{p + 1} donor\n"
        f">j.a1 ambtest:{A}..{A + 1} acceptor\n"
        f">j.a2 ambtest:{B}..{B + 1} acceptor\n"
    )
    iit_from_text(ss_txt).write(str(maps / "amb.iit"))

    r1 = seq[p - 70 : p] + dup          # 70M...30M across the junction
    r2 = _rc(seq[A + 120 : A + 220])    # mate bounds acceptor A only
    fq1, fq2 = tmp_path / "a_1.fq", tmp_path / "a_2.fq"
    with open(fq1, "w") as f:
        f.write(f"@a0\n{r1}\n+\n{'I' * len(r1)}\n")
    with open(fq2, "w") as f:
        f.write(f"@a0\n{r2}\n+\n{'I' * len(r2)}\n")

    gdb = str(tmp_path / "gdb")
    ref = subprocess.run(
        [ORACLE_GSNAP, "-D", gdb, "-d", "ambtest", "--format=sam",
         "-s", "amb", str(fq1), str(fq2)],
        capture_output=True, text=True, check=True,
    ).stdout
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    mine = subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.gsnap", "-D", gdb,
         "-d", "ambtest", "-s", "amb", str(fq1), str(fq2)],
        capture_output=True, text=True, env=env, check=True,
    ).stdout
    ref_l = [l for l in ref.splitlines() if not l.startswith("@")]
    my_l = [l for l in mine.splitlines() if not l.startswith("@")]
    assert ref_l == my_l
    # the pair resolved to acceptor A: read 1 carries the 1000 bp
    # intron, single-path MAPQ 40 (the B alternative was rejected by
    # the zero-insertlength rule / bounded resolution)
    assert any("1000N" in l.split("\t")[5] for l in my_l), my_l
    assert any("\t40\t" in l for l in my_l), my_l
