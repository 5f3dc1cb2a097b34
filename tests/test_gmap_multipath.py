"""GMAP multiple paths (npaths > 1): queries matching several loci
report all near-equal non-overlapping paths with the reference's
ordering, winnowing, and NH/HI/MAPQ/XQ/X2 conventions
(gmap.c:561 stage3array_from_list, stage3.c:3657 mapq softmax)."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
ORACLE = "/tmp/refbuild/src/gmap"

needs_oracle = pytest.mark.skipif(
    not os.path.exists(ORACLE), reason="reference oracle not built")


def _dup_db(tmp_path):
    """Synthetic 80 kbp genome with a 300 bp segment present at 10050
    (original), 50000 (2 mismatches) and 60000 (exact copy)."""
    from gmap_gsnap.db import build

    rng = np.random.default_rng(3)
    bases = np.array(list("ACGT"))
    g = "".join(bases[rng.integers(0, 4, 80000)])
    gl = list(g)
    seg = g[10050:10350]
    c2 = list(seg)
    for i in (50, 150):
        c2[i] = "A" if c2[i] != "A" else "G"
    gl[50000:50300] = c2
    gl[60000:60300] = list(seg)
    fa = tmp_path / "dup.fa"
    with open(fa, "w") as f:
        f.write(">chrD\n")
        s = "".join(gl)
        for i in range(0, len(s), 60):
            f.write(s[i : i + 60] + "\n")
    dbdir = build.build_db([str(fa)], "dupdb", str(tmp_path), k=12)
    q = tmp_path / "q.fa"
    q.write_text(">q1\n" + seg + "\n")
    return dbdir, str(q)


def _run_ref(dbdir, qfa, *flags):
    return subprocess.run(
        [ORACLE, "-D", dbdir, "-d", "dupdb", *flags, qfa],
        capture_output=True, text=True, check=True).stdout


def _run_mine(dbdir, qfa, *flags):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.gmap", "-D", dbdir,
         "-d", "dupdb", *flags, qfa],
        capture_output=True, text=True, env=env, check=True).stdout


@needs_oracle
def test_multipath_summary_and_sam(tmp_path):
    dbdir, qfa = _dup_db(tmp_path)

    ref = _run_ref(dbdir, qfa, "-S", "-n", "5")
    assert "Paths (2):" in ref  # exact copies only; 2-mm copy winnowed
    mine = _run_mine(dbdir, qfa, "-S", "-n", "5")
    assert mine.splitlines() == ref.splitlines()

    # -n 1 prints the true count but one detail block
    ref1 = _run_ref(dbdir, qfa, "-S", "-n", "1")
    mine1 = _run_mine(dbdir, qfa, "-S", "-n", "1")
    assert mine1.splitlines() == ref1.splitlines()

    # samse: NH:i:2 HI:i:1/2 MAPQ 3 XQ 40 X2 40
    refs = _run_ref(dbdir, qfa, "-f", "samse", "-n", "5")
    mines = _run_mine(dbdir, qfa, "-f", "samse", "-n", "5")
    assert mines.splitlines() == refs.splitlines()

    refs1 = _run_ref(dbdir, qfa, "-f", "samse", "-n", "1")
    mines1 = _run_mine(dbdir, qfa, "-f", "samse", "-n", "1")
    assert mines1.splitlines() == refs1.splitlines()


@needs_oracle
def test_multipath_alignment_blocks(tmp_path):
    dbdir, qfa = _dup_db(tmp_path)
    ref = _run_ref(dbdir, qfa, "-A", "-n", "5")
    mine = _run_mine(dbdir, qfa, "-A", "-n", "5")
    assert mine.splitlines() == ref.splitlines()


def test_rank_paths_winnow_and_mapq():
    """Unit: goodness winnow (best-3), overlap elimination, mapq."""
    from gmap_gsnap.align.gmap import (Exon, Path, path_mapqs,
                                           rank_paths)

    def mk(gs, matches, mm, watsonp=True):
        return Path(watsonp=watsonp, cdna_direction=0,
                    exons=[Exon(0, 300, gs, gs + 300, matches, mm)],
                    querylength=300)

    a = mk(10050, 300, 0)
    b = mk(60000, 300, 0)
    c = mk(50000, 298, 2)        # > 3 below best: winnowed
    d = mk(10100, 300, 0)        # overlaps a: eliminated
    ranked = rank_paths([c, b, d, a])
    assert [p.gstart for p in ranked] == [10050, 60000]

    mapqs, absmqs, second = path_mapqs(ranked)
    assert mapqs == [3, 3] and absmqs == [40, 40] and second == 40
    mapqs1, absmqs1, second1 = path_mapqs([a])
    assert mapqs1 == [40] and absmqs1 == [40] and second1 == 0
