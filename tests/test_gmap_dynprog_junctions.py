"""Dynprog junction rescue: introns with indels INSIDE the peel window
(traverse_genome_gap -> Dynprog_genome_gap), samse byte parity."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
ORACLE = "/tmp/refbuild/src/gmap"
ORACLE_DB = "/tmp/refbuild/trytest/gdb"

needs_oracle = pytest.mark.skipif(
    not os.path.exists(ORACLE), reason="reference oracle not built")


@needs_oracle
def test_intron_with_indel_near_junction(tmp_path):
    from test_gsnap_shortexon import _genome_codes, _good_sites

    seq, codes = _genome_codes()
    donors, _ = _good_sites(codes, "donor")
    accs, _ = _good_sites(codes, "acceptor")
    made = []
    for d in donors:
        a = accs[(accs > d + 200) & (accs < d + 5000)]
        if not len(a):
            continue
        a = int(a[0])
        e2 = seq[a : a + 200]
        # 1 bp deletion 5 bp after the junction — unrepresentable by a
        # pure split-point scan, needs the banded DP bridge
        read = seq[int(d) - 200 : int(d)] + e2[:5] + e2[6:]
        made.append(read)
        if len(made) >= 3:
            break
    assert len(made) >= 2
    fa = tmp_path / "jx.fa"
    with open(fa, "w") as f:
        for i, r in enumerate(made):
            f.write(f">jx{i}\n{r}\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    ref = subprocess.run(
        [ORACLE, "-D", ORACLE_DB, "-d", "chr17test", "-f", "samse", str(fa)],
        capture_output=True, text=True, check=True).stdout
    mine = subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.gmap", "-D", ORACLE_DB,
         "-d", "chr17test", "-f", "samse", str(fa)],
        capture_output=True, text=True, env=env, check=True).stdout
    # at least one alignment must show intron + deletion in one CIGAR
    body = [l for l in ref.splitlines()
            if not l.startswith("@") and len(l.split("\t")) > 5]
    assert any("N" in l.split("\t")[5] and "D" in l.split("\t")[5]
               for l in body), body
    assert ref.splitlines() == mine.splitlines()
