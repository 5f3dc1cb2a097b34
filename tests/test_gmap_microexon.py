"""GMAP microexon detection (Dynprog_microexon_int, dynprog.c:7131 +
traverse_genome_gap trigger stage3.c:5903): a 3-12 bp exon between two
canonical high-probability introns — too short to seed — is recovered
by scanning the junction window for GT/AG boundaries and exact-matching
the middle query segment (the reference's Boyer-Moore becomes one
vectorized sliding compare), accepted on maxent flank probabilities."""

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


def _microexon_read():
    from test_gsnap_shortexon import _genome_codes, _good_sites

    seq, codes = _genome_codes()
    donors, _ = _good_sites(codes, "donor")
    accs, _ = _good_sites(codes, "acceptor")
    for a in accs:
        ds = donors[(donors >= a + 3) & (donors <= a + 12)]
        if not len(ds):
            continue
        d2 = int(ds[0])
        d1c = donors[donors < a - 200]
        a2c = accs[accs > d2 + 200]
        if len(d1c) and len(a2c):
            d1, a2 = int(d1c[-1]), int(a2c[0])
            return (seq[d1 - 150 : d1] + seq[a : d2]
                    + seq[a2 : a2 + 150]), d2 - a
    raise AssertionError("no microexon site pair in fixture")


@needs_oracle
def test_microexon_parity(tmp_path):
    read, mlen = _microexon_read()
    assert 3 <= mlen <= 12
    fa = tmp_path / "mx.fa"
    fa.write_text(f">mx\n{read}\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    for args in (["-S"], ["-f", "samse"], ["-A"]):
        ref = subprocess.run(
            [ORACLE, "-D", ORACLE_DB, "-d", "chr17test", *args, str(fa)],
            capture_output=True, text=True, check=True).stdout
        mine = subprocess.run(
            [sys.executable, "-m", "gmap_gsnap.cli.gmap", "-D",
             ORACLE_DB, "-d", "chr17test", *args, str(fa)],
            capture_output=True, text=True, env=env, check=True).stdout
        assert mine.splitlines() == ref.splitlines(), args
    # and the microexon really is a separate exon
    ref = subprocess.run(
        [ORACLE, "-D", ORACLE_DB, "-d", "chr17test", "-S", str(fa)],
        capture_output=True, text=True, check=True).stdout
    assert "Number of exons: 3" in ref
