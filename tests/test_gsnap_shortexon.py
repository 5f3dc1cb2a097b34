"""Doublesplice / shortexon hits (solve_doublesplice, stage1hr.c:6612):
reads spanning TWO introns around a short middle exon, SAM byte parity
vs the reference gsnap -N1."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
ORACLE_GSNAP = "/tmp/refbuild/src/gsnap"
ORACLE_DB = "/tmp/refbuild/trytest/gdb"

needs_oracle = pytest.mark.skipif(
    not os.path.exists(ORACLE_GSNAP), reason="reference oracle not built")


def _genome_codes():
    seq = "".join(
        l.strip() for l in open("/root/reference/tests/ss.chr17test")
        if not l.startswith(">")
    ).upper()
    lut = {c: i for i, c in enumerate("ACGT")}
    return seq, np.array([lut.get(c, 0) for c in seq], np.uint8)


def _good_sites(codes, kind, thr=0.95):
    from gmap_gsnap.ops import maxent

    pos = np.arange(40, len(codes) - 40)
    p = maxent.splice_prob_np(codes, pos, kind)
    return pos[p > thr], p[p > thr]


def make_shortexon_reads(n=6):
    """Reads = exon1(40) + middle(18-30) + exon2(40) built from
    high-probability donor/acceptor sites so the reference's
    sufficient_splice_prob_local gates pass."""
    seq, codes = _genome_codes()
    donors, _ = _good_sites(codes, "donor")
    accs, _ = _good_sites(codes, "acceptor")
    reads = []
    used = 0
    for d1 in donors:
        if used >= n:
            break
        # acceptor a1 downstream within intron range
        a1c = accs[(accs > d1 + 60) & (accs < d1 + 4000)]
        if not len(a1c):
            continue
        a1 = a1c[0]
        # donor d2 = a1 + middle-exon length
        d2c = donors[(donors > a1 + 16) & (donors < a1 + 31)]
        if not len(d2c):
            continue
        d2 = d2c[0]
        a2c = accs[(accs > d2 + 60) & (accs < d2 + 4000)]
        if not len(a2c):
            continue
        a2 = a2c[0]
        read = seq[d1 - 40 : d1] + seq[a1 : d2] + seq[a2 : a2 + 40]
        if "N" in read or len(read) < 96:
            continue
        reads.append((f"sx{used}", read, int(d1), int(a1), int(d2), int(a2)))
        used += 1
    return reads


@needs_oracle
def test_shortexon_sam_parity(tmp_path):
    reads = make_shortexon_reads()
    assert len(reads) >= 3, "fixture mining failed"
    fq = tmp_path / "sx.fq"
    with open(fq, "w") as f:
        for name, r, *_ in reads:
            f.write(f"@{name}\n{r}\n+\n{'I' * len(r)}\n")
    ref = subprocess.run(
        [ORACLE_GSNAP, "-D", ORACLE_DB, "-d", "chr17test", "--format=sam",
         "-N1", str(fq)],
        capture_output=True, text=True, check=True,
    ).stdout
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    mine = subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.gsnap", "-D", ORACLE_DB,
         "-d", "chr17test", "-N1", str(fq)],
        capture_output=True, text=True, env=env, check=True,
    ).stdout
    ref_lines = [l for l in ref.splitlines() if not l.startswith("@")]
    my_lines = [l for l in mine.splitlines() if not l.startswith("@")]
    # the reference must actually have produced two-intron alignments
    assert any(l.split("\t")[5].count("N") == 2 for l in ref_lines), ref_lines
    assert ref_lines == my_lines
