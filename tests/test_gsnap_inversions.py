"""Mixed-strand distant-splice inversions (find_splicepairs_distant
sections 2/3/6/7): native + SAM byte parity vs the reference."""

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


def _mine():
    from gmap_gsnap.ops import maxent

    seq = "".join(
        l.strip() for l in open("/root/reference/tests/ss.chr17test")
        if not l.startswith(">")
    ).upper()
    lut = {c: i for i, c in enumerate("ACGT")}
    codes = np.array([lut.get(c, 0) for c in seq], np.uint8)
    pos = np.arange(60, len(codes) - 60)
    out = {}
    for kind in ("donor", "acceptor", "antidonor", "antiacceptor"):
        p = maxent.splice_prob_np(codes, pos, kind)
        out[kind] = pos[p > 0.97]
    return seq, out


def _rc(s):
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def make_inversion_reads():
    """Section 2 reads (donor+ then acceptor-) and section 7-style
    antisense reads (antiacceptor+ then antidonor-)."""
    seq, sites = _mine()
    reads = []
    # section 2: left = plus exon ending at donor d; right = revcomp of
    # the exon PRECEDING a minus-strand acceptor (plus antiacceptor m)
    for d in sites["donor"][:12]:
        far = sites["antiacceptor"][np.abs(sites["antiacceptor"] - d) > 20000]
        if not len(far):
            continue
        m = far[0]
        r = seq[d - 50 : d] + _rc(seq[m - 50 : m])
        if "N" not in r:
            reads.append((f"s2_{len(reads)}", r))
        if len(reads) >= 3:
            break
    # section 3: left = revcomp of exon FOLLOWING a minus donor (plus
    # antidonor site m, exon on plus [m, m+50)); right = plus exon
    # starting at an acceptor a
    n0 = len(reads)
    for m in sites["antidonor"][:12]:
        far = sites["acceptor"][np.abs(sites["acceptor"] - m) > 20000]
        if not len(far):
            continue
        a = far[0]
        r = _rc(seq[m : m + 50]) + seq[a : a + 50]
        if "N" not in r:
            reads.append((f"s3_{len(reads) - n0}", r))
        if len(reads) >= n0 + 3:
            break
    return reads


@needs_oracle
def test_inversion_parity(tmp_path):
    reads = make_inversion_reads()
    assert len(reads) >= 4
    fq = tmp_path / "inv.fq"
    with open(fq, "w") as f:
        for n, r in reads:
            f.write(f"@{n}\n{r}\n+\n{'I' * len(r)}\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    for fmt_args in ([], ["--format=sam"]):
        ref = subprocess.run(
            [ORACLE_GSNAP, "-D", ORACLE_DB, "-d", "chr17test", "-N1",
             *fmt_args, str(fq)],
            capture_output=True, text=True, check=True,
        ).stdout
        my_args = ["-A", "sam"] if fmt_args else ["-A", "gsnap"]
        mine = subprocess.run(
            [sys.executable, "-m", "gmap_gsnap.cli.gsnap", "-D",
             ORACLE_DB, "-d", "chr17test", "-N1", *my_args, str(fq)],
            capture_output=True, text=True, env=env, check=True,
        ).stdout
        ref_l = [l for l in ref.splitlines() if not l.startswith("@SQ")]
        my_l = [l for l in mine.splitlines() if not l.startswith("@SQ")]
        if fmt_args:
            assert any("XT:Z" in l and "\t16\t" in l for l in ref_l), ref_l
        else:
            assert any("splice_type:inversion" in l for l in ref_l)
        assert ref_l == my_l, fmt_args
