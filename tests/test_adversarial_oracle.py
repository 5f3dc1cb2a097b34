"""Randomized adversarial SAM-parity suites vs the reference gsnap.

Promotes the (previously out-of-tree) large randomized workloads into
pytest: SE substitutions, PE, known-splices + SNPs, and cmet, each
byte-compared line-for-line against the reference binary on identical
FASTQ inputs generated by bench_workloads (the bench generators).

Default sizes keep the suite tractable; GMAP_RUN_SLOW=1 raises
each to the full >=400-read adversarial size.
"""

import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

ORACLE_GSNAP = "/tmp/refbuild/src/gsnap"
ORACLE_DB = "/tmp/refbuild/trytest/gdb"
REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = "/root/reference/tests/ss.chr17test"

needs_oracle = pytest.mark.skipif(
    not (os.path.exists(ORACLE_GSNAP) and os.path.isdir(ORACLE_DB)),
    reason="reference oracle binaries not built",
)

SLOW = bool(os.environ.get("GMAP_RUN_SLOW"))
N_SE = 400 if SLOW else 160
N_PE = 400 if SLOW else 128
N_KS = 400 if SLOW else 160
N_CM = 400 if SLOW else 160


def _seq():
    return "".join(l.strip() for l in open(FIXTURE)
                   if not l.startswith(">")).upper()


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))


def _run_ours(args):
    return subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.gsnap", *args],
        capture_output=True, text=True, env=_env(), check=True).stdout


def _run_ref(args):
    return subprocess.run(
        [ORACLE_GSNAP, "--format=sam", *args],
        capture_output=True, text=True, check=True).stdout


def _diff(ref, mine):
    rl = [l for l in ref.splitlines() if not l.startswith("@")]
    ml = [l for l in mine.splitlines() if not l.startswith("@")]
    assert len(rl) == len(ml), (len(rl), len(ml))
    return [(a, b) for a, b in zip(ml, rl) if a != b]


@needs_oracle
def test_adversarial_se(tmp_path):
    import bench_workloads as bw

    rng = np.random.default_rng(42)
    reads = bw.make_se_workload(_seq(), N_SE, rng)
    fq = tmp_path / "se.fq"
    bw.write_fastq(fq, reads)
    args = ["-D", ORACLE_DB, "-d", "chr17test", str(fq)]
    d = _diff(_run_ref(args), _run_ours(args))
    assert not d, (len(d), d[:3])


@needs_oracle
def test_adversarial_pe(tmp_path):
    import bench

    rng = np.random.default_rng(7)
    r5, r3 = bench.make_pe_workload(_seq(), N_PE, rng)
    import bench_workloads as bw

    bw.write_pe_fastq(tmp_path / "p_1.fq", tmp_path / "p_2.fq", r5, r3)
    args = ["-D", ORACLE_DB, "-d", "chr17test",
            str(tmp_path / "p_1.fq"), str(tmp_path / "p_2.fq")]
    d = _diff(_run_ref(args), _run_ours(args))
    assert not d, (len(d), d[:3])


def _copy_db(tmp_path):
    dbdir = tmp_path / "gdb" / "chr17test"
    shutil.copytree(f"{ORACLE_DB}/chr17test", dbdir,
                    ignore=shutil.ignore_patterns("*.maps"))
    (dbdir / "chr17test.maps").mkdir(exist_ok=True)
    return tmp_path / "gdb", dbdir


@needs_oracle
def test_adversarial_known_snp(tmp_path):
    import bench_workloads as bw
    from gmap_gsnap.db.iit_text import iit_from_text

    seq = _seq()
    gdb, dbdir = _copy_db(tmp_path)
    rng = np.random.default_rng(11)
    ss_txt, snp_txt, juncs, snps = bw.known_snp_setup(seq, rng)
    iit_from_text(ss_txt).write(str(dbdir / "chr17test.maps" / "ss.iit"))
    iit_from_text(snp_txt).write(str(dbdir / "chr17test.maps" / "snps.iit"))
    subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.snpindex",
         "-D", str(gdb), "-d", "chr17test", "-v", "snps",
         str(dbdir / "chr17test.maps" / "snps.iit")],
        capture_output=True, text=True, env=_env(), check=True)
    rng = np.random.default_rng(11)
    reads = bw.make_known_snp_workload(seq, N_KS, rng, juncs, snps)
    fq = tmp_path / "ks.fq"
    bw.write_fastq(fq, reads)
    args = ["-D", str(gdb), "-d", "chr17test", "-v", "snps", "-s", "ss",
            str(fq)]
    d = _diff(_run_ref(args), _run_ours(args))
    assert not d, (len(d), d[:3])


@needs_oracle
def test_adversarial_cmet(tmp_path):
    import bench_workloads as bw

    seq = _seq()
    gdb, dbdir = _copy_db(tmp_path)
    subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.cmetindex",
         "-D", str(gdb), "-d", "chr17test"],
        capture_output=True, text=True, env=_env(), check=True)
    rng = np.random.default_rng(5)
    reads = bw.make_cmet_workload(seq, N_CM, rng)
    fq = tmp_path / "cm.fq"
    bw.write_fastq(fq, reads)
    args = ["-D", str(gdb), "-d", "chr17test", "--mode=cmet-stranded",
            str(fq)]
    d = _diff(_run_ref(args), _run_ours(args))
    assert not d, (len(d), d[:3])
