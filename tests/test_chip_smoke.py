"""chip_smoke.py: its phases at tiny size on the CPU, its SAM checks, its
refusal to run without a GPU, and (marked gpu) its op-level parity checks
at the real widths."""

import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke

K = 12


@pytest.fixture(scope="module")
def small_db(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("smoke"))
    g = chip_smoke.build_genome(work, 1_000_000, 4, 16, seed=2, k=K)
    return work, g


def test_build_and_open(small_db):
    work, g = small_db
    db, _ = chip_smoke.open_on_device(work)
    assert db.k == K and db.chr_names == g.names
    assert len(db.codes) == 1_000_000


def test_pe_splice_phase(small_db):
    work, g = small_db
    _, n, share, jshare, jends = chip_smoke.pe_splice(work, g, 64, 3, K, 64)
    assert n == 128
    assert jends > 0
    assert share >= chip_smoke.PE_PLACED_BAR - 0.1
    assert jshare >= chip_smoke.PE_JUNCTION_BAR - 0.1


def test_se_phase(small_db):
    work, g = small_db
    n, share = chip_smoke.se_mismatch(work, g, 64, 4, K, 64)
    assert n == 64 and share >= chip_smoke.SE_PLACED_BAR


def test_gmap_phase(small_db):
    work, g = small_db
    assert chip_smoke.gmap_cdna(work, g, 4, 5, K) >= 0.75


def test_parity_checks_small():
    assert chip_smoke.selection_parity(batch=32) == 0
    assert chip_smoke.maxent_parity(n=4096) <= chip_smoke.MAXENT_ATOL
    assert chip_smoke.dynprog_parity(nprob=3) == 0


@pytest.mark.parametrize("pos,cigar,left,introns", [
    (101, "100M", 100, []),
    (101, "3S97M", 97, []),
    (11, "20M100N80M", 10, [(30, 130)]),
    (11, "10M2D10M5N80M", 10, [(32, 37)]),
    (11, "5M1I20N10M50N84M", 10, [(15, 35), (45, 95)]),
])
def test_sam_cigar_helpers(pos, cigar, left, introns):
    assert chip_smoke.aligned_left(pos, cigar) == left
    assert chip_smoke.cigar_introns(pos, cigar) == introns


def test_sam_primaries(tmp_path):
    sam = tmp_path / "x.sam"
    sam.write_text(
        "@SQ\tSN:chr1\tLN:1000\n"
        "r0\t99\tchr1\t5\t40\t100M\t=\t200\t295\tA\tI\n"
        "r0\t147\tchr1\t200\t40\t100M\t=\t5\t-295\tA\tI\n"
        "r0\t355\tchr1\t600\t0\t100M\t=\t5\t-295\tA\tI\n"
        "s1\t4\t*\t0\t0\t*\t*\t0\t0\tA\tI\n")
    n, recs = chip_smoke.sam_primaries(str(sam))
    assert n == 3
    assert recs[("r0", 1)] == ("chr1", 5, "100M")
    assert recs[("r0", 2)] == ("chr1", 200, "100M")
    assert recs[("s1", 0)] == ("*", 0, "*")


def test_refuses_without_gpu(monkeypatch, capsys):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code != 0
    assert '"ok"' not in capsys.readouterr().out


def test_bench_refuses_without_gpu(capsys):
    import bench

    assert bench.main() != 0
    assert "needs a GPU" in capsys.readouterr().err


def test_fails_alone_in_a_directory(tmp_path):
    shutil.copy(chip_smoke.__file__, tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.gpu
def test_selection_parity_gpu(gpu):
    assert chip_smoke.selection_parity() == 0


@pytest.mark.gpu
def test_maxent_parity_gpu(gpu):
    assert chip_smoke.maxent_parity() <= chip_smoke.MAXENT_ATOL


@pytest.mark.gpu
def test_dynprog_parity_gpu(gpu):
    assert chip_smoke.dynprog_parity() == 0
