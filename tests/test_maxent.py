"""MaxEnt splice model parity: our table-gather implementation vs the
reference maxent_hr.c compiled as a ctypes oracle (test-only)."""

import ctypes
import os
import pathlib
import subprocess

import numpy as np
import pytest

import jax.numpy as jnp

from gmap_gsnap.db import genomecomp
from gmap_gsnap.io import fasta
from gmap_gsnap.ops import genome as genome_ops
from gmap_gsnap.ops import maxent
from gmap_gsnap.utils import dna

ORACLE_DIR = pathlib.Path(__file__).parent / "oracle"
REF_SRC = pathlib.Path("/root/reference/src")


@pytest.fixture(scope="module")
def oracle():
    if not REF_SRC.exists():
        pytest.skip("reference sources not available")
    so = ORACLE_DIR / "maxent_oracle.so"
    if not so.exists():
        ORACLE_DIR.mkdir(exist_ok=True)
        (ORACLE_DIR / "config.h").write_text(
            "/* minimal config.h shim to compile reference sources as a test oracle */\n"
        )
        subprocess.run(
            [
                "gcc", "-shared", "-fPIC", "-O2",
                "-I", str(ORACLE_DIR), "-I", str(REF_SRC),
                "-o", str(so), str(REF_SRC / "maxent_hr.c"),
            ],
            check=True,
        )
    lib = ctypes.CDLL(str(so))
    lib.Maxent_hr_setup.argtypes = [ctypes.POINTER(ctypes.c_uint32)]
    for fn in (
        "Maxent_hr_donor_prob",
        "Maxent_hr_acceptor_prob",
        "Maxent_hr_antidonor_prob",
        "Maxent_hr_antiacceptor_prob",
    ):
        getattr(lib, fn).restype = ctypes.c_double
        getattr(lib, fn).argtypes = [ctypes.c_uint32, ctypes.c_uint32]
    return lib


@pytest.fixture(scope="module")
def chr17():
    rec = next(fasta.read_fasta("/root/reference/tests/ss.chr17test"))
    codes, flags = dna.encode(rec.seq)
    return codes, flags


def test_maxent_parity_vs_reference(oracle, chr17):
    codes, flags = chr17
    blocks = genomecomp.pack(codes, flags).astype(np.uint32)
    blocks_c = blocks.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
    oracle.Maxent_hr_setup(blocks_c)

    rng = np.random.default_rng(3)
    pos = rng.integers(32, len(codes) - 32, 512).astype(np.uint32)

    gen = genome_ops.GenomeArrays.from_codes(codes, flags, [len(codes)])
    for kind, cfn in [
        ("donor", oracle.Maxent_hr_donor_prob),
        ("acceptor", oracle.Maxent_hr_acceptor_prob),
        ("antidonor", oracle.Maxent_hr_antidonor_prob),
        ("antiacceptor", oracle.Maxent_hr_antiacceptor_prob),
    ]:
        want = np.array([cfn(int(p), 0) for p in pos])
        got_np = maxent.splice_prob_np(codes, pos, kind)
        np.testing.assert_allclose(got_np, want, rtol=0, atol=0)  # exact f64
        got_dev = np.asarray(maxent.splice_prob(gen, jnp.asarray(pos), kind))
        np.testing.assert_allclose(got_dev, want, atol=5e-6)


def test_maxent_margin_zero(chr17):
    codes, flags = chr17
    gen = genome_ops.GenomeArrays.from_codes(codes, flags, [len(codes)])
    p = np.asarray(maxent.splice_prob(gen, jnp.asarray(np.array([0, 1, 2], np.uint32)), "donor"))
    np.testing.assert_array_equal(p, 0.0)
