"""Paired-end pipeline tests: device pairing semantics + oracle SAM
parity on randomized concordant/discordant/halfmapping pairs."""

import os
import pathlib
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


def _genome_seq():
    return "".join(
        l.strip() for l in open(FIXTURE) if not l.startswith(">")
    ).upper()


def _rc(s):
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def test_pairtype_classification():
    """Device pairing grid matches Stage3_determine_pairtype rules."""
    import jax.numpy as jnp

    from gmap_gsnap.align import gsnap_pe, gsnap_se
    from gmap_gsnap.db import build, indexdb
    from gmap_gsnap.ops import genome as genome_ops
    from gmap_gsnap.utils import dna

    g = build.load_genome_fasta([FIXTURE])
    genome = genome_ops.GenomeArrays.from_codes(g.codes, g.flags, g.chr_ends)
    offsets, positions = indexdb.build_index(g.codes, g.flags, g.chr_ends, 12, 3)
    index = gsnap_se.IndexArrays.from_host(offsets, positions, 12, 3)
    seq = _genome_seq()

    def enc(reads):
        lmax = max(len(r) for r in reads)
        b = len(reads)
        codes = np.zeros((b, lmax), np.uint8)
        nflags = np.zeros((b, lmax), bool)
        lengths = np.zeros(b, np.int32)
        for i, r in enumerate(reads):
            c, f = dna.encode(r)
            codes[i, : len(c)] = c
            nflags[i, : len(c)] = f
            lengths[i] = len(c)
        return jnp.asarray(codes), jnp.asarray(nflags), jnp.asarray(lengths)

    # pairs: (r5, r3_inverted) in the invert_second_p convention
    p = 20000
    r5 = [seq[p : p + 100],            # concordant, insert 300
          seq[p : p + 100],            # toolong (5 kb)
          seq[p : p + 100]]            # inversion
    r3 = [seq[p + 200 : p + 300],
          seq[p + 5000 : p + 5100],
          _rc(seq[p + 200 : p + 300])]
    c5, f5, l5 = enc(r5)
    c3, f3, l3 = enc(r3)
    res = gsnap_pe.align_batch_pe(genome, index, c5, f5, l5, c3, f3, l3)
    pt = np.asarray(res["pairtype"])
    npairs = np.asarray(res["npairs"])
    ins = np.asarray(res["insert"])
    assert npairs[0] >= 1 and pt[0, 0] == gsnap_pe.PT_CONCORDANT
    assert ins[0, 0] == 300
    assert npairs[1] >= 1 and pt[1, 0] == gsnap_pe.PT_TOOLONG
    assert npairs[2] >= 1 and pt[2, 0] == gsnap_pe.PT_INVERSION
    assert bool(np.asarray(res["pair_concordant"])[0])
    assert not bool(np.asarray(res["pair_concordant"])[1])


@needs_oracle
def test_pe_novel_splicing_parity(tmp_path):
    """Config 3: paired-end with novel splicing (-N1) — read 1 spans a
    strong-maxent junction, read 2 is a plain genomic mate."""
    from gmap_gsnap.db import build
    from gmap_gsnap.ops import maxent

    g = build.load_genome_fasta([FIXTURE])
    seq = _genome_seq()
    pos = np.arange(100, len(seq) - 100)
    dp = maxent.splice_prob_np(g.codes, pos, "donor")
    ap = maxent.splice_prob_np(g.codes, pos, "acceptor")
    dsites = pos[dp > 0.97]
    asites = pos[ap > 0.97]

    pairs = []
    cnt = 0
    for d in dsites:
        k = np.searchsorted(asites, d + 150)
        if k >= len(asites) or asites[k] > d + 5000:
            continue
        a = int(asites[k])
        r1 = seq[int(d) - 50 : int(d)] + seq[a : a + 50]
        r2 = _rc(seq[a + 150 : a + 250])  # mate downstream of the intron
        pairs.append((r1, r2) if cnt % 2 == 0 else (_rc(r2), _rc(r1)))
        cnt += 1
        if cnt >= 5:
            break
    assert pairs

    fq1, fq2 = tmp_path / "n_1.fq", tmp_path / "n_2.fq"
    with open(fq1, "w") as f1, open(fq2, "w") as f2:
        for i, (a, b) in enumerate(pairs):
            f1.write(f"@n{i}\n{a}\n+\n{'I' * len(a)}\n")
            f2.write(f"@n{i}\n{b}\n+\n{'I' * len(b)}\n")

    ref = subprocess.run(
        [ORACLE_GSNAP, "-D", ORACLE_DB, "-d", "chr17test", "--format=sam",
         "-N1", str(fq1), str(fq2)],
        capture_output=True, text=True, check=True,
    ).stdout
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    mine = subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.gsnap", "-D", ORACLE_DB,
         "-d", "chr17test", "-N1", str(fq1), str(fq2)],
        capture_output=True, text=True, env=env, check=True,
    ).stdout
    ref_lines = [l for l in ref.splitlines() if not l.startswith("@")]
    my_lines = [l for l in mine.splitlines() if not l.startswith("@")]
    assert ref_lines == my_lines


@needs_oracle
def test_pe_sam_parity(tmp_path):
    """Byte parity vs reference gsnap on randomized paired-end reads:
    concordant with substitutions and indels, varying insert sizes,
    mate-first orientation, halfmapping, and unmapped pairs."""
    import random

    random.seed(21)
    seq = _genome_seq()
    pairs = []
    for i in range(30):
        L = random.choice([75, 100])
        p = random.randrange(1000, len(seq) - 3000)
        ins = random.randrange(2 * L, 600)
        r1 = list(seq[p : p + L])
        r2 = list(seq[p + ins - L : p + ins])
        for r in (r1, r2):
            for _ in range(random.randrange(0, 3)):
                r[random.randrange(L)] = random.choice("ACGT")
        r1, r2 = "".join(r1), _rc("".join(r2))
        if random.random() < 0.3:
            r1, r2 = r2, r1  # mate-first orientation
        pairs.append((r1, r2))
    # a deletion in read 1
    p = 150000
    pairs.append((seq[p : p + 50] + seq[p + 53 : p + 103],
                  _rc(seq[p + 250 : p + 350])))
    # halfmapping + nomapping
    rng = random.Random(5)
    rand = lambda n: "".join(rng.choice("ACGT") for _ in range(n))
    pairs.append((seq[90000:90100], rand(100)))
    pairs.append((rand(100), rand(100)))

    fq1, fq2 = tmp_path / "p_1.fq", tmp_path / "p_2.fq"
    with open(fq1, "w") as f1, open(fq2, "w") as f2:
        for i, (a, b) in enumerate(pairs):
            f1.write(f"@p{i}\n{a}\n+\n{'I' * len(a)}\n")
            f2.write(f"@p{i}\n{b}\n+\n{'I' * len(b)}\n")

    ref = subprocess.run(
        [ORACLE_GSNAP, "-D", ORACLE_DB, "-d", "chr17test", "--format=sam",
         str(fq1), str(fq2)],
        capture_output=True, text=True, check=True,
    ).stdout
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    mine = subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.gsnap", "-D", ORACLE_DB,
         "-d", "chr17test", str(fq1), str(fq2)],
        capture_output=True, text=True, env=env, check=True,
    ).stdout

    ref_lines = [l for l in ref.splitlines() if not l.startswith("@")]
    my_lines = [l for l in mine.splitlines() if not l.startswith("@")]
    assert ref_lines == my_lines
