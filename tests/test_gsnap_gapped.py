"""Unit + oracle-parity tests for the gapped GSNAP stages (middle
indels, local novel splicing)."""

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


@pytest.fixture(scope="module")
def db():
    from gmap_gsnap.align import gsnap_se
    from gmap_gsnap.db import build, indexdb
    from gmap_gsnap.ops import genome as genome_ops

    g = build.load_genome_fasta([FIXTURE])
    genome = genome_ops.GenomeArrays.from_codes(g.codes, g.flags, g.chr_ends)
    offsets, positions = indexdb.build_index(g.codes, g.flags, g.chr_ends, 12, 3)
    index = gsnap_se.IndexArrays.from_host(offsets, positions, 12, 3)
    seq = "".join("ACGT"[c] for c in g.codes)
    return genome, index, seq, g


def _align(db, seqs, novelsplicing=True):
    import jax.numpy as jnp

    from gmap_gsnap.align import gsnap_gapped
    from gmap_gsnap.utils import dna

    genome, index, _, _ = db
    lmax = max(len(s) for s in seqs)
    b = len(seqs)
    codes = np.zeros((b, lmax), np.uint8)
    nflags = np.zeros((b, lmax), bool)
    lengths = np.zeros(b, np.int32)
    for i, s in enumerate(seqs):
        c, f = dna.encode(s)
        codes[i, : len(c)] = c
        nflags[i, : len(c)] = f
        lengths[i] = len(c)
    params = gsnap_gapped.GappedParams(novelsplicing=novelsplicing)
    res = gsnap_gapped.align_batch_gapped(
        genome, index, jnp.asarray(codes), jnp.asarray(nflags),
        jnp.asarray(lengths), params,
    )
    return {k: np.asarray(v) for k, v in res.items()}


def test_middle_deletions(db):
    from gmap_gsnap.align.gsnap_gapped import KIND_DEL

    _, _, seq, _ = db
    seqs, expect = [], []
    for i, n in enumerate([1, 2, 5, 30]):
        p = 20000 + i * 1000
        seqs.append(seq[p : p + 50] + seq[p + 50 + n : p + 100 + n])
        expect.append((p, p + n, n))
    res = _align(db, seqs)
    for i, (left, right, n) in enumerate(expect):
        assert res["npaths"][i] >= 1
        assert res["kind"][i, 0] == KIND_DEL
        assert res["left"][i, 0] == left
        assert res["right"][i, 0] == right
        assert res["nindels"][i, 0] == n
        assert res["nmm"][i, 0] == 0


def test_middle_insertions(db):
    from gmap_gsnap.align.gsnap_gapped import KIND_INS

    _, _, seq, _ = db
    rng = np.random.default_rng(3)
    seqs, expect = [], []
    for i, n in enumerate([1, 4, 9]):
        p = 50000 + i * 1000
        ins = "".join("ACGT"[c] for c in rng.integers(0, 4, n))
        seqs.append(seq[p : p + 50] + ins + seq[p + 50 : p + 100 - n])
        expect.append((p, n))
    res = _align(db, seqs)
    for i, (left, n) in enumerate(expect):
        assert res["npaths"][i] >= 1
        assert res["kind"][i, 0] == KIND_INS
        assert res["left"][i, 0] == left
        assert res["nindels"][i, 0] == n


def test_novel_splice_detection(db):
    """Reads spanning a junction between strong maxent donor/acceptor
    sites are recovered with the exact splice point on both strands."""
    from gmap_gsnap.align.gsnap_gapped import KIND_SPLICE
    from gmap_gsnap.ops import maxent
    from gmap_gsnap.utils import dna

    _, _, seq, g = db
    pos = np.arange(100, 20000)
    dp = maxent.splice_prob_np(g.codes, pos, "donor")
    ap = maxent.splice_prob_np(g.codes, pos, "acceptor")
    dsites = pos[dp > 0.95]
    asites = pos[ap > 0.95]
    d = int(dsites[0])
    a = int(asites[np.searchsorted(asites, d + 100)])
    r = seq[d - 50 : d] + seq[a : a + 50]
    res = _align(db, [r, dna.revcomp_str(r)])
    for i in range(2):
        assert res["npaths"][i] >= 1
        assert res["kind"][i, 0] == KIND_SPLICE
        assert res["left"][i, 0] == d - 50
        assert res["right"][i, 0] == a - 50
        assert res["split"][i, 0] == 50
        assert bool(res["sense"][i, 0])
        assert res["plusp"][i, 0] == (i == 0)


def test_no_splicing_by_default(db):
    """novelsplicing=False (gsnap default) must not emit splice hits."""
    from gmap_gsnap.ops import maxent

    _, _, seq, g = db
    pos = np.arange(100, 20000)
    dp = maxent.splice_prob_np(g.codes, pos, "donor")
    d = int(pos[dp > 0.95][0])
    r = seq[d - 50 : d] + seq[d + 200 : d + 250]
    res = _align(db, [r], novelsplicing=False)
    kinds = res["kind"][0][: res["npaths"][0]]
    assert (kinds != 3).all()


@needs_oracle
def test_gapped_sam_parity(tmp_path):
    """Byte parity vs the reference on indel + strong-splice reads.

    All reads are constructed to be solvable without the reference's
    GMAP-rescue pass (clean flanks, strong maxent junctions)."""
    import random

    from gmap_gsnap.db import build
    from gmap_gsnap.ops import maxent

    random.seed(11)
    g = build.load_genome_fasta([FIXTURE])
    seq = "".join("ACGT"[c] for c in g.codes)
    comp = str.maketrans("ACGT", "TGCA")

    reads = []
    # deletions / insertions with 0-2 extra substitutions
    for i in range(12):
        n = random.choice([1, 2, 3, 7, 15, 30]) if i % 2 == 0 else random.choice([1, 3, 9])
        p = 10000 + i * 3000
        if i % 2 == 0:
            r = list(seq[p : p + 50] + seq[p + 50 + n : p + 100 + n])
        else:
            ins = "".join(random.choice("ACGT") for _ in range(n))
            r = list(seq[p : p + 50] + ins + seq[p + 50 : p + 100 - n])
        for _ in range(random.randrange(0, 3)):
            j = random.randrange(8, 92)
            r[j] = random.choice("ACGT")
        r = "".join(r)
        if i % 3 == 2:
            r = r.translate(comp)[::-1]
        reads.append(r)
    # strong-junction splices
    pos = np.arange(100, len(seq) - 100)
    dp = maxent.splice_prob_np(g.codes, pos, "donor")
    ap = maxent.splice_prob_np(g.codes, pos, "acceptor")
    dsites = pos[dp > 0.97]
    asites = pos[ap > 0.97]
    cnt = 0
    for d in dsites:
        k = np.searchsorted(asites, d + 150)
        if k >= len(asites) or asites[k] > d + 5000:
            continue
        a = int(asites[k])
        r = seq[int(d) - 50 : int(d)] + seq[a : a + 50]
        reads.append(r if cnt % 2 == 0 else r.translate(comp)[::-1])
        cnt += 1
        if cnt >= 6:
            break

    fq = tmp_path / "gapped.fq"
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@g{i}\n{r}\n+\n{'I' * len(r)}\n")

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
    divergent = [
        (r, m) for r, m in zip(ref_lines, my_lines) if r != m
    ]
    assert len(ref_lines) == len(my_lines)
    assert not divergent, divergent[:4]
