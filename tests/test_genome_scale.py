"""Genome-scale readiness: k=15/basesize=12 gamma index on a large
synthetic genome, lazy genome view, and SE alignment without any
whole-genome Python string."""

import os

import numpy as np
import pytest


@pytest.mark.skipif(not os.environ.get("GMAP_RUN_SLOW"),
                    reason="~4 min: k=15 build is 4^15-entry offsets; "
                           "set GMAP_RUN_SLOW=1 (verified on 16 and "
                           "64 Mbp synthetic genomes)")
def test_k15_gamma_roundtrip_large(tmp_path):
    """Blocked Elias-gamma offsets at k=15/basesize=12 survive a
    write/read roundtrip on a synthetic 16 Mbp genome (the README
    k=15 sizing path; larger genomes differ only in runtime — a
    64 Mbp run was verified once out-of-suite)."""
    from gmap_gsnap.db import indexdb

    rng = np.random.default_rng(11)
    G = 16_000_000
    codes = rng.integers(0, 4, G).astype(np.uint8)
    flags = np.zeros(G, bool)
    chr_ends = np.array([G], np.int64)
    offsets, positions = indexdb.build_index(codes, flags, chr_ends, 15, 3)
    assert offsets.shape[0] == 4**15 + 1
    assert offsets[-1] == len(positions)

    gp = str(tmp_path / "t.ref12153gammaptrs")
    oc = str(tmp_path / "t.offsetscomp")
    indexdb.write_offsets_gamma(gp, oc, offsets, basesize=12, k=15)
    back = indexdb.read_offsets_gamma(gp, oc, basesize=12, k=15)
    assert np.array_equal(back, offsets)
    # gamma compression must actually compress (README:178-183 ratios)
    assert os.path.getsize(oc) < 4 * (4**15 + 1) / 4


def test_se_pipeline_without_genome_string(tmp_path):
    """The SE pipeline + SAM emission never materializes a
    whole-genome Python str (LazyGenomeStr windows only)."""
    import io

    from gmap_gsnap.align import runner as runner_mod
    from gmap_gsnap.db import build
    from gmap_gsnap.db.datadir import GenomeDB, LazyGenomeStr

    dbdir = build.build_db(["/root/reference/tests/ss.chr17test"],
                           "chr17test", str(tmp_path), k=12)
    db = GenomeDB.open(dbdir, "chr17test")
    assert isinstance(db.genome_str, LazyGenomeStr)

    seq = db.genome_str[50000:50100]
    assert isinstance(seq, str) and len(seq) == 100
    recs = [runner_mod.Record("r0", "r0", seq, "I" * 100)]
    runner = runner_mod.GsnapRunner(db)
    assert isinstance(runner._genome_str, LazyGenomeStr)
    out = io.StringIO()
    runner.run(recs, out)
    body = [l for l in out.getvalue().splitlines() if not l.startswith("@")]
    assert len(body) == 1 and "\t50001\t" in body[0]


def test_overflow_rescue_lane(tmp_path):
    """Truncated-oligo handling (SURVEY 7 overflow rescue, updated for
    the compact rank-mapped seed grid): a read over the most frequent
    chr17test 12-mer (79 positions) still fits the shared seed_total
    budget — its seed set is exact WITHOUT the wide re-run, so overflow
    must NOT fire (the floor-bound gate also clears the
    candidate-budget flag) — while a tandem-repeat window whose total
    in-threshold positions exceed seed_total still flags overflow and
    re-runs at the exact (seed_total=0) wide config.  Both must match
    the reference byte-for-byte."""
    import io
    import subprocess

    from gmap_gsnap.align import gsnap_se, runner as runner_mod
    from gmap_gsnap.db.datadir import GenomeDB

    if not os.path.isdir("/tmp/refbuild/trytest/gdb"):
        pytest.skip("oracle DB not built")
    db = GenomeDB.open("/tmp/refbuild/trytest/gdb/chr17test", "chr17test")
    cnt = np.diff(db.offsets.astype(np.int64))
    big = np.flatnonzero((cnt > 32) & (cnt <= 100))
    assert len(big), "fixture lost its frequent oligo"

    # classify genome windows by their per-strand total of in-threshold
    # seed positions (the compact grid's shared budget; trunc fires on
    # either strand exceeding seed_total)
    code_of = np.zeros(256, np.int64)
    for i, c in enumerate(b"ACGT"):
        code_of[c] = i
    g = code_of[db.genome_str.ascii]
    k = db.k
    km = np.zeros(len(g) - k + 1, np.int64)
    kmr = np.zeros(len(g) - k + 1, np.int64)
    gr = g ^ 3
    for i in range(k):
        km = (km << 2) | g[i : len(g) - k + 1 + i]
        kmr = (kmr >> 2) | (gr[i : len(g) - k + 1 + i] << (2 * (k - 1)))
    w = gsnap_se.GsnapParams().seed_total
    contrib = np.where(cnt <= 100, cnt, 0)
    tf = np.convolve(contrib[km], np.ones(89, int), "valid")
    tr = np.convolve(contrib[kmr], np.ones(89, int), "valid")
    hits = (np.isin(km, big) | np.isin(kmr, big)).astype(int)
    dense = np.convolve(hits, np.ones(89, int), "valid")
    within = np.flatnonzero((dense >= 1) & (tf <= w) & (tr <= w))
    assert len(within), "fixture lost its isolated frequent-oligo site"
    pos = int(within[0])
    seq = db.genome_str[pos : pos + 100]
    j = int(np.argmax(np.maximum(tf, tr)))
    assert max(tf[j], tr[j]) > w, "fixture lost its tandem repeat"
    seq_tandem = db.genome_str[j : j + 100]

    runner = runner_mod.GsnapRunner(db)
    rec = runner_mod.Record("ovf", "ovf", seq, "I" * 100)
    rec_t = runner_mod.Record("ovt", "ovt", seq_tandem, "I" * 100)
    res = runner.align_records([rec, rec_t])
    assert not bool(res["overflow"][0]), "tail grid should complete it"
    assert bool(res["overflow"][1]), "tandem window should still rescue"
    out = io.StringIO()
    runner.run([rec, rec_t], out)
    mine = [l for l in out.getvalue().splitlines() if not l.startswith("@")]

    fq = tmp_path / "ovf.fq"
    fq.write_text(f"@ovf\n{seq}\n+\n{'I' * 100}\n"
                  f"@ovt\n{seq_tandem}\n+\n{'I' * 100}\n")
    ref = subprocess.run(
        ["/tmp/refbuild/src/gsnap", "-D", "/tmp/refbuild/trytest/gdb",
         "-d", "chr17test", "--format=sam", str(fq)],
        capture_output=True, text=True, check=True).stdout
    refl = [l for l in ref.splitlines() if not l.startswith("@")]
    assert mine == refl


def test_overflow_rescue_lane_pe(tmp_path):
    """Paired-end overflow rescue: a pair whose first end covers the
    most frequent chr17test 12-mer re-runs at wide caps and matches the
    reference byte-for-byte (run_pe wide lane)."""
    import io
    import subprocess

    from gmap_gsnap.align import runner as runner_mod
    from gmap_gsnap.db.datadir import GenomeDB
    from gmap_gsnap.utils import dna

    if not os.path.isdir("/tmp/refbuild/trytest/gdb"):
        pytest.skip("oracle DB not built")
    db = GenomeDB.open("/tmp/refbuild/trytest/gdb/chr17test", "chr17test")
    cnt = np.diff(db.offsets.astype(np.int64))
    big = np.flatnonzero((cnt > 32) & (cnt <= 100))
    o = int(big[np.argmax(cnt[big])])
    pos = int(db.positions[db.offsets[o]])
    seq5 = db.genome_str[pos : pos + 100]
    seq3 = dna.revcomp_str(db.genome_str[pos + 200 : pos + 300])
    r5 = runner_mod.Record("ovp", "ovp", seq5, "I" * 100)
    r3 = runner_mod.Record("ovp", "ovp", seq3, "I" * 100)
    runner = runner_mod.GsnapRunner(db)
    out = io.StringIO()
    runner.run_pe([r5], [r3], out)
    mine = [l for l in out.getvalue().splitlines() if not l.startswith("@")]

    f1 = tmp_path / "p1.fq"
    f2 = tmp_path / "p2.fq"
    f1.write_text(f"@ovp\n{seq5}\n+\n{'I' * 100}\n")
    f2.write_text(f"@ovp\n{seq3}\n+\n{'I' * 100}\n")
    ref = subprocess.run(
        ["/tmp/refbuild/src/gsnap", "-D", "/tmp/refbuild/trytest/gdb",
         "-d", "chr17test", "--format=sam", str(f1), str(f2)],
        capture_output=True, text=True, check=True).stdout
    refl = [l for l in ref.splitlines() if not l.startswith("@")]
    assert mine == refl
