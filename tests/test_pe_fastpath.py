"""Vectorized PE SAM fast-path equivalence: the batched emission
(_pe_sam_fast) must be byte-identical to the scalar sam_pe_records
path on the rows it claims, across trims, MD/NM, TLEN branch cases,
strand combinations, and quality handling."""

import io
import pathlib

import numpy as np
import pytest

FIXTURE = "/root/reference/tests/ss.chr17test"
REPO = pathlib.Path(__file__).resolve().parent.parent


def _genome_seq():
    return "".join(
        l.strip() for l in open(FIXTURE) if not l.startswith(">")
    ).upper()


def _rc(s):
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def test_trim_ends_batch_matches_scalar():
    from gmap_gsnap.align.runner import trim_ends, trim_ends_batch

    rng = np.random.default_rng(11)
    for L in (20, 75, 100):
        for dens in (0.0, 0.02, 0.08, 0.3, 0.7):
            mm = rng.random((200, L)) < dens
            t5, t3 = trim_ends_batch(mm)
            for i in range(mm.shape[0]):
                e5, e3 = trim_ends(mm[i])
                assert (t5[i], t3[i]) == (e5, e3), (L, dens, i)


def test_md_from_positions_matches_md_gapped():
    from gmap_gsnap.align.runner import _md_from_positions
    from gmap_gsnap.io import sam

    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", np.uint8)
    for L in (1, 10, 100):
        for _ in range(50):
            mm = rng.random(L) < 0.15
            ref = bytes(bases[rng.integers(0, 4, L)]).decode()
            exp_md, exp_nm = sam.md_gapped([(mm, ref)], [])
            pos = np.flatnonzero(mm).tolist()
            got = _md_from_positions(pos, "".join(ref[p] for p in pos), L)
            assert got == exp_md
            assert len(pos) == exp_nm


def _mutate(r, n, rng):
    r = list(r)
    for _ in range(n):
        r[int(rng.integers(0, len(r)))] = "ACGT"[int(rng.integers(0, 4))]
    return "".join(r)


@pytest.fixture(scope="module")
def runner(tmp_path_factory):
    from gmap_gsnap.align import runner as runner_mod
    from gmap_gsnap.db import build
    from gmap_gsnap.db.datadir import GenomeDB

    tmp = tmp_path_factory.mktemp("fastpath_db")
    dbdir = build.build_db([FIXTURE], "chr17test", str(tmp), k=12)
    db = GenomeDB.open(dbdir, "chr17test")
    return runner_mod.GsnapRunner(db)


def test_pe_fast_path_byte_identical(runner):
    """run_pe with the fast path on vs off, on a workload mixing
    strands, mismatch loads (0-6/end incl. end-clustered ones that
    trim), indels, unmapped mates, and quality presence."""
    from gmap_gsnap.align.runner import Record

    seq = _genome_seq()
    rng = np.random.default_rng(23)
    L = 100
    recs5, recs3 = [], []
    for i in range(96):
        p = int(rng.integers(0, len(seq) - 800))
        ins = int(rng.integers(220, 600))
        a = seq[p : p + L]
        b = _rc(seq[p + ins - L : p + ins])
        mode = i % 8
        if mode < 4:  # plain mismatches, fast-path eligible
            a = _mutate(a, int(rng.integers(0, 7)), rng)
            b = _mutate(b, int(rng.integers(0, 7)), rng)
        elif mode == 4:  # end-clustered mismatches -> trimming
            a = _mutate(a[:6], 4, rng) + a[6:]
            b = b[:-6] + _mutate(b[-6:], 4, rng)
        elif mode == 5:  # deletion in read 1 -> slow path
            a = seq[p : p + 50] + seq[p + 53 : p + 53 + 50]
        elif mode == 6:  # random mate -> non-concordant -> slow path
            b = "".join("ACGT"[int(x)] for x in rng.integers(0, 4, L))
        else:  # N runs in the read
            a = a[:20] + "N" * 4 + a[24:]
        qual = ("I" * L if i % 3 else None)
        recs5.append(Record(f"r{i}", f"r{i}", a, qual))
        recs3.append(Record(f"r{i}", f"r{i}", b, qual))

    outs = {}
    for fast in (True, False):
        runner.pe_fast = fast
        buf = io.StringIO()
        runner.run_pe(recs5, recs3, buf, batch_size=32)
        outs[fast] = buf.getvalue()
    runner.pe_fast = True
    fast_lines = outs[True].splitlines()
    slow_lines = outs[False].splitlines()
    assert len(fast_lines) == len(slow_lines)
    for fl, sl in zip(fast_lines, slow_lines):
        assert fl == sl


def test_se_fast_path_byte_identical(runner):
    """run() with the SE fast path on vs off: mixed mismatch loads
    (0-3, so the done-level gate routes 2-3-mismatch rows through the
    full-fetch scalar path), strands, indels, unmapped reads."""
    from gmap_gsnap.align.runner import Record

    seq = _genome_seq()
    rng = np.random.default_rng(31)
    L = 100
    recs = []
    for i in range(96):
        p = int(rng.integers(0, len(seq) - 300))
        a = seq[p : p + L]
        mode = i % 8
        if mode < 5:
            a = _mutate(a, int(rng.integers(0, 4)), rng)
        elif mode == 5:
            a = seq[p : p + 50] + seq[p + 53 : p + 53 + 50]
        elif mode == 6:
            a = "".join("ACGT"[int(x)] for x in rng.integers(0, 4, L))
        else:
            a = a[:30] + "N" * 3 + a[33:]
        if i % 2:
            a = _rc(a)
        recs.append(Record(f"s{i}", f"s{i}", a, "I" * L if i % 3 else None))

    outs = {}
    for fast in (True, False):
        runner.pe_fast = fast
        buf = io.StringIO()
        runner.run(recs, buf, batch_size=32)
        outs[fast] = buf.getvalue()
    runner.pe_fast = True
    assert outs[True] == outs[False]


def test_pe_fastpath_spliced(tmp_path):
    """The spliced PE fast path (single local splice ends under -N 1)
    is byte-identical to the scalar sam_pe_records path."""
    import io

    import numpy as np

    from gmap_gsnap.align import runner as runner_mod
    from gmap_gsnap.db import build
    from gmap_gsnap.db.datadir import GenomeDB
    import bench_workloads as bw

    dbdir = build.build_db(["/root/reference/tests/ss.chr17test"],
                           "chr17test", str(tmp_path), k=12)
    db = GenomeDB.open(dbdir, "chr17test")
    seq = db.genome_str[0:]
    rng = np.random.default_rng(21)
    jx = bw.find_junctions(seq, max_n=64)
    r5, r3 = bw.make_pe_splice_workload(seq, 96, rng, jx)
    recs5 = [runner_mod.Record(f"s{i}", f"s{i}", s, "I" * 100)
             for i, s in enumerate(r5)]
    recs3 = [runner_mod.Record(f"s{i}", f"s{i}", s, "I" * 100)
             for i, s in enumerate(r3)]

    outs = []
    for fast in (True, False):
        r = runner_mod.GsnapRunner(db, novelsplicing=True)
        r.pe_fast = fast
        buf = io.StringIO()
        r.run_pe(recs5, recs3, buf, batch_size=96)
        outs.append(buf.getvalue())
    a, b = outs
    al = a.splitlines()
    bl = b.splitlines()
    assert len(al) == len(bl)
    diffs = [(x, y) for x, y in zip(al, bl) if x != y]
    assert not diffs, diffs[:4]
    # the workload actually exercises spliced CIGARs
    assert any("N" in l.split("\t")[5] for l in al if not l.startswith("@"))
