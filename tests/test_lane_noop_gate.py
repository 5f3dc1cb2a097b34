"""Device lane-noop gate (gsnap_gapped._lane_noop_device) must agree
with the host mirror (runner._se_lane_noop) and the device trims with
runner.trim_ends — the gate decides which rows skip the rescue lanes,
so a false positive would silently drop reference output lines."""

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


@pytest.fixture(scope="module")
def runner(tmp_path_factory):
    from gmap_gsnap.align import runner as runner_mod
    from gmap_gsnap.db import build
    from gmap_gsnap.db.datadir import GenomeDB

    tmp = tmp_path_factory.mktemp("db")
    dbdir = build.build_db([FIXTURE], "chr17test", str(tmp), k=12)
    db = GenomeDB.open(dbdir, "chr17test")
    return runner_mod.GsnapRunner(db)


def test_trim_ends_device_matches_host():
    import jax.numpy as jnp

    from gmap_gsnap.align import gsnap_gapped
    from gmap_gsnap.align.runner import trim_ends

    rng = np.random.default_rng(3)
    L = 100
    for dens in (0.0, 0.03, 0.1, 0.4):
        mm = rng.random((40, 6, L)) < dens
        lengths = rng.integers(30, L + 1, 40).astype(np.int32)
        # zero out positions past each length (matrix contract)
        mm &= (np.arange(L)[None, None, :] < lengths[:, None, None])
        t5d, t3d = gsnap_gapped._trim_ends_device(
            jnp.asarray(mm), jnp.asarray(lengths), -3)
        t5d, t3d = np.asarray(t5d), np.asarray(t3d)
        for b in range(40):
            for c in range(6):
                e5, e3 = trim_ends(mm[b, c, : lengths[b]], -3)
                assert (t5d[b, c], t3d[b, c]) == (e5, e3), (dens, b, c)


def test_device_gate_matches_host_gate(runner):
    """Randomized reads: every row the device gate clears must also be
    cleared by the host gate logic, and vice versa."""
    from gmap_gsnap.align.runner import Record

    seq = _genome_seq()
    rng = np.random.default_rng(17)
    L = 100
    recs = []
    for i in range(128):
        p = int(rng.integers(0, len(seq) - 300))
        a = list(seq[p : p + L])
        for _ in range(int(rng.integers(0, 5))):
            a[int(rng.integers(0, L))] = "ACGT"[int(rng.integers(0, 4))]
        a = "".join(a)
        if i % 2:
            a = _rc(a)
        if i % 11 == 0:   # end-indel shaped read
            a = seq[p : p + 60] + seq[p + 62 : p + 62 + 40]
        recs.append(Record(f"g{i}", f"g{i}", a, "I" * len(a)))

    res = runner.fetch_records(runner.dispatch_records(recs))
    full = runner.fetch_record_rows(res, list(range(len(recs))))
    np_a = np.asarray(res["npaths"])[: len(recs)]
    done_a = runner._se_done_level(recs, res)
    dev = np.asarray(res["lane_noop"])[: len(recs)]

    runner._lane_masks.clear()
    runner._lane_trims.clear()
    # prime EVERY candidate (the production _prime_rows now primes only
    # device-flagged slots; the host mirror needs them all)
    jobs = []
    for j in range(len(recs)):
        si = full["row_of"][j]
        cl = np.asarray(full["cand_left"][si]).astype(np.int64)
        cp = np.asarray(full["cand_plusp"][si], bool)
        cn = np.asarray(full["cand_nmm"][si])
        keep = cn < 10**6
        if keep.any():
            jobs.append((recs[j], list(cl[keep]), list(cp[keep])))
    runner._prime_lane_masks(jobs)
    mismatches = []
    for j in range(len(recs)):
        host = (np_a[j] == 1
                and int(full["kind"][full["row_of"][j]][0]) == 0
                and runner._se_lane_noop(
                    recs[j], full, full["row_of"][j], int(done_a[j])))
        if bool(dev[j]) != bool(host):
            mismatches.append((j, bool(dev[j]), bool(host)))
    assert not mismatches, mismatches[:10]


def test_lane_flag_filtering_byte_identical(runner):
    """run() output with device per-candidate lane flags vs with the
    flags stripped (full lane iteration) must be byte-identical — the
    flags may only SKIP provably-empty work."""
    import io

    from gmap_gsnap.align import runner as runner_mod
    from gmap_gsnap.align.runner import Record

    seq = _genome_seq()
    rng = np.random.default_rng(41)
    L = 100
    recs = []
    for i in range(96):
        p = int(rng.integers(0, len(seq) - 300))
        a = seq[p : p + L]
        mode = i % 8
        if mode < 4:
            a = list(a)
            for _ in range(int(rng.integers(0, 5))):
                a[int(rng.integers(0, L))] = "ACGT"[int(rng.integers(0, 4))]
            a = "".join(a)
        elif mode == 4:  # end-indel shaped
            a = seq[p : p + 55] + seq[p + 57 : p + 57 + 45]
        elif mode == 5:  # terminal shaped (half junk)
            a = seq[p : p + 55] + "".join(
                "ACGT"[int(x)] for x in rng.integers(0, 4, 45))
        elif mode == 6:  # unmapped
            a = "".join("ACGT"[int(x)] for x in rng.integers(0, 4, L))
        else:
            a = a[:30] + "N" * 3 + a[33:]
        if i % 2:
            a = _rc(a)
        recs.append(Record(f"f{i}", f"f{i}", a, "I" * L))

    orig_fetch = runner_mod.GsnapRunner.fetch_record_rows

    outs = {}
    for strip in (False, True):
        if strip:
            def stripped(res, rows, _orig=orig_fetch):
                out = _orig(res, rows)
                out.pop("lane_ind", None)
                out.pop("lane_term", None)
                return out
            runner.fetch_record_rows = stripped
        buf = io.StringIO()
        try:
            runner.run(recs, buf, batch_size=32)
        finally:
            if strip:
                del runner.fetch_record_rows
        outs[strip] = buf.getvalue()
    assert outs[False] == outs[True]
