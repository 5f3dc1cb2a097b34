"""Unit tests for the stage3 smoothing pass (smooth.c:475 by_netgap,
:295 by_size DELETE, :325 trim_ends) over chained diagonal segments."""

import numpy as np
import pytest

from gmap_gsnap.align import gmap as gmap_mod


def _mk(gstr: str, qparts):
    """Build (gstr_a, qstr_a, merged) where qparts is a list of
    (qstart, qend, diag) aligned EXACTLY against gstr."""
    qlen = max(qe for _, qe, _ in qparts)
    q = ["A"] * qlen
    for qs, qe, d in qparts:
        for p in range(qs, qe):
            q[p] = gstr[p + d]
    qstr = "".join(q)
    merged = [(qs, qe, qs + d, d) for qs, qe, d in qparts]
    return (gmap_mod._as_bytes(gstr), gmap_mod._as_bytes(qstr), merged)


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(11)
    return "".join("ACGT"[int(x)] for x in rng.integers(0, 4, 400_000))


def test_netgap_deletion(genome):
    """A short internal exon whose flanking 'introns' cancel to ~zero
    net gap is deleted (zero_net_gap, smooth.c:212)."""
    g, q, merged = _mk(genome, [
        (0, 40, 1000),        # solid exon
        (40, 50, 1500),       # 10-match internal short, +500 then -497
        (50, 90, 1003),       # nearly back to the first diagonal
    ])
    out = gmap_mod._smooth_merged(g, q, merged)
    assert [m[3] for m in out] == [1000, 1003]


def test_netgap_keeps_real_intron(genome):
    """Short internal exon between REAL introns (net gap large) is
    MARKed but not deleted by the netgap pass, and its by-chance
    probability across the introns decides by_size."""
    g, q, merged = _mk(genome, [
        (0, 40, 1000),
        (40, 58, 3000),       # 18 matches >= SHORTEXONLEN_NETGAP
        (58, 98, 6000),
    ])
    out = gmap_mod._smooth_merged(g, q, merged)
    assert len(out) == 3


def test_by_size_deletes_improbable(genome):
    """A tiny internal exon inside huge introns is probable by chance
    (prob > DELETE_THRESHOLD) and is deleted (smooth.c:311-315)."""
    g, q, merged = _mk(genome, [
        (0, 40, 1000),
        (40, 46, 150_000),    # 6 matches, ~300 kb combined introns
        (46, 86, 300_000),
    ])
    out = gmap_mod._smooth_merged(g, q, merged)
    assert [m[3] for m in out] == [1000, 300_000]
    # prob check mirrors compute_prob(exonlen+4, intronlen, 8)
    assert gmap_mod._exon_prob(6 + 4, 299_000 + 150_000, 8) > 0.1


def test_trim_ends_chops_terminal_short(genome):
    """A <10-match terminal exon across a long intron is chopped
    (trim_ends, smooth.c:325-341)."""
    g, q, merged = _mk(genome, [
        (0, 8, 500),          # 8-match 5' scrap, ~199 kb upstream
        (8, 60, 200_000),
        (60, 120, 202_000),
    ])
    out = gmap_mod._smooth_merged(g, q, merged)
    assert [m[3] for m in out] == [200_000, 202_000]


def test_trim_ends_keeps_probable_terminal(genome):
    """A 9-match terminal exon across a SHORT intron stays (prob
    below SHORTEXONPROB_END)."""
    g, q, merged = _mk(genome, [
        (0, 9, 800),          # 9 matches, 200 nt intron: improbable
        (9, 60, 1000),
        (60, 120, 3000),
    ])
    out = gmap_mod._smooth_merged(g, q, merged)
    assert len(out) == 3
