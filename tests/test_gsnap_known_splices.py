"""Known-splicesites (-s) and SNP+splicesites (config 4) oracle parity.

Builds all database artifacts with OUR tools (iit_store-equivalent
writer, snpindex) in a copy of the oracle DB, then runs BOTH the
reference gsnap and ours on identical inputs — proving artifact format
compatibility and SAM byte parity in one pass.
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


def _genome_seq():
    return "".join(
        l.strip() for l in open(FIXTURE) if not l.startswith(">")
    ).upper()


def _copy_db(tmp_path):
    dbdir = tmp_path / "gdb" / "chr17test"
    shutil.copytree(f"{ORACLE_DB}/chr17test", dbdir,
                    ignore=shutil.ignore_patterns("*.snps", "*.maps"))
    (dbdir / "chr17test.maps").mkdir(exist_ok=True)
    return tmp_path / "gdb", dbdir


def _low_prob_junction(seq):
    """A GT..AG junction whose donor has negligible maxent probability —
    only discoverable via known sites."""
    import re

    p = 60000
    g = seq[p : p + 5000]
    for it in re.finditer("GT", g):
        s = it.start()
        e = g.find("AG", s + 80)
        if 100 < e + 2 - s < 2000:
            return p + s, p + e + 2  # 0-based intron [start, end)
    raise AssertionError("no junction found")


def _rc(x):
    return x.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def _env():
    return dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))


def _run_ours(args):
    return subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.gsnap", *args],
        capture_output=True, text=True, env=_env(), check=True,
    ).stdout


def _run_ref(args):
    return subprocess.run(
        [ORACLE_GSNAP, "--format=sam", *args],
        capture_output=True, text=True, check=True,
    ).stdout


def _body(s):
    return [l for l in s.splitlines() if not l.startswith("@")]


@needs_oracle
def test_known_splicesites_parity(tmp_path):
    gdb, dbdir = _copy_db(tmp_path)
    seq = _genome_seq()
    istart, iend = _low_prob_junction(seq)

    # splicesites map via OUR IIT writer (1-based exon coords around the
    # intron: donor X..X+1, acceptor Y..Y+1; README:848-866)
    ss_txt = (
        f">j.d chr17test:{istart}..{istart + 1} donor\n"
        f">j.a chr17test:{iend}..{iend + 1} acceptor\n"
    )
    from gmap_gsnap.db.iit_text import iit_from_text

    iit_from_text(ss_txt).write(str(dbdir / "chr17test.maps" / "ss.iit"))

    reads = []
    r = seq[istart - 50 : istart] + seq[iend : iend + 50]
    comp = str.maketrans("ACGT", "TGCA")
    reads.append(r)
    reads.append(r.translate(comp)[::-1])
    fq = tmp_path / "ss.fq"
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@k{i}\n{r}\n+\n{'I' * len(r)}\n")

    ref = _run_ref(["-D", str(gdb), "-d", "chr17test", "-s", "ss", str(fq)])
    mine = _run_ours(["-D", str(gdb), "-d", "chr17test", "-s", "ss", str(fq)])
    assert _body(ref) == _body(mine)
    # and the junction really is found as a splice
    assert any("N" in l.split("\t")[5] for l in _body(mine))


@needs_oracle
def test_config4_snps_plus_known_splices(tmp_path):
    """Config 4: SNP-tolerant index (our snpindex artifacts, consumed by
    BOTH aligners) + known splice sites."""
    gdb, dbdir = _copy_db(tmp_path)
    seq = _genome_seq()
    istart, iend = _low_prob_junction(seq)

    flip = {"A": "G", "G": "A", "C": "T", "T": "C"}
    snp_positions = [istart - 11, iend + 14, 15050]  # 1-based
    snp_lines = []
    for i, pos in enumerate(snp_positions):
        ref = seq[pos - 1]
        snp_lines.append(f">rs{i} chr17test:{pos} {ref}{flip[ref]}")

    from gmap_gsnap.db.iit_text import iit_from_text

    iit_from_text("\n".join(snp_lines) + "\n").write(
        str(dbdir / "chr17test.maps" / "snps.iit"))
    ss_txt = (
        f">j.d chr17test:{istart}..{istart + 1} donor\n"
        f">j.a chr17test:{iend}..{iend + 1} acceptor\n"
    )
    iit_from_text(ss_txt).write(str(dbdir / "chr17test.maps" / "ss.iit"))

    subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.snpindex",
         "-D", str(gdb), "-d", "chr17test", "-v", "snps",
         str(dbdir / "chr17test.maps" / "snps.iit")],
        capture_output=True, text=True, env=_env(), check=True,
    )

    # reads carrying ALT alleles across the known junction + a plain sub
    rs = list(seq[istart - 50 : istart] + seq[iend : iend + 50])
    rs[50 - (istart - (snp_positions[0] - 1))] = flip[seq[snp_positions[0] - 1]]
    rs[50 + (snp_positions[1] - 1 - iend)] = flip[seq[snp_positions[1] - 1]]
    r1 = list(seq[15000:15100])
    r1[49] = flip[seq[15049]]
    comp = str.maketrans("ACGT", "TGCA")
    reads = ["".join(r1), "".join(rs), "".join(rs).translate(comp)[::-1]]
    fq = tmp_path / "c4.fq"
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@c{i}\n{r}\n+\n{'I' * len(r)}\n")

    common = ["-D", str(gdb), "-d", "chr17test", "-v", "snps", "-s", "ss", str(fq)]
    ref = _run_ref(common)
    mine = _run_ours(common)
    assert _body(ref) == _body(mine)


@needs_oracle
def test_splicedists_obs_window_parity(tmp_path):
    """Per-site splicedists: annotated intron distances bound the
    shortend partner search (obs trie) with OBSMAX_PENALTY for
    partners beyond them (splicetrie.c:1910; splicetrie_build.c:
    489-527).  Byte parity with the reference across distance-covered,
    distance-excluded, and far-partner configurations."""
    seq = _genome_seq()
    istart, iend = _low_prob_junction(seq)
    d_near = iend - istart            # real junction distance
    far = iend + 3000                 # a second acceptor well beyond

    from gmap_gsnap.db.iit_text import iit_from_text

    reads = [
        # continues at the NEAR acceptor (within obs distance)
        seq[istart - 50 : istart] + seq[iend : iend + 30],
        # continues at the FAR acceptor (beyond obs distance ->
        # penalized/limited by the obs window)
        seq[istart - 50 : istart] + seq[far : far + 30],
    ]
    fq = tmp_path / "sd.fq"
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@sd{i}\n{r}\n+\n{'I' * len(r)}\n")

    for tag, dist in (("cover", d_near + 100), ("tight", d_near - 50)):
        gdb, dbdir = _copy_db(tmp_path / tag)
        ss_txt = (
            f">j.d chr17test:{istart}..{istart + 1} donor {dist}\n"
            f">j.a chr17test:{iend}..{iend + 1} acceptor {dist}\n"
            f">j.a2 chr17test:{far}..{far + 1} acceptor {dist}\n"
        )
        iit_from_text(ss_txt).write(str(dbdir / "chr17test.maps" / "sd.iit"))
        ref = _run_ref(["-D", str(gdb), "-d", "chr17test", "-s", "sd",
                        str(fq)])
        mine = _run_ours(["-D", str(gdb), "-d", "chr17test", "-s", "sd",
                          str(fq)])
        assert _body(ref) == _body(mine), tag


@needs_oracle
def test_introns_format_map(tmp_path):
    """-s with an INTRONS-format IIT (no donor/acceptor tags): sites
    derive from the intron span ends with observed distances
    (Splicetrie_retrieve_via_introns) — byte parity on a junction only
    discoverable via the known intron."""
    gdb, dbdir = _copy_db(tmp_path)
    seq = _genome_seq()
    istart, iend = _low_prob_junction(seq)

    from gmap_gsnap.db.iit_text import iit_from_text

    # gtf_introns emits chr:ends[i]..starts[i+1] — LAST EXON BASE to
    # next exon's FIRST base — so the derived donor (low) and acceptor
    # (high-1) coordinates match the splicesites-file conventions
    intron_txt = f">j.intron1 chr17test:{istart}..{iend + 1}\n"
    iit_from_text(intron_txt).write(str(dbdir / "chr17test.maps" / "in.iit"))

    reads = [seq[istart - 50 : istart] + seq[iend : iend + 50]]
    reads.append(_rc(reads[0]))
    fq = tmp_path / "in.fq"
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@n{i}\n{r}\n+\n{'I' * len(r)}\n")

    ref = _run_ref(["-D", str(gdb), "-d", "chr17test", "-s", "in", str(fq)])
    mine = _run_ours(["-D", str(gdb), "-d", "chr17test", "-s", "in",
                      str(fq)])
    assert _body(ref) == _body(mine)
    assert any("N" in l.split("\t")[5] for l in _body(mine))


@needs_oracle
def test_ambig_splice_noclip(tmp_path):
    """--ambig-splice-noclip (gsnap.c:1247 amb_clip_p=false): with two
    tied acceptor partners the default mode emits a soft-clipped
    ambiguous end, while the flag drops the ambiguous splice so the
    read extends into the intron.  Byte parity with the reference in
    BOTH modes."""
    gdb, dbdir = _copy_db(tmp_path)
    seq = _genome_seq()
    istart, iend = _low_prob_junction(seq)

    # read = 94 bases of exon1 + 6 bases after acceptor1; find a second
    # downstream AG whose following 6 bases match the read tail so both
    # acceptors tie on the short end
    e = 6
    tail = seq[iend : iend + e]
    iend2 = None
    g = seq
    p = iend + 40
    while p < iend + 150000 and p < len(g) - e:
        if g[p - 2 : p] == "AG" and g[p : p + e] == tail and p != iend:
            iend2 = p
            break
        p += 1
    if iend2 is None:
        pytest.skip("no tied second acceptor in fixture window")

    ss_txt = (
        f">j.d chr17test:{istart}..{istart + 1} donor\n"
        f">j.a chr17test:{iend}..{iend + 1} acceptor\n"
        f">j.a2 chr17test:{iend2}..{iend2 + 1} acceptor\n"
    )
    from gmap_gsnap.db.iit_text import iit_from_text

    iit_from_text(ss_txt).write(str(dbdir / "chr17test.maps" / "ss.iit"))

    r = seq[istart - (100 - e) : istart] + tail
    fq = tmp_path / "amb.fq"
    fq.write_text(f"@a0\n{r}\n+\n{'I' * len(r)}\n")

    common = ["-D", str(gdb), "-d", "chr17test", "-s", "ss", str(fq)]
    for extra in ([], ["--ambig-splice-noclip"]):
        ref = _run_ref(common + extra)
        mine = _run_ours(common + extra)
        assert _body(ref) == _body(mine), f"mode {extra}"
