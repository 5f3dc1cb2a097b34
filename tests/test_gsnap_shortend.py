"""Short-end known-site splicing (find_spliceends_shortend
stage1hr.c:8330 + find_splicepairs_shortend :10045): with -s known
sites, a read whose splice junction falls within the terminal few bp
(down to 1) still aligns as a splice via partner-site search, with
ambiguous ends (endlength < 2 or multiple matching partners) staying
soft-clipped but XS-tagged.  Also covers the middle-indel seed-querypos
pairing gate (stage1hr.c:4559) that keeps junk 2-3 bp indel flanks out.

The reference is only exercised on maps it handles deterministically
(a single sense junction; + one extra acceptor): with antisense sites
in the same map the 2012 snapshot corrupts memory in the splicetrie
(aborts, empty output, or nondeterministic splice-vs-clip), so the
antisense combinations assert fixed expected SAM fields instead,
matching what the reference emits on its clean runs.
"""

import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest

ORACLE_GSNAP = "/tmp/refbuild/src/gsnap"
ORACLE_DB = "/tmp/refbuild/trytest/gdb"
REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = "/root/reference/tests/ss.chr17test"

needs_oracle = pytest.mark.skipif(
    not (os.path.exists(ORACLE_GSNAP) and os.path.isdir(ORACLE_DB)),
    reason="reference oracle binaries not built",
)

COMP = str.maketrans("ACGT", "TGCA")


def _genome_seq():
    return "".join(
        l.strip() for l in open(FIXTURE) if not l.startswith(">")
    ).upper()


def _junctions(seq):
    """A sense GT..AG junction and an antisense CT..AC junction."""
    out = []
    for p, pat5, pat3 in ((60000, "GT", "AG"), (70000, "CT", "AC")):
        g = seq[p : p + 5000]
        for it in re.finditer(pat5, g):
            s = it.start()
            e = g.find(pat3, s + 80)
            if 100 < e + 2 - s < 2000:
                out.append((p + s, p + e + 2))
                break
    return out


def _make_db(tmp_path, ss_text):
    from gmap_gsnap.db.iit_text import iit_from_text

    dbdir = tmp_path / "gdb" / "chr17test"
    shutil.copytree(f"{ORACLE_DB}/chr17test", dbdir,
                    ignore=shutil.ignore_patterns("*.snps", "*.maps"))
    (dbdir / "chr17test.maps").mkdir(exist_ok=True)
    iit_from_text(ss_text).write(str(dbdir / "chr17test.maps" / "ss.iit"))
    return tmp_path / "gdb"


def _write_fq(path, reads):
    with open(path, "w") as f:
        for n, r in reads:
            f.write(f"@{n}\n{r}\n+\n{'I' * len(r)}\n")


def _run_mine(gdb, fq):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.gsnap", "-D", str(gdb),
         "-d", "chr17test", "-s", "ss", "--format=sam", str(fq)],
        capture_output=True, text=True, env=env, check=True).stdout
    return [l for l in out.splitlines() if not l.startswith("@")]


def _run_ref(gdb, fq):
    """One read per invocation: the reference's shortend path corrupts
    cross-read state (multi-read batches emit nothing or abort)."""
    out = []
    lines = open(fq).read().strip().split("\n")
    for i in range(0, len(lines), 4):
        one = str(fq) + f".one{i}"
        with open(one, "w") as f:
            f.write("\n".join(lines[i : i + 4]) + "\n")
        r = subprocess.run(
            [ORACLE_GSNAP, "-D", str(gdb), "-d", "chr17test", "-s", "ss",
             "--format=sam", one],
            capture_output=True, text=True, check=True)
        out += [l for l in r.stdout.splitlines() if not l.startswith("@")]
    return out


@needs_oracle
def test_shortend_sense_parity(tmp_path):
    seq = _genome_seq()
    (istart, iend), _ = _junctions(seq)
    gdb = _make_db(tmp_path, (
        f">j.d chr17test:{istart}..{istart + 1} donor\n"
        f">j.a chr17test:{iend}..{iend + 1} acceptor\n"))
    reads = []
    for short in (3, 5, 11):     # junction near the read RIGHT end
        reads.append((f"r{short}",
                      seq[istart - (100 - short) : istart]
                      + seq[iend : iend + short]))
    # junction near the LEFT end (l3 omitted: it aborts the reference
    # outright when run singly against this map)
    reads.append(("l8", seq[istart - 8 : istart]
                  + seq[iend : iend + 92]))
    # minus-strand read, short end at the read 5' (aligned right)
    m5 = seq[istart - 95 : istart] + seq[iend : iend + 5]
    reads.append(("m5", m5.translate(COMP)[::-1]))
    # 1 mismatch in the long side still splices
    x4 = list(seq[istart - 96 : istart] + seq[iend : iend + 4])
    x4[40] = {"A": "C", "C": "G", "G": "T", "T": "A"}[x4[40]]
    reads.append(("x4", "".join(x4)))
    # End 8 hole: minus read, short LEFT aligned end over a sense intron
    # stays a soft-clipped terminal in the reference (stage1hr.c:10553),
    # and the seed-querypos indel gate keeps the 6 bp flank from
    # becoming a junk insertion
    lm6 = seq[istart - 6 : istart] + seq[iend : iend + 94]
    reads.append(("lm6", lm6.translate(COMP)[::-1]))
    fq = tmp_path / "se.fq"
    _write_fq(fq, reads)
    mine = _run_mine(gdb, fq)
    assert mine == _run_ref(gdb, fq)
    spliced = [l for l in mine if "N" in l.split("\t")[5]]
    assert len(spliced) == 6  # all but lm6


@needs_oracle
def test_shortend_ambiguous_parity(tmp_path):
    seq = _genome_seq()
    (istart, iend), _ = _junctions(seq)
    gdb = _make_db(tmp_path, (
        f">j.d chr17test:{istart}..{istart + 1} donor\n"
        f">j.a chr17test:{iend}..{iend + 1} acceptor\n"
        f">j.a2 chr17test:{iend + 500}..{iend + 501} acceptor\n"))
    reads = []
    for short in (1, 2):   # both acceptors match the short end ->
        reads.append((f"t{short}",  # ambiguous, soft-clipped + XS tag
                      seq[istart - (100 - short) : istart]
                      + seq[iend : iend + short]))
    # 4 bp distinguishes the acceptors -> unique, clean splice
    reads.append(("u4", seq[istart - 96 : istart] + seq[iend : iend + 4]))
    fq = tmp_path / "amb.fq"
    _write_fq(fq, reads)
    mine = _run_mine(gdb, fq)
    assert mine == _run_ref(gdb, fq)
    assert any("XS:A:+" in l and "S" in l.split("\t")[5] for l in mine)


def test_shortend_antisense_fixed(tmp_path):
    """Antisense (CT..AC) shortend combos: all four strand/side cases
    splice with XS:A:- (fixed expectations; see module docstring for
    why the reference is not diffed here)."""
    if not os.path.isdir(ORACLE_DB):
        pytest.skip("oracle DB not built")
    seq = _genome_seq()
    _, (astart, aend) = _junctions(seq)
    gdb = _make_db(tmp_path, (
        f">k.d chr17test:{aend + 1}..{aend} donor\n"
        f">k.a chr17test:{astart + 1}..{astart} acceptor\n"))
    reads = [
        ("ap5", seq[astart - 95 : astart] + seq[aend : aend + 5]),
        ("al5", seq[astart - 5 : astart] + seq[aend : aend + 95]),
        ("am5", (seq[astart - 95 : astart]
                 + seq[aend : aend + 5]).translate(COMP)[::-1]),
        ("alm5", (seq[astart - 5 : astart]
                  + seq[aend : aend + 95]).translate(COMP)[::-1]),
    ]
    fq = tmp_path / "anti.fq"
    _write_fq(fq, reads)
    mine = {l.split("\t")[0]: l.split("\t") for l in _run_mine(gdb, fq)}
    gap = aend - astart
    assert mine["ap5"][5] == f"95M{gap}N5M" and "XS:A:-" in mine["ap5"]
    assert mine["al5"][5] == f"5M{gap}N95M" and "XS:A:-" in mine["al5"]
    assert mine["am5"][5] == f"95M{gap}N5M" and mine["am5"][1] == "16"
    assert mine["alm5"][5] == f"5M{gap}N95M" and mine["alm5"][1] == "16"
