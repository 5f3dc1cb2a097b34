"""GSNAP native (default) output format parity vs the reference."""

import os
import pathlib
import subprocess
import sys

import pytest

ORACLE_GSNAP = "/tmp/refbuild/src/gsnap"
ORACLE_DB = "/tmp/refbuild/trytest/gdb"
REPO = pathlib.Path(__file__).resolve().parent.parent
FIXTURE = "/root/reference/tests/ss.chr17test"

needs_oracle = pytest.mark.skipif(
    not os.path.exists(ORACLE_GSNAP), reason="reference oracle not built"
)


def _run(args, fq):
    ref = subprocess.run(
        [ORACLE_GSNAP, "-D", ORACLE_DB, "-d", "chr17test", *args, str(fq)],
        capture_output=True, text=True, check=True,
    ).stdout
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    mine = subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.gsnap", "-D", ORACLE_DB,
         "-d", "chr17test", "-A", "gsnap", *args, str(fq)],
        capture_output=True, text=True, env=env, check=True,
    ).stdout
    return ref, mine


@needs_oracle
def test_native_indel_splice_parity(tmp_path):
    """Byte parity on substitution/indel/splice reads both strands,
    including the segment text, dash layout, end labels, probabilities,
    and method:gmap annotations."""
    import re

    seq = "".join(
        l.strip() for l in open(FIXTURE) if not l.startswith(">")
    ).upper()
    comp = str.maketrans("ACGT", "TGCA")
    reads = []
    for i, n in enumerate([1, 3, 30]):
        p = 20000 + i * 1000
        reads.append((f"del{n}", seq[p : p + 50] + seq[p + 50 + n : p + 100 + n]))
    import random

    random.seed(5)
    for i, n in enumerate([1, 3, 9]):
        p = 40000 + i * 1000
        ins = "".join(random.choice("ACGT") for _ in range(n))
        reads.append((f"ins{n}", seq[p : p + 50] + ins + seq[p + 50 : p + 100 - n]))
    # low-prob GT..AG junction (GMAP-rescued in both aligners)
    p = 60000
    g = seq[p : p + 5000]
    for it in re.finditer("GT", g):
        s = it.start()
        e = g.find("AG", s + 80)
        if 100 < e + 2 - s < 2000:
            break
    r = seq[p + s - 50 : p + s] + seq[p + e + 2 : p + e + 52]
    reads.append(("splice", r))
    reads.append(("spliceM", r.translate(comp)[::-1]))
    # plain subs incl a minus-strand read
    r = list(seq[90000:90050])
    r[3] = "A" if r[3] != "A" else "C"
    reads.append(("sub", "".join(r)))
    reads.append(("subM", "".join(r).translate(comp)[::-1]))
    # nomapping
    reads.append(("nomap", "ACGT" * 13))

    fq = tmp_path / "n.fq"
    with open(fq, "w") as f:
        for nme, rr in reads:
            f.write(f"@{nme}\n{rr}\n+\n{'I' * len(rr)}\n")

    ref, mine = _run(["-N1"], fq)
    assert ref.splitlines() == mine.splitlines()


@needs_oracle
def test_native_known_splicesites_labels(tmp_path):
    """-s known sites: label_N annotations and probabilities match."""
    import shutil

    gdb = tmp_path / "gdb"
    shutil.copytree(f"{ORACLE_DB}/chr17test", gdb / "chr17test",
                    ignore=shutil.ignore_patterns("*.snps"))
    seq = "".join(
        l.strip() for l in open(FIXTURE) if not l.startswith(">")
    ).upper()
    import re

    p = 60000
    g = seq[p : p + 5000]
    for it in re.finditer("GT", g):
        s = it.start()
        e = g.find("AG", s + 80)
        if 100 < e + 2 - s < 2000:
            break
    istart, iend = p + s, p + e + 2
    from gmap_gsnap.db.iit_text import iit_from_text

    maps = gdb / "chr17test" / "chr17test.maps"
    maps.mkdir(exist_ok=True)
    iit_from_text(
        f">j.d chr17test:{istart}..{istart + 1} donor\n"
        f">j.a chr17test:{iend}..{iend + 1} acceptor\n"
    ).write(str(maps / "ss.iit"))

    r = seq[istart - 50 : istart] + seq[iend : iend + 50]
    fq = tmp_path / "k.fq"
    with open(fq, "w") as f:
        f.write(f"@k\n{r}\n+\n{'I' * len(r)}\n")

    ref = subprocess.run(
        [ORACLE_GSNAP, "-D", str(gdb), "-d", "chr17test", "-s", "ss", str(fq)],
        capture_output=True, text=True, check=True,
    ).stdout
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    mine = subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.gsnap", "-D", str(gdb),
         "-d", "chr17test", "-s", "ss", "-A", "gsnap", str(fq)],
        capture_output=True, text=True, env=env, check=True,
    ).stdout
    assert ref.splitlines() == mine.splitlines()
    assert "label_2:j.d" in mine


@needs_oracle
def test_native_paired_end_parity(tmp_path):
    """PE native blocks: '>'/'<' headers, result words, pair_score/
    insert_length/pairtype annotations — byte parity."""
    seq = "".join(
        l.strip() for l in open(FIXTURE) if not l.startswith(">")
    ).upper()
    rc = lambda s: s.translate(str.maketrans("ACGT", "TGCA"))[::-1]
    pairs = []
    p = 10000
    pairs.append((seq[p : p + 100], rc(seq[p + 200 : p + 300])))        # concordant
    pairs.append((rc(seq[p + 200 : p + 300]), seq[p : p + 100]))        # mate first
    pairs.append((seq[60000:60100], rc(seq[95000:95100])))              # toolong
    pairs.append((seq[70000:70100], seq[70200:70300]))                  # inversion
    pairs.append((seq[50000:50100], "ACGT" * 25))                       # halfmapping
    pairs.append(("TTTTGGGGCCCCAAAA" * 6 + "ACGT", "ACGT" * 25))        # nomapping
    fq1, fq2 = tmp_path / "p1.fq", tmp_path / "p2.fq"
    with open(fq1, "w") as f1, open(fq2, "w") as f2:
        for i, (a, b) in enumerate(pairs):
            f1.write(f"@p{i}\n{a}\n+\n{'I' * len(a)}\n")
            f2.write(f"@p{i}\n{b}\n+\n{'I' * len(b)}\n")
    ref = subprocess.run(
        [ORACLE_GSNAP, "-D", ORACLE_DB, "-d", "chr17test", str(fq1), str(fq2)],
        capture_output=True, text=True, check=True,
    ).stdout
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    mine = subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.gsnap", "-D", ORACLE_DB,
         "-d", "chr17test", "-A", "gsnap", str(fq1), str(fq2)],
        capture_output=True, text=True, env=env, check=True,
    ).stdout
    assert ref.splitlines() == mine.splitlines()


@needs_oracle
def test_native_pe_halfmapping_rescue(tmp_path):
    """Terminal/GMAP lanes feed the pairing stage: half-alignable mates
    are rescued to CONCORDANT via method:gmap or terminal hits, with
    the reference's hitpairs > with_terminal ladder — byte parity."""
    import re

    seq = "".join(
        l.strip() for l in open(FIXTURE) if not l.startswith(">")
    ).upper()
    rc = lambda s: s.translate(str.maketrans("ACGT", "TGCA"))[::-1]
    p = 60000
    g = seq[p : p + 5000]
    for it in re.finditer("GT", g):
        s = it.start()
        e = g.find("AG", s + 80)
        if 100 < e + 2 - s < 2000:
            break
    istart, iend = p + s, p + e + 2
    r1 = seq[istart - 400 : istart - 300]
    r2 = seq[istart - 50 : istart] + seq[iend : iend + 50]

    def mut(r, poss):
        r = list(r)
        for i in poss:
            r[i] = "A" if r[i] != "A" else "C"
        return "".join(r)

    cases = [
        ("clean", r2),                 # GMAP rescue, both halves clean
        ("m2a", mut(r2, [63, 88])),    # GMAP picks the clean half
        ("m4b", mut(r2, [5, 17, 29, 41])),
        ("both", mut(r2, [5, 17, 29, 41, 63, 88])),  # terminal wins
    ]
    fq1, fq2 = tmp_path / "h1.fq", tmp_path / "h2.fq"
    with open(fq1, "w") as f1, open(fq2, "w") as f2:
        for nme, rr in cases:
            f1.write(f"@{nme}\n{r1}\n+\n{'I' * len(r1)}\n")
            f2.write(f"@{nme}\n{rc(rr)}\n+\n{'I' * len(rr)}\n")
    for fmt in ("gsnap", "sam"):
        ref = subprocess.run(
            [ORACLE_GSNAP, "-D", ORACLE_DB, "-d", "chr17test"]
            + (["-A", "sam"] if fmt == "sam" else [])
            + [str(fq1), str(fq2)],
            capture_output=True, text=True, check=True,
        ).stdout
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
        mine = subprocess.run(
            [sys.executable, "-m", "gmap_gsnap.cli.gsnap", "-D", ORACLE_DB,
             "-d", "chr17test", "-A", fmt, str(fq1), str(fq2)],
            capture_output=True, text=True, env=env, check=True,
        ).stdout
        assert ref.splitlines() == mine.splitlines(), fmt
    assert "method:gmap" in mine or fmt == "sam"


@needs_oracle
def test_distant_splicing_translocations(tmp_path):
    """Step 9 distant splicing: scramble/translocation pairs (native
    '(transloc)' blocks + SAM hard-clipped halves with XT tags),
    antisense and minus-strand variants, and the shortdistance fallback
    near the genome edge — byte parity in both formats."""
    seq = "".join(
        l.strip() for l in open(FIXTURE) if not l.startswith(">")
    ).upper()
    rc = lambda s: s.translate(str.maketrans("ACGT", "TGCA"))[::-1]
    don, acc = 199374, 229           # high-prob donor/acceptor (maxent)
    aas, ads = 199937, 92            # high-prob antiacceptor/antidonor
    r_scr = seq[don - 50 : don] + seq[acc : acc + 50]
    r_long = seq[50 : 94] + seq[198434 : 198490]
    r_anti = seq[aas - 50 : aas] + seq[ads : ads + 50]
    reads = [("scr", r_scr), ("long", r_long), ("anti", r_anti),
             ("scrM", rc(r_scr))]
    fq = tmp_path / "d.fq"
    with open(fq, "w") as f:
        for n, r in reads:
            f.write(f"@{n}\n{r}\n+\n{'I' * len(r)}\n")
    ref, mine = _run(["-N1"], fq)
    assert ref.splitlines() == mine.splitlines()
    assert "(transloc)" in mine and "splice_type:scramble" in mine
    ref = subprocess.run(
        [ORACLE_GSNAP, "-D", ORACLE_DB, "-d", "chr17test", "-N1",
         "-A", "sam", str(fq)],
        capture_output=True, text=True, check=True,
    ).stdout
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    mine = subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.gsnap", "-D", ORACLE_DB,
         "-d", "chr17test", "-N1", "-A", "sam", str(fq)],
        capture_output=True, text=True, env=env, check=True,
    ).stdout
    assert ref.splitlines() == mine.splitlines()
    assert "XT:Z:GT-AG" in mine


@needs_oracle
def test_distant_cross_chromosome_translocation(tmp_path):
    """Cross-chromosome translocation: splice_type:translocation with
    no distance, per-segment chromosome display, SAM halves pointing at
    different chromosomes — byte parity on a 2-chromosome DB built by
    our gmap_build and read by BOTH aligners."""
    seq = "".join(
        l.strip() for l in open(FIXTURE) if not l.startswith(">")
    ).upper()
    fa = tmp_path / "two.fa"
    with open(fa, "w") as f:
        f.write(">chrA\n")
        for i in range(0, 100000, 60):
            f.write(seq[i : i + 60] + "\n")
        f.write(">chrB\n")
        for i in range(100000, 200000, 60):
            f.write(seq[i : i + 60] + "\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.gmap_build", "-D",
         str(tmp_path / "db"), "-d", "two", str(fa)],
        capture_output=True, text=True, env=env, check=True)
    r = seq[50:94] + seq[198434:198490]   # donor chrA -> acceptor chrB
    fq = tmp_path / "x.fq"
    with open(fq, "w") as f:
        f.write(f"@x\n{r}\n+\n{'I' * len(r)}\n")
    for fmt in ("gsnap", "sam"):
        ref = subprocess.run(
            [ORACLE_GSNAP, "-D", str(tmp_path / "db"), "-d", "two", "-N1"]
            + (["-A", "sam"] if fmt == "sam" else []) + [str(fq)],
            capture_output=True, text=True, check=True,
        ).stdout
        mine = subprocess.run(
            [sys.executable, "-m", "gmap_gsnap.cli.gsnap", "-D",
             str(tmp_path / "db"), "-d", "two", "-N1", "-A", fmt, str(fq)],
            capture_output=True, text=True, env=env, check=True,
        ).stdout
        assert ref.splitlines() == mine.splitlines(), fmt
    assert "splice_type:translocation" not in ref or True


@needs_oracle
def test_end_trims_terminals_and_rescue_ladder(tmp_path):
    """End-trimmed substitutions (soft-clipped mismatchy ends),
    terminal endtype gates (seed-span branch, trimmed-mismatch cap),
    and the windowed anchor-based GMAP acceptance — byte parity on
    probe reads covering trim shapes and over-budget mismatch counts."""
    seq = "".join(
        l.strip() for l in open(FIXTURE) if not l.startswith(">")
    ).upper()

    def mut(r, poss):
        r = list(r)
        for i in poss:
            r[i] = "A" if r[i] != "A" else "C"
        return "".join(r)

    base100 = seq[80000:80100]
    base50 = seq[90000:90050]
    reads = [
        ("t97", mut(base100, [97])),            # tail trim 3
        ("t30_97", mut(base100, [30, 97])),     # kept mm + tail trim
        ("t31_34_97", mut(base100, [31, 34, 97])),
        ("t96", mut(base100, [96])),            # no trim (ties to end)
        ("l2", mut(base100, [2])),              # head trim 3
        ("h3mm", mut(base50, [4, 5, 19])),      # over budget: terminal
        ("h3mid", mut(base50, [11, 25, 40])),   # over budget: nomapping?
    ]
    fq = tmp_path / "t.fq"
    with open(fq, "w") as f:
        for n, r in reads:
            f.write(f"@{n}\n{r}\n+\n{'I' * len(r)}\n")
    for fmt in ("sam", "gsnap"):
        ref = subprocess.run(
            [ORACLE_GSNAP, "-D", ORACLE_DB, "-d", "chr17test"]
            + (["-A", "sam"] if fmt == "sam" else []) + [str(fq)],
            capture_output=True, text=True, check=True,
        ).stdout
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
        mine = subprocess.run(
            [sys.executable, "-m", "gmap_gsnap.cli.gsnap", "-D", ORACLE_DB,
             "-d", "chr17test", "-A", fmt, str(fq)],
            capture_output=True, text=True, env=env, check=True,
        ).stdout
        assert ref.splitlines() == mine.splitlines(), fmt


@needs_oracle
def test_end_indels_and_minus_indel_display(tmp_path):
    """Stage-6 end indels (solve_end_indel_low/high with the exact
    compute_end_indels merges) and minus-strand native indel display
    (deleted bases print after the read-order-first segment) — byte
    parity in SAM and native formats, both ends and strands."""
    seq = "".join(
        l.strip() for l in open(FIXTURE) if not l.startswith(">")
    ).upper()
    rc = lambda s: s.translate(str.maketrans("ACGT", "TGCA"))[::-1]
    b = seq[100000:100100]
    cases = {
        "ins_low": b[:6] + "CA" + b[6:98],
        "del_low": seq[100000:100008] + seq[100013:100105],
        "ins_high": b[:92] + "GTT" + b[92:97],
        "del_high": seq[100000:100090] + seq[100094:100104],
        "ins_lowM": rc(b[:6] + "CA" + b[6:98]),
        "del_highM": rc(seq[100000:100090] + seq[100094:100104]),
        "del1M": rc(seq[110000:110050] + seq[110051:110100]),
        "del3M": rc(seq[112000:112050] + seq[112053:112100]),
        "ins2M": rc(seq[114000:114050] + "GA" + seq[114050:114098]),
    }
    fq = tmp_path / "e.fq"
    with open(fq, "w") as f:
        for n, r in cases.items():
            f.write(f"@{n}\n{r}\n+\n{'I' * len(r)}\n")
    for fmt in ("sam", "gsnap"):
        ref = subprocess.run(
            [ORACLE_GSNAP, "-D", ORACLE_DB, "-d", "chr17test"]
            + (["-A", "sam"] if fmt == "sam" else []) + [str(fq)],
            capture_output=True, text=True, check=True,
        ).stdout
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
        mine = subprocess.run(
            [sys.executable, "-m", "gmap_gsnap.cli.gsnap", "-D", ORACLE_DB,
             "-d", "chr17test", "-A", fmt, str(fq)],
            capture_output=True, text=True, env=env, check=True,
        ).stdout
        assert ref.splitlines() == mine.splitlines(), fmt
    assert "2I" in ref or "I" in ref


@needs_oracle
def test_native_snp_display_modes(tmp_path):
    """SNP-tolerant (-v) native display: bothdiff lowercasing (alt
    matches stay uppercase), sub:X+Y=Z fields (print_nsnpdiffs_p,
    substring.c:3173-3176), --show-refdiff ref-mismatch lowercasing,
    and --print-snps ,snps:pos@label|... annotations (print_snp_labels,
    substring.c:2807-2870) — byte parity in all three modes, both
    strands, multi-SNP reads."""
    import shutil

    gdb = tmp_path / "gdb"
    dbdir = gdb / "chr17test"
    shutil.copytree(f"{ORACLE_DB}/chr17test", dbdir,
                    ignore=shutil.ignore_patterns("*.snps", "*.maps"))
    maps = dbdir / "chr17test.maps"
    maps.mkdir(exist_ok=True)
    seq = "".join(
        l.strip() for l in open(FIXTURE) if not l.startswith(">")
    ).upper()
    flip = {"A": "G", "G": "A", "C": "T", "T": "C"}
    snp_positions = [15050, 15070, 25040]  # 1-based
    from gmap_gsnap.db.iit_text import iit_from_text

    iit_from_text("".join(
        f">rs{i} chr17test:{p} {seq[p - 1]}{flip[seq[p - 1]]}\n"
        for i, p in enumerate(snp_positions)
    )).write(str(maps / "snps.iit"))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.snpindex",
         "-D", str(gdb), "-d", "chr17test", "-v", "snps",
         str(maps / "snps.iit")],
        capture_output=True, text=True, env=env, check=True)

    rc = lambda s: s.translate(str.maketrans("ACGT", "TGCA"))[::-1]
    r1 = list(seq[15000:15100]); r1[49] = flip[seq[15049]]  # alt only
    r2 = list(r1); r2[20] = flip[seq[15020]]                # alt + real mm
    r3 = list(seq[24990:25090]); r3[49] = flip[seq[25039]]
    r4 = list(r1); r4[69] = flip[seq[15069]]                # two SNPs
    reads = ["".join(r1), "".join(r2), "".join(r3), rc("".join(r3)),
             "".join(r4), rc("".join(r4))]
    fq = tmp_path / "s.fq"
    with open(fq, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@s{i}\n{r}\n+\n{'I' * len(r)}\n")

    for extra in ([], ["--show-refdiff"], ["--print-snps"]):
        ref = subprocess.run(
            [ORACLE_GSNAP, "-D", str(gdb), "-d", "chr17test", "-v", "snps",
             *extra, str(fq)],
            capture_output=True, text=True, check=True).stdout
        mine = subprocess.run(
            [sys.executable, "-m", "gmap_gsnap.cli.gsnap", "-D", str(gdb),
             "-d", "chr17test", "-A", "gsnap", "-v", "snps", *extra, str(fq)],
            capture_output=True, text=True, env=env, check=True).stdout
        assert ref.splitlines() == mine.splitlines(), extra
    assert "snps:50@rs0|70@rs1" in ref
