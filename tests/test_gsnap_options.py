"""Option-surface parity: non-default scoring/window knobs must change
behavior the same way the reference binary's flags do (gsnap.c:343-482),
byte-compared on SAM output."""

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
    not (os.path.exists(ORACLE_GSNAP) and os.path.isdir(ORACLE_DB)),
    reason="reference oracle binaries not built",
)


def _genome_seq():
    return "".join(
        l.strip() for l in open(FIXTURE) if not l.startswith(">")
    ).upper()


def _rc(s):
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def _run_both(extra, fastqs):
    ref = subprocess.run(
        [ORACLE_GSNAP, "-D", ORACLE_DB, "-d", "chr17test", "--format=sam"]
        + extra + [str(f) for f in fastqs],
        capture_output=True, text=True, check=True,
    ).stdout
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    mine = subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.gsnap", "-D", ORACLE_DB,
         "-d", "chr17test"] + extra + [str(f) for f in fastqs],
        capture_output=True, text=True, env=env, check=True,
    ).stdout
    ref_l = [l for l in ref.splitlines() if not l.startswith("@")]
    my_l = [l for l in mine.splitlines() if not l.startswith("@")]
    return ref_l, my_l


@needs_oracle
def test_max_middle_indel_limits(tmp_path):
    """-y/-z caps: a 6 bp insertion read aligns with default -y 9 but
    must lose its indel solution at -y 3 — both engines byte-equal in
    both configurations."""
    seq = _genome_seq()
    p = 60000
    ins_read = seq[p : p + 47] + "ACGTAC" + seq[p + 47 : p + 94]
    del_read = seq[p + 5000 : p + 5050] + seq[p + 5058 : p + 5108]
    fq = tmp_path / "i.fq"
    with open(fq, "w") as f:
        for i, r in enumerate([ins_read, del_read]):
            f.write(f"@i{i}\n{r}\n+\n{'I' * len(r)}\n")
    for extra in ([], ["-y", "3", "-z", "4"]):
        ref_l, my_l = _run_both(extra, [fq])
        assert ref_l == my_l, extra


@needs_oracle
def test_indel_penalty(tmp_path):
    """-i raises the indel penalty so a mismatch solution outranks a
    short-deletion solution."""
    seq = _genome_seq()
    p = 70000
    del_read = seq[p : p + 50] + seq[p + 51 : p + 101]  # 1 bp deletion
    fq = tmp_path / "p.fq"
    with open(fq, "w") as f:
        f.write(f"@d0\n{del_read}\n+\n{'I' * len(del_read)}\n")
    for extra in ([], ["-i", "5"]):
        ref_l, my_l = _run_both(extra, [fq])
        assert ref_l == my_l, extra


@needs_oracle
def test_pairmax_dna(tmp_path):
    """--pairmax-dna: a 900 bp-insert pair is concordant by default but
    must classify TOOLONG at --pairmax-dna 400."""
    seq = _genome_seq()
    p = 40000
    r1 = seq[p : p + 100]
    r2 = _rc(seq[p + 800 : p + 900])
    fq1, fq2 = tmp_path / "m_1.fq", tmp_path / "m_2.fq"
    with open(fq1, "w") as f:
        f.write(f"@m0\n{r1}\n+\n{'I' * 100}\n")
    with open(fq2, "w") as f:
        f.write(f"@m0\n{r2}\n+\n{'I' * 100}\n")
    for extra in ([], ["--pairmax-dna", "400"]):
        ref_l, my_l = _run_both(extra, [fq1, fq2])
        assert ref_l == my_l, extra


@needs_oracle
def test_localsplicedist(tmp_path):
    """-w: a spliced read with a ~2.5 kb intron aligns with -N1 but the
    splice must be rejected at -w 1000."""
    import numpy as np

    from gmap_gsnap.db import build
    from gmap_gsnap.ops import maxent

    g = build.load_genome_fasta([FIXTURE])
    seq = _genome_seq()
    pos = np.arange(100, len(seq) - 100)
    dp = maxent.splice_prob_np(g.codes, pos, "donor")
    ap = maxent.splice_prob_np(g.codes, pos, "acceptor")
    dsites = pos[dp > 0.97]
    asites = pos[ap > 0.97]
    read = None
    for d in dsites:
        k = np.searchsorted(asites, d + 1500)
        if k < len(asites) and asites[k] <= d + 5000:
            a = int(asites[k])
            read = seq[int(d) - 50 : int(d)] + seq[a : a + 50]
            break
    assert read is not None
    fq = tmp_path / "w.fq"
    with open(fq, "w") as f:
        f.write(f"@w0\n{read}\n+\n{'I' * len(read)}\n")
    for extra in (["-N", "1"], ["-N", "1", "-w", "1000"]):
        ref_l, my_l = _run_both(extra, [fq])
        assert ref_l == my_l, extra


@needs_oracle
def test_trim_mismatch_score(tmp_path):
    """--trim-mismatch-score 0 disables end trimming; -5 trims more
    aggressively."""
    seq = _genome_seq()
    p = 30000
    r = seq[p : p + 100]
    r = "".join("ACGT"[(ord(c) + 1) % 4] for c in r[:5]) + r[5:]
    fq = tmp_path / "t.fq"
    with open(fq, "w") as f:
        f.write(f"@t0\n{r}\n+\n{'I' * 100}\n")
    for extra in ([], ["--trim-mismatch-score", "0"],
                  ["--trim-mismatch-score", "-5"]):
        ref_l, my_l = _run_both(extra, [fq])
        assert ref_l == my_l, extra


def test_sam_use_0M_insertion():
    from gmap_gsnap.io import sam

    assert sam.insert_0M("50M3I47M") == "50M3I47M"
    assert sam.insert_0M("10M3I2D85M") == "10M3I0M2D85M"
    assert sam.insert_0M("10M100N3D87M") == "10M100N0M3D87M"
    assert sam.insert_0M("5S10M2I100N83M") == "5S10M2I0M100N83M"


@needs_oracle
def test_clip_overlap(tmp_path):
    """--clip-overlap hard-clips the inside halves of overlapping
    proper pairs (Stage3pair_overlap): plus/minus-first pairs, odd and
    even overlaps, mismatches near the clip boundary."""
    seq = _genome_seq()
    pairs = []
    p = 80000
    # insert 150 -> overlap 50 (even); insert 145 -> overlap 55 (odd)
    for ins in (150, 145):
        r1 = seq[p : p + 100]
        r2 = _rc(seq[p + ins - 100 : p + ins])
        pairs.append((r1, r2))
    # mate-first orientation (read1 minus)
    r1 = seq[p + 60 : p + 160]
    r2 = _rc(seq[p : p + 100])
    pairs.append((r2, _rc(r1)))
    # mismatches inside the would-be clipped region
    r1 = list(seq[p : p + 100])
    r1[95] = "ACGT"[(ord(r1[95]) + 1) % 4]
    r2 = _rc(seq[p + 60 : p + 160])
    pairs.append(("".join(r1), r2))
    fq1, fq2 = tmp_path / "c_1.fq", tmp_path / "c_2.fq"
    with open(fq1, "w") as f1, open(fq2, "w") as f2:
        for i, (a, b) in enumerate(pairs):
            f1.write(f"@c{i}\n{a}\n+\n{'I' * len(a)}\n")
            f2.write(f"@c{i}\n{b}\n+\n{'I' * len(b)}\n")
    for extra in ([], ["--clip-overlap"]):
        ref_l, my_l = _run_both(extra, [fq1, fq2])
        assert ref_l == my_l, extra
    assert any("H" in l.split("\t")[5] for l in my_l)


@needs_oracle
def test_adapter_strip(tmp_path):
    """-a paired: short-insert pairs reading into adapters realign
    after Shortread_chop_primers; byte parity incl. the chopped SEQ."""
    seq = _genome_seq()
    p = 90000
    adapter = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCAC"
    pairs = []
    for ins in (70, 55):
        frag = seq[p : p + ins]
        r1 = (frag + adapter)[:100]
        r2 = (_rc(frag) + _rc("ACACTCTTTCCCTACACGACGCTCTTCCGATCT"))[:100]
        pairs.append((r1, r2))
        p += 2000
    fq1, fq2 = tmp_path / "a_1.fq", tmp_path / "a_2.fq"
    with open(fq1, "w") as f1, open(fq2, "w") as f2:
        for i, (a, b) in enumerate(pairs):
            f1.write(f"@ad{i}\n{a}\n+\n{'I' * len(a)}\n")
            f2.write(f"@ad{i}\n{b}\n+\n{'I' * len(b)}\n")
    for extra in ([], ["-a", "paired"]):
        ref_l, my_l = _run_both(extra, [fq1, fq2])
        assert ref_l == my_l, extra


@needs_oracle
def test_orientation_modes(tmp_path):
    """-o RF / FF change which end inverts at input; byte parity on
    pairs constructed in each protocol's geometry."""
    seq = _genome_seq()
    p = 110000
    frag1, frag2 = seq[p : p + 100], seq[p + 200 : p + 300]
    cases = {
        # RF (mate-pair): read1 reverse, read2 forward
        "RF": (_rc(frag1), frag2),
        # FF: both forward
        "FF": (frag1, frag2),
    }
    for mode, (r1, r2) in cases.items():
        fq1, fq2 = tmp_path / f"{mode}_1.fq", tmp_path / f"{mode}_2.fq"
        with open(fq1, "w") as f:
            f.write(f"@o0\n{r1}\n+\n{'I' * 100}\n")
        with open(fq2, "w") as f:
            f.write(f"@o0\n{r2}\n+\n{'I' * 100}\n")
        ref_l, my_l = _run_both(["-o", mode], [fq1, fq2])
        assert ref_l == my_l, mode


@needs_oracle
def test_fastq_id_fields(tmp_path):
    seq = _genome_seq()
    fq = tmp_path / "f.fq"
    with open(fq, "w") as f:
        f.write(f"@machine:1:FC706VJ field1 field2\n{seq[5000:5100]}\n"
                f"+\n{'I' * 100}\n")
    for extra in ([], ["--fastq-id-start", "2", "--fastq-id-end", "2"],
                  ["--fastq-id-start", "1", "--fastq-id-end", "2"]):
        ref_l, my_l = _run_both(extra, [fq])
        assert ref_l == my_l, extra


@needs_oracle
def test_merge_distant_samechr(tmp_path):
    """--merge-distant-samechr prints same-chromosome distant splices
    as one spliced record instead of two translocation halves."""
    import numpy as np

    from gmap_gsnap.db import build
    from gmap_gsnap.ops import maxent

    g = build.load_genome_fasta([FIXTURE])
    seq = _genome_seq()
    pos = np.arange(100, len(seq) - 100)
    dp = maxent.splice_prob_np(g.codes, pos, "donor")
    ap = maxent.splice_prob_np(g.codes, pos, "acceptor")
    dsites = pos[dp > 0.97]
    asites = pos[ap > 0.97]
    read = None
    for d in dsites:
        k = np.searchsorted(asites, d + 1500)
        if k < len(asites) and asites[k] <= d + 5000:
            a = int(asites[k])
            read = seq[int(d) - 50 : int(d)] + seq[a : a + 50]
            break
    assert read is not None
    fq = tmp_path / "mg.fq"
    with open(fq, "w") as f:
        f.write(f"@g0\n{read}\n+\n{'I' * len(read)}\n")
    base = ["-N", "1", "-w", "500"]
    for extra in (base, base + ["--merge-distant-samechr"]):
        ref_l, my_l = _run_both(extra, [fq])
        assert ref_l == my_l, extra
    assert any("N" in l.split("\t")[5] for l in my_l), my_l


@needs_oracle
def test_snpsdir_splicingdir(tmp_path):
    """-V/--splicingdir: index artifacts living outside the genome dir."""
    import shutil

    seq = _genome_seq()
    # copy the db WITHOUT snp/map artifacts, relocate them to side dirs
    src = pathlib.Path(ORACLE_DB) / "chr17test"
    dbdir = tmp_path / "gdb" / "chr17test"
    shutil.copytree(src, dbdir,
                    ignore=shutil.ignore_patterns("*.maps"))
    snpdir = tmp_path / "snps"
    snpdir.mkdir()
    moved = False
    for f in list(dbdir.iterdir()):
        if ".mysnps" in f.name or f.name.endswith("mysnps"):
            shutil.move(str(f), snpdir / f.name)
            moved = True
    spldir = tmp_path / "spl"
    spldir.mkdir()
    from gmap_gsnap.db.iit_text import iit_from_text
    from gmap_gsnap.db import build as _b
    from gmap_gsnap.ops import maxent
    import numpy as np

    g = _b.load_genome_fasta([FIXTURE])
    pos = np.arange(100, len(seq) - 100)
    dp = maxent.splice_prob_np(g.codes, pos, "donor")
    ap = maxent.splice_prob_np(g.codes, pos, "acceptor")
    d = int(pos[dp > 0.97][0])
    a = int(pos[ap > 0.97][np.searchsorted(pos[ap > 0.97], d + 200)])
    iit_from_text(
        f">x.d chr17test:{d}..{d + 1} donor\n"
        f">x.a chr17test:{a}..{a + 1} acceptor\n"
    ).write(str(spldir / "sx.iit"))
    read = seq[d - 50 : d] + seq[a : a + 50]
    fq = tmp_path / "v.fq"
    with open(fq, "w") as f:
        f.write(f"@v0\n{read}\n+\n{'I' * len(read)}\n")
    gdb = str(tmp_path / "gdb")
    args = ["-D", gdb, "-d", "chr17test", "-s", "sx",
            "--splicingdir", str(spldir)]
    ref = subprocess.run(
        [ORACLE_GSNAP, "--format=sam"] + args + [str(fq)],
        capture_output=True, text=True, check=True).stdout
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    mine = subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.gsnap"] + args
        + [str(fq)], capture_output=True, text=True, env=env,
        check=True).stdout
    assert ([l for l in ref.splitlines() if not l.startswith("@")]
            == [l for l in mine.splitlines() if not l.startswith("@")])
