"""gsnap -g/--genes known-genes multimapping resolution
(gsnap.c:2099-2121, stage3hr.c:4955-4994 Stage3end_resolve_multimapping,
iit-read.c:5304 IIT_gene_overlap) — byte parity vs the reference binary
on a genome with a duplicated block, with and without --favor-multiexon."""

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


def _dup_db(tmp_path):
    """Two-chromosome DB where chrB[10000:13000] duplicates
    chrA[10000:13000]: reads from the block map twice, equal score."""
    seq = "".join(
        l.strip() for l in open(FIXTURE) if not l.startswith(">")
    ).upper()
    chr_a = seq[:30000]
    chr_b = seq[30000:40000] + seq[10000:13000] + seq[43000:60000]
    fa = tmp_path / "dup.fa"
    with open(fa, "w") as f:
        for name, s in (("chrA", chr_a), ("chrB", chr_b)):
            f.write(f">{name}\n")
            for i in range(0, len(s), 60):
                f.write(s[i : i + 60] + "\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.gmap_build", "-D",
         str(tmp_path / "db"), "-d", "dup", str(fa)],
        capture_output=True, text=True, env=env, check=True)
    return chr_a, env


def _genes_iit(tmp_path, env, gtf: str, name="genes"):
    out = subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.gtf_genes"],
        input=gtf, capture_output=True, text=True, env=env, check=True,
    ).stdout
    iit = tmp_path / f"{name}.iit"
    subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.iit_store", "-o",
         str(iit)],
        input=out, capture_output=True, text=True, env=env, check=True)
    return iit


def _run_both(tmp_path, env, extra, fastqs):
    ref = subprocess.run(
        [ORACLE_GSNAP, "-D", str(tmp_path / "db"), "-d", "dup",
         "--format=sam"] + extra + [str(f) for f in fastqs],
        capture_output=True, text=True, check=True,
    ).stdout
    mine = subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.gsnap", "-D",
         str(tmp_path / "db"), "-d", "dup", "-A", "sam"]
        + extra + [str(f) for f in fastqs],
        capture_output=True, text=True, env=env, check=True,
    ).stdout
    ref_l = [l for l in ref.splitlines() if not l.startswith("@")]
    my_l = [l for l in mine.splitlines() if not l.startswith("@")]
    return ref_l, my_l


@needs_oracle
def test_genes_resolution_se(tmp_path):
    """A read from the duplicated block multimaps (NH:2) without -g and
    resolves to the gene-bearing copy (NH:1) with -g — byte parity."""
    chr_a, env = _dup_db(tmp_path)
    # single-exon gene over the chrA copy only
    gtf = ('chrA\ttest\texon\t10500\t12500\t.\t+\t.\t'
           'gene_id "G1"; transcript_id "G1.1";\n')
    iit = _genes_iit(tmp_path, env, gtf)
    read = chr_a[11000:11100]
    fq = tmp_path / "r.fq"
    with open(fq, "w") as f:
        f.write(f"@m0\n{read}\n+\n{'I' * len(read)}\n")
    ref_l, my_l = _run_both(tmp_path, env, [], [fq])
    assert ref_l == my_l
    assert sum("m0" in l for l in my_l) == 2  # multimaps without -g
    ref_l, my_l = _run_both(tmp_path, env, ["-g", str(iit)], [fq])
    assert ref_l == my_l
    assert sum("m0" in l for l in my_l) == 1  # resolved with -g
    assert any("chrA" in l.split("\t")[2] for l in my_l)


@needs_oracle
def test_genes_favor_multiexon_se(tmp_path):
    """--favor-multiexon: single-exon gene on chrA vs multi-exon gene
    on chrB; default -g keeps both (same class), --favor-multiexon
    resolves to the chrB copy — byte parity in both configs."""
    chr_a, env = _dup_db(tmp_path)
    gtf = (
        'chrA\ttest\texon\t10500\t12500\t.\t+\t.\t'
        'gene_id "G1"; transcript_id "G1.1";\n'
        # chrB block sits at offset 10000 in chrB; read lands ~11000
        'chrB\ttest\texon\t10600\t11050\t.\t+\t.\t'
        'gene_id "G2"; transcript_id "G2.1";\n'
        'chrB\ttest\texon\t11500\t12000\t.\t+\t.\t'
        'gene_id "G2"; transcript_id "G2.1";\n'
    )
    iit = _genes_iit(tmp_path, env, gtf)
    read = chr_a[10950:11050]  # overlaps G2 exon 1 on the chrB copy
    fq = tmp_path / "r.fq"
    with open(fq, "w") as f:
        f.write(f"@m1\n{read}\n+\n{'I' * len(read)}\n")
    for extra, want in ([["-g", str(iit)], 2],
                        [["-g", str(iit), "--favor-multiexon"], 1]):
        ref_l, my_l = _run_both(tmp_path, env, extra, [fq])
        assert ref_l == my_l, extra
        assert sum("m1" in l for l in my_l) == want, extra
    assert any("chrB" in l.split("\t")[2] for l in my_l)


@needs_oracle
def test_tally_resolution_se(tmp_path):
    """--use-tally: per-position read-depth tallies over the chrA copy
    resolve the multimapper to chrA (Stage3end_resolve_multimapping
    step 2, stage3hr.c:5000-5028; Substring_tally substring.c:3784)."""
    chr_a, env = _dup_db(tmp_path)
    # tally IIT: one line per position, three intervals with mixed
    # per-line token forms that get_total_tally must sum
    body = "\n".join(["2"] * 150)
    text = f">t1 chrA:11001..11150\n{body}\n"
    iit = tmp_path / "tally.iit"
    subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.iit_store", "-o",
         str(iit)],
        input=text, capture_output=True, text=True, env=env, check=True)
    read = chr_a[11000:11100]
    fq = tmp_path / "r.fq"
    with open(fq, "w") as f:
        f.write(f"@m2\n{read}\n+\n{'I' * len(read)}\n")
    for extra, want in ([[], 2], [["--use-tally", str(iit)], 1]):
        ref_l, my_l = _run_both(tmp_path, env, extra, [fq])
        assert ref_l == my_l, extra
        assert sum("m2" in l for l in my_l) == want, extra
    assert any("chrA" in l.split("\t")[2] for l in my_l)


@needs_oracle
def test_runlength_resolution_se(tmp_path):
    """--use-runlength: any interval overlap marks the hit; only marked
    hits survive (stage3hr.c:5035-5058; Substring_runlength_p)."""
    chr_a, env = _dup_db(tmp_path)
    text = ">r1 chrA:10900..11200\n10\n"
    iit = tmp_path / "runlength.iit"
    subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.iit_store", "-o",
         str(iit)],
        input=text, capture_output=True, text=True, env=env, check=True)
    read = chr_a[11000:11100]
    fq = tmp_path / "r.fq"
    with open(fq, "w") as f:
        f.write(f"@m3\n{read}\n+\n{'I' * len(read)}\n")
    ref_l, my_l = _run_both(
        tmp_path, env, ["--use-runlength", str(iit)], [fq])
    assert ref_l == my_l
    assert sum("m3" in l for l in my_l) == 1
    assert any("chrA" in l.split("\t")[2] for l in my_l)


@needs_oracle
def test_genes_resolution_pe(tmp_path):
    """Paired-end: both concordant pairs fall in the duplicated block;
    -g keeps only the gene-bearing pair (Stage3pair_resolve_multimapping,
    stage1hr.c:15459) — byte parity."""
    chr_a, env = _dup_db(tmp_path)
    gtf = ('chrA\ttest\texon\t10200\t12800\t.\t+\t.\t'
           'gene_id "G1"; transcript_id "G1.1";\n')
    iit = _genes_iit(tmp_path, env, gtf)

    def _rc(s):
        return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]

    r5 = chr_a[10400:10500]
    r3 = _rc(chr_a[10700:10800])
    fq1, fq2 = tmp_path / "p1.fq", tmp_path / "p2.fq"
    with open(fq1, "w") as f:
        f.write(f"@p0\n{r5}\n+\n{'I' * len(r5)}\n")
    with open(fq2, "w") as f:
        f.write(f"@p0\n{r3}\n+\n{'I' * len(r3)}\n")
    for extra, want in ([[], 4], [["-g", str(iit)], 2]):
        ref_l, my_l = _run_both(tmp_path, env, extra, [fq1, fq2])
        assert ref_l == my_l, extra
        assert sum("p0" in l for l in my_l) == want, extra
