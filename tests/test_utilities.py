"""Utility-CLI parity vs the reference Perl tools and binaries."""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
UTIL = "/tmp/refbuild/util"
ORACLE_DB = "/tmp/refbuild/trytest/gdb"
FIXTURE = "/root/reference/tests/ss.chr17test"

needs_oracle = pytest.mark.skipif(
    not os.path.isdir(UTIL), reason="reference oracle build unavailable"
)

GTF = (
    'chr1\tt\texon\t100\t200\t.\t+\t.\tgene_id "g1"; transcript_id "t1";\n'
    'chr1\tt\texon\t300\t400\t.\t+\t.\tgene_id "g1"; transcript_id "t1";\n'
    'chr1\tt\texon\t500\t600\t.\t+\t.\tgene_id "g1"; transcript_id "t1";\n'
    'chr1\tt\texon\t500\t600\t.\t-\t.\tgene_id "g2"; transcript_id "t2";\n'
    'chr1\tt\texon\t300\t400\t.\t-\t.\tgene_id "g2"; transcript_id "t2";\n'
    'chr1\tt\texon\t100\t200\t.\t-\t.\tgene_id "g2"; transcript_id "t2";\n'
)
GFF3 = (
    "##gff-version 3\n"
    "chr1\tx\tgene\t100\t600\t.\t+\t.\tID=g1;Name=G1\n"
    "chr1\tx\tmRNA\t100\t600\t.\t+\t.\tID=t1;Parent=g1\n"
    "chr1\tx\texon\t100\t200\t.\t+\t.\tParent=t1\n"
    "chr1\tx\texon\t300\t400\t.\t+\t.\tParent=t1\n"
    "chr1\tx\texon\t500\t600\t.\t+\t.\tParent=t1\n"
    "chr1\tx\tgene\t100\t600\t.\t-\t.\tID=g2;Name=G2\n"
    "chr1\tx\tmRNA\t100\t600\t.\t-\t.\tID=t2;Parent=g2\n"
    "chr1\tx\texon\t500\t600\t.\t-\t.\tParent=t2\n"
    "chr1\tx\texon\t300\t400\t.\t-\t.\tParent=t2\n"
    "chr1\tx\texon\t100\t200\t.\t-\t.\tParent=t2\n"
)
TRACK = (
    "q1\tchr1\t+\t99\t599\t99\t599\t3\t99,299,499,\t200,400,600,\n"
    "q2\tchr1\t-\t99\t599\t99\t599\t3\t99,299,499,\t200,400,600,\n"
)


def _ours(mod: str, stdin: str, *args) -> str:
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-m", f"gmap_gsnap.cli.{mod}", *args],
        input=stdin, capture_output=True, text=True, env=env, check=True,
    ).stdout


def _perl(tool: str, stdin: str) -> str:
    return subprocess.run(
        [f"{UTIL}/{tool}"], input=stdin, capture_output=True, text=True,
        check=True,
    ).stdout


@needs_oracle
@pytest.mark.parametrize("tool,stdin", [
    ("gtf_splicesites", GTF), ("gtf_introns", GTF),
    ("gff3_splicesites", GFF3), ("gff3_introns", GFF3),
    ("psl_splicesites", TRACK), ("psl_introns", TRACK),
    ("gtf_genes", GTF), ("gff3_genes", GFF3), ("psl_genes", TRACK),
])
def test_extractor_parity(tool, stdin):
    assert _ours(tool, stdin) == _perl(tool, stdin)


def test_dbsnp_iit():
    row = ["585", "chr1", "99", "100", "rs1", "0", "+", "A", "A", "A/G",
           "g", "single", "by-cluster", "0", "0", "unknown", "exact", "1"]
    rowm = list(row)
    rowm[4], rowm[6], rowm[9] = "rs2", "-", "C/T"
    stdin = "\t".join(row) + "\n" + "\t".join(rowm) + "\n"
    out = _ours("dbsnp_iit", stdin)
    assert out == ">rs1 chr1:100 AG +\n>rs2 chr1:100 AG -\n"


@needs_oracle
def test_fa_coords_golden(tmp_path):
    out = tmp_path / "coords.txt"
    _ours("fa_coords", "", "-o", str(out), FIXTURE)
    golden = open("/root/reference/tests/coords1.test.ok").read()
    assert open(out).read() == golden


@needs_oracle
def test_gmap_process_parity(tmp_path):
    coords = tmp_path / "coords.txt"
    _ours("fa_coords", "", "-o", str(coords), FIXTURE)
    ours = _ours("gmap_process", "", "-c", str(coords), FIXTURE)
    ref = subprocess.run(
        [f"{UTIL}/gmap_process", "-c", str(coords), FIXTURE],
        capture_output=True, text=True, check=True,
    ).stdout
    assert ours == ref


@needs_oracle
def test_gmap_build_artifacts(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.gmap_build", "-d",
         "chr17test", "-D", str(tmp_path), "-k", "12", FIXTURE],
        capture_output=True, text=True, env=env, check=True,
    )
    d = tmp_path / "chr17test"
    assert (d / "chr17test.genomecomp").read_bytes() == open(
        "/root/reference/tests/setup.genomecomp.ok", "rb").read()
    assert (d / "chr17test.ref123positions").read_bytes() == open(
        "/root/reference/tests/setup.ref123positions.ok", "rb").read()


@needs_oracle
def test_uniqscan_parity():
    seq = "".join(
        l.strip() for l in open(FIXTURE) if not l.startswith(">")
    ).upper()
    for s in (seq[50000:50060], seq[141000:141080]):
        ref = subprocess.run(
            ["/tmp/refbuild/src/uniqscan", "-D", ORACLE_DB, "-d", "chr17test", s],
            capture_output=True, text=True, check=True,
        ).stdout
        ours = _ours("uniqscan", "", "-D", ORACLE_DB, "-d", "chr17test", s)
        assert ours == ref


@needs_oracle
def test_get_genome_snp_modes(tmp_path):
    """get-genome -v/-f SNP modes and the revcomp header quirk: byte
    parity against the reference binary on a window containing a SNP
    (built by our snpindex into a copy of the oracle DB) and a clean
    window, forward and revcomp."""
    import shutil

    oracle = "/tmp/refbuild/src/get-genome"
    if not os.path.exists(oracle):
        pytest.skip("reference get-genome not built")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    gdb = tmp_path / "gdb"
    dbdir = gdb / "chr17test"
    shutil.copytree(f"{ORACLE_DB}/chr17test", dbdir)
    (dbdir / "chr17test.maps").mkdir(exist_ok=True)
    seq = "".join(
        l.strip() for l in open(FIXTURE) if not l.startswith(">")
    ).upper()
    flip = {"A": "G", "G": "A", "C": "T", "T": "C"}
    pos = 15050  # 1-based SNP inside the first query window
    from gmap_gsnap.db.iit_text import iit_from_text

    iit_from_text(
        f">rs0 chr17test:{pos} {seq[pos - 1]}{flip[seq[pos - 1]]}\n"
    ).write(str(dbdir / "chr17test.maps" / "snps.iit"))
    subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.snpindex",
         "-D", str(gdb), "-d", "chr17test", "-v", "snps",
         str(dbdir / "chr17test.maps" / "snps.iit")],
        capture_output=True, text=True, env=env, check=True,
    )
    for q in ("chr17test:15030..15100", "chr17test:15100..15030",
              "chr17test:1000..1080"):
        for opts in ([], ["-v", "snps"], ["-v", "snps", "-f", "1"],
                     ["-v", "snps", "-f", "2"]):
            ref = subprocess.run(
                [oracle, "-D", str(gdb), "-d", "chr17test", *opts, q],
                capture_output=True, text=True, check=True,
            ).stdout
            mine = subprocess.run(
                [sys.executable, "-m", "gmap_gsnap.cli.get_genome",
                 "-D", str(gdb), "-d", "chr17test", *opts, q],
                capture_output=True, text=True, env=env, check=True,
            ).stdout
            assert ref == mine, (opts, q)


def test_stats_module():
    """pbinom (gsl_cdf_binomial_P lower tail) against direct summation;
    orderstat_pct (quickselect ceil(pct*n)) against sorting."""
    import math

    import numpy as np

    from gmap_gsnap.utils import stats

    rng = np.random.default_rng(3)
    for n, p in ((10, 0.3), (40, 0.05), (100, 0.7)):
        for k in (0, 1, n // 2, n - 1, n):
            direct = sum(
                math.comb(n, j) * p**j * (1 - p) ** (n - j)
                for j in range(0, k + 1))
            assert abs(stats.pbinom(k, n, p) - direct) < 1e-10, (k, n, p)
    for _ in range(5):
        a = rng.integers(0, 1000, 37)
        for pct in (0.5, 0.9, 0.98):
            cutoff = min(int(pct * len(a) + 1), len(a))
            assert stats.orderstat_pct(a, pct) == sorted(a)[cutoff - 1]


def test_maxent_string_form():
    """String-form maxent API matches the code-array path at a real
    chr17test donor/acceptor site."""
    import numpy as np

    from gmap_gsnap.ops import maxent

    seq = (
        "".join(l.strip() for l in open(FIXTURE) if not l.startswith(">"))
        .upper())
    codes = np.frombuffer(seq.encode(), np.uint8)
    lut = np.zeros(256, np.uint8)
    for i, c in enumerate(b"ACGT"):
        lut[c] = i
    codes = lut[codes]
    pos = np.arange(1000, 5000)
    pd = maxent.splice_prob_np(codes, pos, "donor")
    d = int(pos[np.argmax(pd)])
    win = seq[d - maxent.DONOR_LEFT_MARGIN:
              d - maxent.DONOR_LEFT_MARGIN + maxent.DONOR_WIDTH]
    assert abs(maxent.donor_prob(win) - pd.max()) < 1e-12
    pa = maxent.splice_prob_np(codes, pos, "acceptor")
    a = int(pos[np.argmax(pa)])
    win = seq[a - maxent.ACCEPTOR_LEFT_MARGIN:
              a - maxent.ACCEPTOR_LEFT_MARGIN + maxent.ACCEPTOR_WIDTH]
    assert abs(maxent.acceptor_prob(win) - pa.max()) < 1e-12


@needs_oracle
def test_paired_fasta_input(tmp_path):
    """GSNAP's extended paired FASTA (two sequence lines per record) is
    detected from a single input file and aligned as pairs."""
    seq = "".join(
        l.strip() for l in open(FIXTURE) if not l.startswith(">")).upper()
    comp = str.maketrans("ACGT", "TGCA")
    fa = tmp_path / "pe.fa"
    with open(fa, "w") as f:
        for i, p in enumerate((40000, 42000)):
            f.write(f">p{i}\n{seq[p : p + 100]}\n"
                    f"{seq[p + 250 : p + 350].translate(comp)[::-1]}\n")
    ref = subprocess.run(
        ["/tmp/refbuild/src/gsnap", "-D", ORACLE_DB, "-d", "chr17test",
         "--format=sam", str(fa)],
        capture_output=True, text=True, check=True).stdout
    mine = _ours("gsnap", "", "-D", ORACLE_DB, "-d", "chr17test",
                 "--format=sam", str(fa))
    body = lambda s: [l for l in s.splitlines() if not l.startswith("@")]
    assert body(mine) == body(ref)
