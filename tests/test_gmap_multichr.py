"""Multi-chromosome GMAP output: chromosome-relative vs universal
coordinate conventions across every format ('Path N:'/'Accessions:'
chr-relative, 'Genomic pos:' dbname+universal, gff3/map/compressed
chr-relative; Stage3_print_pathsummary, Pair_print_gff3,
Pair_print_compressed), plus the partial-codon translation rules
exercised by queries whose ORFs truncate at the read end."""

import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
ORACLE = "/tmp/refbuild/src/gmap"
FIXTURE = "/root/reference/tests/ss.chr17test"

needs_oracle = pytest.mark.skipif(
    not os.path.exists(ORACLE), reason="reference oracle not built")


@pytest.fixture(scope="module")
def twochr(tmp_path_factory):
    from gmap_gsnap.db import build

    tmp = tmp_path_factory.mktemp("twochr")
    seq = "".join(l.strip() for l in open(FIXTURE)
                  if not l.startswith(">")).upper()
    fa = tmp / "two.fa"
    with open(fa, "w") as f:
        f.write(">chrA\n")
        for i in range(0, 50000, 60):
            f.write(seq[i : i + 60] + "\n")
        f.write(">chrB\n")
        for i in range(50000, 120000, 60):
            f.write(seq[i : i + 60] + "\n")
    dbdir = build.build_db([str(fa)], "twochr", str(tmp), k=12)
    q = tmp / "q.fa"
    q.write_text(f">qB\n{seq[80000:80300]}\n>qA\n{seq[10000:10300]}\n")
    return dbdir, str(q)


@needs_oracle
@pytest.mark.parametrize("fmt", [
    ["-S"], ["-A"], ["-f", "samse"], ["-f", "psl"], ["-f", "gff3_gene"],
    ["-f", "gff3_match_cdna"], ["-f", "gff3_match_est"],
    ["-f", "splicesites"], ["-f", "introns"], ["-f", "map_genes"],
    ["-f", "map_exons"], ["-f", "coords"], ["-Z"], ["-3"], ["-4"],
    ["-E", "cdna"], ["-E", "genomic"], ["-P"], ["-Q"],
])
def test_multichr_format_parity(twochr, fmt):
    dbdir, qfa = twochr
    ref = subprocess.run(
        [ORACLE, "-D", dbdir, "-d", "twochr", *fmt, qfa],
        capture_output=True, text=True, check=True).stdout
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    mine = subprocess.run(
        [sys.executable, "-m", "gmap_gsnap.cli.gmap", "-D", dbdir,
         "-d", "twochr", *fmt, qfa],
        capture_output=True, text=True, env=env, check=True).stdout
    assert mine.splitlines() == ref.splitlines(), fmt


@needs_oracle
def test_chrsubset(twochr, tmp_path):
    """-c restricts the search to one chromosome: a qB query forced to
    chrA must report 0 paths; a chrA query keeps its path.  Byte parity
    with the reference."""
    import subprocess

    dbdir, q = twochr
    gdb = str(pathlib.Path(dbdir).parent)
    for sub in ("chrA", "chrB"):
        args = ["-D", gdb, "-d", "twochr", "-S", "-c", sub]
        ref = subprocess.run(
            [ORACLE] + args + [q], capture_output=True, text=True,
            check=True).stdout
        env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
        mine = subprocess.run(
            [sys.executable, "-m", "gmap_gsnap.cli.gmap"] + args + [q],
            capture_output=True, text=True, env=env, check=True).stdout
        assert ref.splitlines() == mine.splitlines(), sub
