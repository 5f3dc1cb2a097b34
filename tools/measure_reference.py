"""Measure the reference binaries' single-thread queries/sec on the
five BASELINE.md bench configs (same generators/seeds as bench.py).

Usage: python tools/measure_reference.py [config...]
Builds DB artifacts (splicesites IIT, snpindex, cmetindex) with OUR
tools inside a copy of the oracle DB, then times
/tmp/refbuild/src/gsnap -t 1 on the generated FASTQs, parsing the
self-reported "(N.NN queries/sec)" line (src/gsnap.c:2493-2494).
"""
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, "/root/repo")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import bench_workloads as bw

GSNAP = "/tmp/refbuild/src/gsnap"
ORACLE_DB = "/tmp/refbuild/trytest/gdb"
REPO = pathlib.Path(__file__).resolve().parent.parent


def qps_of(cmd) -> float:
    r = subprocess.run(cmd, capture_output=True, text=True, check=True)
    m = re.search(r"\(([\d.]+) queries/sec\)", r.stderr)
    assert m, r.stderr[-2000:]
    return float(m.group(1))


def qps_drop_crashers(cmd_prefix, fq_paths, labels_by_file):
    """Run the reference; when it aborts on one of its own crash bugs
    ("Problem sequence: <label>"), drop that record from the FASTQ(s)
    and retry.  Returns (qps, dropped_labels) — the dropped list gets
    hardcoded into bench.py so both sides measure the identical set."""
    dropped = []
    while True:
        r = subprocess.run([*cmd_prefix, *map(str, fq_paths)],
                           capture_output=True, text=True)
        if r.returncode == 0:
            m = re.search(r"\(([\d.]+) queries/sec\)", r.stderr)
            assert m, r.stderr[-2000:]
            return float(m.group(1)), dropped
        m = re.search(r"Problem sequence: (\S+)", r.stderr)
        assert m, (r.returncode, r.stderr[-2000:])
        lab = m.group(1)
        dropped.append(lab)
        print(f"# reference crashed on {lab}; dropping", flush=True)
        for fq in fq_paths:
            lines = open(fq).read().splitlines()
            out = []
            i = 0
            while i < len(lines):
                if lines[i].split()[0] != f"@{lab}":
                    out.extend(lines[i : i + 4])
                i += 4
            open(fq, "w").write("\n".join(out) + "\n")


def _run_subset(cmd_prefix, tmp, tag, reads_list, idx):
    """Write FASTQ(s) for the index subset and run the reference.
    reads_list = [reads] (SE) or [r5, r3] (PE).  Returns (rc, stderr)."""
    paths = []
    for fi, reads in enumerate(reads_list):
        p = tmp / f"{tag}_{fi}.fq"
        bw.write_fastq(p, [reads[i] for i in idx],
                       prefix="q")  # labels q0..qN-1 within subset
        paths.append(p)
    r = subprocess.run([*cmd_prefix, *map(str, paths)],
                       capture_output=True, text=True)
    return r


def qps_bisect(cmd_prefix, tmp, tag, reads_list):
    """Measure qps, dropping reads the reference crashes on.  Crashes
    that name the read drop directly; anonymous SIGSEGVs are located by
    recursive bisection.  Returns (qps, dropped original indices)."""
    active = list(range(len(reads_list[0])))
    dropped = []

    def crashes(idx):
        return _run_subset(cmd_prefix, tmp, tag, reads_list,
                           idx).returncode != 0

    while True:
        r = _run_subset(cmd_prefix, tmp, tag, reads_list, active)
        if r.returncode == 0:
            m = re.search(r"\(([\d.]+) queries/sec\)", r.stderr)
            assert m, r.stderr[-2000:]
            return float(m.group(1)), dropped
        m = re.search(r"Problem sequence: q(\d+)", r.stderr)
        if m:
            bad = active[int(m.group(1))]
        else:
            # anonymous crash: bisect to one read
            lo = active
            while len(lo) > 1:
                half = lo[: len(lo) // 2]
                lo = half if crashes(half) else lo[len(lo) // 2 :]
            bad = lo[0]
        dropped.append(bad)
        active.remove(bad)
        print(f"# reference crashed on index {bad}; dropping", flush=True)


def main():
    which = set(sys.argv[1:]) or {"2", "3", "4", "5"}
    tmp = pathlib.Path(tempfile.mkdtemp())
    gdb = tmp / "gdb"
    dbdir = gdb / "chr17test"
    shutil.copytree(f"{ORACLE_DB}/chr17test", dbdir,
                    ignore=shutil.ignore_patterns("*.maps"))
    (dbdir / "chr17test.maps").mkdir(exist_ok=True)
    seq = "".join(l.strip() for l in
                  open("/root/reference/tests/ss.chr17test")
                  if not l.startswith(">")).upper()
    env = dict(os.environ, PYTHONPATH=str(REPO))

    if "2" in which:
        rng = np.random.default_rng(42)
        reads = bw.make_se_workload(seq, 8192, rng)
        bw.write_fastq(tmp / "se.fq", reads)
        q, drop = qps_drop_crashers(
            [GSNAP, "-t", "1", "-D", str(gdb), "-d", "chr17test",
             "--format=sam"], [tmp / "se.fq"], None)
        print(f"config2_se_qps = {q}  dropped={drop}")

    if "3" in which:
        rng = np.random.default_rng(7)
        jx = bw.find_junctions(seq)
        print(f"# {len(jx)} junctions")
        r5, r3 = bw.make_pe_splice_workload(seq, 4096, rng, jx)
        q, drop = qps_bisect(
            [GSNAP, "-t", "1", "-N", "1", "-D", str(gdb),
             "-d", "chr17test", "--format=sam"], tmp, "sp", [r5, r3])
        print(f"config3_pe_splice_qps = {q}  dropped={drop}")

    if "4" in which or "5" in which:
        rng = np.random.default_rng(11)
        ss_txt, snp_txt, juncs, snps = bw.known_snp_setup(seq, rng)
        from gmap_gsnap.db.iit_text import iit_from_text
        iit_from_text(ss_txt).write(str(dbdir / "chr17test.maps" / "ss.iit"))
        iit_from_text(snp_txt).write(
            str(dbdir / "chr17test.maps" / "snps.iit"))

    if "4" in which:
        subprocess.run(
            [sys.executable, "-m", "gmap_gsnap.cli.snpindex",
             "-D", str(gdb), "-d", "chr17test", "-v", "snps",
             str(dbdir / "chr17test.maps" / "snps.iit")],
            capture_output=True, text=True, env=env, check=True)
        rng = np.random.default_rng(11)
        reads = bw.make_known_snp_workload(seq, 4096, rng, juncs, snps)
        q, drop = qps_bisect(
            [GSNAP, "-t", "1", "-D", str(gdb), "-d", "chr17test",
             "-v", "snps", "-s", "ss", "--format=sam"], tmp, "ks", [reads])
        print(f"config4_known_snp_qps = {q}  dropped={drop}")

    if "5" in which:
        subprocess.run(
            [sys.executable, "-m", "gmap_gsnap.cli.cmetindex",
             "-D", str(gdb), "-d", "chr17test"],
            capture_output=True, text=True, env=env, check=True)
        rng = np.random.default_rng(5)
        reads = bw.make_cmet_workload(seq, 4096, rng)
        q, drop = qps_bisect(
            [GSNAP, "-t", "1", "-D", str(gdb), "-d", "chr17test",
             "--mode=cmet-stranded", "--format=sam"], tmp, "cm", [reads])
        print(f"config5_cmet_qps = {q}  dropped={drop}")

    print(f"# workdir {tmp}")


if __name__ == "__main__":
    main()
