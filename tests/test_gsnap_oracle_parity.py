"""End-to-end SAM parity vs the completed reference gsnap binary.

Requires the reference oracle build at /tmp/refbuild (built once by
tests/oracle/build_oracle.sh); skipped when unavailable.  The known
divergences are reads whose reference output goes through gsnap's GMAP
improvement/terminal passes (gmap_mode default), which need the GMAP
stack — tracked via MAX_DIVERGENT below and tightened as the GMAP
stack lands.
"""

import os
import pathlib
import subprocess
import sys

import pytest

ORACLE_GSNAP = "/tmp/refbuild/src/gsnap"
ORACLE_DB = "/tmp/refbuild/trytest/gdb"
REPO = pathlib.Path(__file__).resolve().parent.parent


needs_oracle = pytest.mark.skipif(
    not (os.path.exists(ORACLE_GSNAP) and os.path.isdir(ORACLE_DB)),
    reason="reference oracle binaries not built",
)


def _make_reads(path, n=60, seed=77):
    import random

    random.seed(seed)
    seq = "".join(
        l.strip()
        for l in open("/root/reference/tests/ss.chr17test")
        if not l.startswith(">")
    ).upper()
    comp = str.maketrans("ACGT", "TGCA")
    with open(path, "w") as f:
        for i in range(n):
            L = random.choice([50, 75, 100])
            p = random.randrange(0, len(seq) - L)
            r = list(seq[p : p + L])
            for _ in range(random.randrange(0, 4)):
                r[random.randrange(L)] = random.choice("ACGT")
            r = "".join(r)
            if random.random() < 0.5:
                r = r.translate(comp)[::-1]
            f.write(f"@t{i}\n{r}\n+\n{'I' * L}\n")


@needs_oracle
def test_se_sam_parity(tmp_path):
    fq = tmp_path / "t.fq"
    _make_reads(str(fq))
    ref = subprocess.run(
        [ORACLE_GSNAP, "-D", ORACLE_DB, "-d", "chr17test", "--format=sam", str(fq)],
        capture_output=True,
        text=True,
        check=True,
    ).stdout
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    mine = subprocess.run(
        [
            sys.executable,
            "-m",
            "gmap_gsnap.cli.gsnap",
            "-D",
            ORACLE_DB,
            "-d",
            "chr17test",
            str(fq),
        ],
        capture_output=True,
        text=True,
        env=env,
        check=True,
    ).stdout

    ref_lines = ref.splitlines()
    my_lines = mine.splitlines()
    assert len(ref_lines) == len(my_lines)
    diff = [(a, b) for a, b in zip(my_lines, ref_lines) if a != b]
    assert not diff, diff[:3]
