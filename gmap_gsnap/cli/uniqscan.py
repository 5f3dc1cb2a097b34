"""uniqscan: minimal unique alignment length scanner (src/uniqscan.c).

Prints "sublength: npaths" per prefix length, starting at index1part+2
and stopping once a unique alignment is found (uniqueness_scan,
uniqscan.c:378-452).  Batched re-design: instead of re-running the engine
per prefix, ALL prefix lengths align in one batched device call (rows =
prefixes), and the scan walks the npaths vector.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    import numpy as np

    p = argparse.ArgumentParser(prog="uniqscan")
    p.add_argument("-D", "--dir", required=True)
    p.add_argument("-d", "--db", required=True)
    p.add_argument("-3", "--from-right", action="store_true", dest="from_right",
                   help="scan suffixes instead of prefixes")
    p.add_argument("sequence")
    args = p.parse_args(argv)

    from ..align import runner as runner_mod
    from ..db.datadir import GenomeDB
    from ..utils import jaxenv

    jaxenv.enable_compilation_cache()
    db = GenomeDB.open(
        args.dir if args.dir.endswith(args.db) else f"{args.dir}/{args.db}",
        args.db,
    )
    seq = args.sequence.upper()
    full = len(seq)
    minlen = db.k + 2
    if full < minlen:
        return 0

    lengths = np.arange(minlen, full + 1, dtype=np.int32)
    records = []
    for sublen in lengths:
        sub = seq[full - sublen :] if args.from_right else seq[:sublen]
        records.append(
            runner_mod.Record(f"prefix{sublen}", f"prefix{sublen}", sub))

    # all prefixes align in ONE device batch, then each row runs the
    # full rescue ladder (end indels / terminals / distant / GMAP) so
    # npaths matches the complete single-read engine the reference's
    # uniqueness_scan invokes (uniqscan.c:378-452)
    runner = runner_mod.GsnapRunner(db, lmax=full)
    hits = runner.align_records(records)
    for i, sublen in enumerate(lengths):
        final = runner._rescued_hits(
            records[i], hits, i, int(hits["npaths"][i]), maxpaths=100)
        npaths = len(final)
        print(f"{sublen}: {npaths}")
        if npaths <= 1:
            break
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
