"""atoiindex: build RNA-editing (A->G / T->C) indexes for a database.

Usage: python -m gmap_gsnap.cli.atoiindex -D <dir> -d <db> [-k 12]
Writes <db>.a2iag*/<db>.a2itc* index files (atoiindex.c naming).
"""

from __future__ import annotations

import sys

from .cmetindex import main as _main


def main(argv=None) -> int:
    return _main(argv, kind="atoi")


if __name__ == "__main__":
    sys.exit(main())
