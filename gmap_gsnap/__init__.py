"""gmap_gsnap: a batched JAX genomic alignment framework.

A from-scratch reimplementation of the capabilities of GMAP/GSNAP
(cDNA-to-genome spliced alignment and short-read alignment) for an
accelerator (an NVIDIA H100): batch-oriented JAX/XLA compute over a 2-bit
packed genome held in device memory, with host-side NumPy tooling for
database construction and I/O.

Layer map (mirrors the reference's six layers, re-designed for batches):
  db/        genome 2-bit store, k-mer index, IIT interval trees   (L1)
  ops/       device compute kernels: mismatch popcount, maxent,
             banded DP, oligoindex chaining                        (L2)
  align/     GSNAP / GMAP alignment pipelines                      (L3)
  io/        FASTA/FASTQ input, SAM and GMAP-format output         (L4/L5)
  parallel/  jax.sharding meshes, collectives, multi-host sharding (runtime)
  cli/       gsnap/gmap/gmapindex/iit_* command-line entry points  (L5)
  utils/     DNA coding helpers, config
"""

__version__ = "0.1.0"
