"""kcftools-tpu: a k-mer variation screening framework for JAX accelerators.

A from-scratch rebuild of the capabilities of kcftools
(https://github.com/sivasubramanics/kcftools) designed
accelerator-first: the hot path (canonical k-mer extraction, hash-table
membership lookups, per-window gap-run scoring) runs
as a jitted JAX/XLA pipeline with optional multi-chip sharding via
``jax.sharding``; the host tier (KMC3 database ingest, FASTA/GTF/KCF I/O)
is vectorized NumPy.

Layout:
  io/        host I/O: FASTA(+faidx), KMC3 DB read/write, GTF, KCF
  engine/    device compute: 2-bit encode, hash table, window scoring
  ops/       low-level device ops (plain JAX/XLA)
  parallel/  device-mesh sharding of the k-mer table and window batches
  plugins/   the user-facing subcommands (getVariations, cohort, findIBS...)
  utils/     logging + Java-compatible text formatting
"""

# JAX configuration (x64, persistent compile cache) lives in
# kcftools_tpu.jaxinit and is imported by the device-tier modules on
# first use - the host tier (io/, native/, stream plugins, the hybrid
# engine) never pays the JAX startup cost.

__version__ = "0.8.0"

KCF_SOURCE = "kcftools"
