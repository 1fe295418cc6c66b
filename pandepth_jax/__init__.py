"""pandepth_jax — a JAX genomic coverage framework.

A from-scratch re-design of the capabilities of PanDepth
(https://github.com/HuiyangYu/PanDepth, reference layout surveyed in
SURVEY.md) for an accelerator (an NVIDIA GPU) driven from JAX:

* hosts decode alignment files (SAM/BAM/CRAM/PAF) into coverage events
  (``pandepth_jax.io`` + the C++ ``io/native`` library),
* depth reconstruction and region statistics run on-device as one
  sort + prefix scans + boundary gathers (``pandepth_jax.device``),
* interval statistics (Length / CoveredSite / TotalDepth / Coverage% /
  MeanDepth / GC%) for chromosomes, windows, BED regions and GFF/GTF
  features are prefix-integral differences (``pandepth_jax.stats``),
* multi-chip scaling shards genome ranges over a ``jax.sharding`` mesh
  with psum merges (``pandepth_jax.sharding``).

The CLI (``pandepth_jax.cli``) is flag-compatible with the reference
``pandepth`` binary and produces byte-identical (decompressed) stat
tables.
"""

__version__ = "0.1.0"

# Importing the package is deliberately jax-free: the CLI launcher
# overlaps jax + device-client initialization with native file IO
# (see pandepth_jax/boot.py). The jax process config (x64, compile
# cache) is applied by boot.configure_jax(), which the device/sharding
# package inits call before their first `import jax`.
from pandepth_jax.config import RunConfig  # noqa: F401,E402
