"""Host-side I/O: alignment decoding, target parsing, table writing.

Decoders emit flat columnar numpy batches ready for device upload; see
``pandepth_jax.io.bam.ReadBatch``.
"""
