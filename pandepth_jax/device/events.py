"""CIGAR -> coverage-event extraction (device, fully vectorized).

The reference's hot loop walks each CIGAR sequentially and increments a
per-base counter for every covered base (src/PanDepth.cpp:576-597 and
clones) — O(bases) scalar stores, the shape data-parallel hardware
handles worst. We instead emit *difference events*: every M/=/X
segment contributes ``+1`` at its reference start and ``-1`` at its
end, so a read costs O(cigar segments)
and the depth function is recovered later by one scan over
position-sorted events (see device/sweep.py). Filter semantics match
the reference: drop reads with any FLAG bit of the mask set
(src/PanDepth.cpp:436) and, when ``-q`` >= 1, reads with
``mapq < q`` (src/PanDepth.cpp:437; the default q = -1 disables the
filter entirely, quirk Q2); D/N advance the cursor, I/S/H/P are ignored
(src/PanDepth.cpp:440-459).

Padded/filtered slots become events at ``SENTINEL`` with delta 0: they
sort to the end of the stream and are arithmetically inert, so no
dynamic shapes ever appear.
"""

from __future__ import annotations

import functools

from pandepth_jax import boot as _boot

_boot.configure_jax()  # x64 + cache config must precede jax use

import jax
import jax.numpy as jnp

# shared with the jax-free host path (single source of truth there;
# SENTINEL stays a plain Python int: a device scalar here would
# initialize the backend at import time and force a device sync at
# every host-side use)
from pandepth_jax.device.hosteval import (DEPTH_MASK,  # noqa: F401
                                          REF_CONSUME_MASK, SENTINEL)


@functools.partial(jax.jit, static_argnames=("flags_mask", "min_mapq"))
def extract_events(tid, pos, flag, mapq, op_code, op_len, op_read,
                   offsets, limits, flags_mask: int, min_mapq: int):
    """Turn a padded columnar read batch into coverage events.

    Args:
      tid, pos, flag, mapq: (N,) int32; padded rows carry tid = -1.
      op_code, op_len, op_read: (M,) int32 flattened CIGAR stream;
        padded ops carry op_len = 0 and any valid op_read.
      offsets, limits: (n_targets,) int64 genome layout.
    Returns:
      ev_pos (2M,) int64 global coordinates, ev_delta (2M,) int32.
    """
    keep = (flag & flags_mask) == 0
    keep &= tid >= 0
    if min_mapq >= 1:
        keep &= mapq >= min_mapq

    consumes = (REF_CONSUME_MASK >> op_code) & 1
    clen = (op_len * consumes).astype(jnp.int64)
    c = jnp.cumsum(clen)
    excl = c - clen
    n = tid.shape[0]
    # reference offset of each op within its read: exclusive running
    # ref-consumed length, rebased per read (op_read ascending).
    base = jax.ops.segment_min(excl, op_read, num_segments=n,
                               indices_are_sorted=True)
    off = excl - base[op_read]

    is_depth = (((DEPTH_MASK >> op_code) & 1) == 1)
    is_depth &= keep[op_read] & (op_len > 0)

    tid_safe = jnp.maximum(tid, 0)
    read_base = offsets[tid_safe] + pos.astype(jnp.int64)
    read_limit = limits[tid_safe]
    read_floor = offsets[tid_safe]

    start = read_base[op_read] + off
    end = start + op_len
    # keep events inside the contig's padded range (the reference's +500
    # slack absorbs the same overhang, src/PanDepth.cpp:4137)
    start = jnp.clip(start, read_floor[op_read], read_limit[op_read])
    end = jnp.clip(end, read_floor[op_read], read_limit[op_read])

    live = is_depth & (end > start)
    ev_pos = jnp.concatenate([jnp.where(live, start, SENTINEL),
                              jnp.where(live, end, SENTINEL)])
    one = jnp.ones_like(op_code)
    ev_delta = jnp.concatenate([jnp.where(live, one, 0),
                                jnp.where(live, -one, 0)]).astype(jnp.int32)
    return ev_pos, ev_delta


from pandepth_jax.device.hosteval import pad_pow2  # noqa: F401,E402
