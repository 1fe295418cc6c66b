"""The flagship single-chip forward step: padded read batch + segment
boundaries in, per-segment coverage statistics out — one fused jitted
function (extraction -> sort -> scan -> boundary gathers)."""

from __future__ import annotations

import functools

from pandepth_jax import boot as _boot

_boot.configure_jax()  # x64 + cache config must precede jax use

import jax
import jax.numpy as jnp

from pandepth_jax.device.events import extract_events
from pandepth_jax.device import sweep as sweep_mod


@functools.partial(jax.jit, static_argnames=("flags_mask", "min_mapq",
                                             "min_dep", "wrap18"))
def coverage_step(tid, pos, flag, mapq, op_code, op_len, op_read,
                  offsets, limits, seg_lo, seg_hi,
                  flags_mask: int = 1796, min_mapq: int = -1,
                  min_dep: int = 1, wrap18: bool = False):
    """Full coverage statistics for one batch of reads.

    Returns (cover, depth_sum): int64 (B,) per 0-based half-open global
    segment [seg_lo, seg_hi).
    """
    ev_pos, ev_delta = extract_events(
        tid, pos, flag, mapq, op_code, op_len, op_read, offsets, limits,
        flags_mask=flags_mask, min_mapq=min_mapq)
    pos_s, depth, c_cov, c_sum, _ = sweep_mod.sort_events(
        ev_pos, ev_delta, min_dep=min_dep, wrap18=wrap18)
    md = jnp.int32(min_dep)
    ql_c, ql_s = sweep_mod.eval_boundaries(pos_s, depth, c_cov, c_sum,
                                           md, seg_lo)
    qh_c, qh_s = sweep_mod.eval_boundaries(pos_s, depth, c_cov, c_sum,
                                           md, seg_hi)
    return qh_c - ql_c, qh_s - ql_s
