"""Multi-chip scaling for on-device read feeds: genome-range sharding
with a range-bucketed ``all_to_all`` event exchange.

The reference's only parallelism is one process's std::threads over
chromosome groups (scheduler at src/PanDepth.cpp:4151-4260). The device
mapping (SURVEY.md §2.3): every device owns a contiguous range of the
flattened genome axis; coverage statistics are *additive over disjoint
position ranges*, so each device sweeps only its range and the final
tables are one ``psum`` away.

Two formulations exist:

- the **production CLI path** (sharding/engine.py) buckets events on
  the host and places each bucket directly on its owning device —
  zero event collectives;
- this module's ``sharded_coverage_step`` takes raw *read columns*
  already sharded across devices (multi-host feeds where every process
  decodes its own files): events are extracted on-device, bucketed by
  owning range, and exchanged with one ``all_to_all`` whose per-pair
  capacity adapts to the event distribution (retry-on-overflow, a
  replicated scalar check). Per-device memory stays
  O(local events + owned-range events) — the round-1 ``all_gather``
  formulation was O(total events) per device and is gone.

The depth carried into each range is the psum of per-range delta sums
left of it, injected as one synthetic event at the range start.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

from pandepth_jax import boot as _boot

_boot.configure_jax()  # x64 + cache config must precede jax use

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from pandepth_jax.device.events import SENTINEL, extract_events, pad_pow2
from pandepth_jax.device import sweep as sweep_mod


def make_mesh(devices: Optional[Sequence] = None,
              dp: Optional[int] = None) -> Mesh:
    """Build a (dp, gs) mesh over the given (or all) devices.

    The split follows the algorithm, not the wiring: the cards of one
    host are joined all to all (NVLink), so any factorisation reaches
    every peer at the same rate. ``dp`` carries read-batch data
    parallelism and ``gs`` the genome-range shards; the coverage step
    flattens both into one range axis."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if dp is None:
        dp = 2 if n % 2 == 0 and n >= 4 else 1
    gs = n // dp
    arr = np.asarray(devices[: dp * gs]).reshape(dp, gs)
    return Mesh(arr, ("dp", "gs"))


def shard_map_fn(fn, mesh, in_specs, out_specs):
    return jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs)


def _bucket_exchange(ev_pos, ev_delta, bounds, n_dev: int, cap: int):
    """Range-bucket local events and hop each bucket to its owning
    device with one ``all_to_all``. Returns
    (recv_pos, recv_del, carry, overflow, lo, hi) — the exchange half
    of :func:`_exchange_sorted`."""
    rid = jax.lax.axis_index("x")
    lo, hi = bounds[rid], bounds[rid + 1]

    # destination range of every local event; dead (sentinel /
    # filtered) slots go to a virtual bucket n_dev
    live = ev_delta != 0
    dest = jnp.clip(
        jnp.searchsorted(bounds[1:-1], ev_pos, side="right"),
        0, n_dev - 1).astype(jnp.int32)
    dest = jnp.where(live, dest, n_dev)

    # per-range delta sums -> carry flowing into each range
    local_sums = jax.ops.segment_sum(
        ev_delta.astype(jnp.int64), dest, num_segments=n_dev + 1)
    range_sums = jax.lax.psum(local_sums[:n_dev], "x")
    carry = (jnp.cumsum(range_sums) - range_sums)[rid].astype(
        jnp.int32)

    # bucket locally: sort by destination, then slot within bucket
    dest_s, order = jax.lax.sort_key_val(
        dest, jnp.arange(dest.shape[0], dtype=jnp.int32))
    pos_s = ev_pos[order]
    del_s = ev_delta[order]
    starts = jnp.searchsorted(
        dest_s, jnp.arange(n_dev, dtype=jnp.int32), side="left")
    slot = jnp.arange(dest_s.shape[0], dtype=jnp.int32) - \
        starts[jnp.minimum(dest_s, n_dev - 1)]
    ok = (dest_s < n_dev) & (slot < cap)
    overflow = jnp.sum(
        jnp.where((dest_s < n_dev) & (slot >= cap), 1, 0))
    overflow = jax.lax.psum(overflow, "x")
    flat = jnp.where(ok, dest_s * cap + slot, n_dev * cap)
    send_pos = jnp.full((n_dev * cap + 1,),
                        jnp.iinfo(ev_pos.dtype).max,
                        ev_pos.dtype).at[flat].set(
        pos_s, mode="drop")[: n_dev * cap].reshape(n_dev, cap)
    send_del = jnp.zeros((n_dev * cap + 1,),
                         jnp.int32).at[flat].set(
        del_s, mode="drop")[: n_dev * cap].reshape(n_dev, cap)

    # one hop: row j of the send buffer goes to device j
    recv_pos = jax.lax.all_to_all(send_pos, "x", 0, 0,
                                  tiled=True).reshape(-1)
    recv_del = jax.lax.all_to_all(send_del, "x", 0, 0,
                                  tiled=True).reshape(-1)
    return recv_pos, recv_del, carry, overflow, lo, hi


def _exchange_sorted(ev_pos, ev_delta, bounds, n_dev: int, cap: int,
                     min_dep: int, wrap18: bool):
    """Shared shard_map body: range-bucket local events, one
    ``all_to_all`` hop to the owning device, carry-corrected local
    sort+scan. Returns (pos_sw, depth, c_cov, c_sum, overflow, lo, hi)
    — the per-device sweep state over its owned range."""
    recv_pos, recv_del, carry, overflow, lo, hi = _bucket_exchange(
        ev_pos, ev_delta, bounds, n_dev, cap)
    pos2 = jnp.concatenate(
        [lo[None].astype(recv_pos.dtype), recv_pos])
    del2 = jnp.concatenate([carry[None], recv_del])
    pos_sw, depth, c_cov, c_sum, _ = sweep_mod.sort_events(
        pos2, del2, min_dep=min_dep, wrap18=wrap18)
    return pos_sw, depth, c_cov, c_sum, overflow, lo, hi


def _state_eval(pos_sw, depth, c_cov, c_sum, lo, hi, seg_lo, seg_hi,
                min_dep: int):
    md = jnp.int32(min_dep)
    lo_q = jnp.clip(seg_lo, lo, hi)
    hi_q = jnp.clip(seg_hi, lo, hi)
    cover, dsum = sweep_mod.eval_pair(pos_sw, depth, c_cov, c_sum,
                                      md, lo_q, hi_q)
    return jax.lax.psum(cover, "x"), jax.lax.psum(dsum, "x")


def _exchange_and_sweep(ev_pos, ev_delta, bounds, seg_lo, seg_hi,
                        n_dev: int, cap: int, min_dep: int,
                        wrap18: bool):
    """Exchange + sweep + psum'd segment eval in one body.
    Returns (cover, dsum, overflow)."""
    pos_sw, depth, c_cov, c_sum, overflow, lo, hi = _exchange_sorted(
        ev_pos, ev_delta, bounds, n_dev, cap, min_dep, wrap18)
    cover, dsum = _state_eval(pos_sw, depth, c_cov, c_sum, lo, hi,
                              seg_lo, seg_hi, min_dep)
    return cover, dsum, overflow


@functools.lru_cache(maxsize=None)
def _exchange_step(mesh: Mesh, n_dev: int, cap: int, flags_mask: int,
                   min_mapq: int, min_dep: int, wrap18: bool):
    """One jitted bucketed-exchange coverage step over raw read
    columns at per-pair event capacity ``cap``. Returns (cover, dsum,
    overflow); overflow > 0 means some (src, dst) bucket exceeded
    ``cap`` and the caller must retry with a larger capacity."""

    def step(tid, pos, flag, mapq, opc, opl, opr, offsets, limits,
             bounds, seg_lo, seg_hi):
        ev_pos, ev_delta = extract_events(
            tid, pos, flag, mapq, opc, opl, opr, offsets, limits,
            flags_mask=flags_mask, min_mapq=min_mapq)
        return _exchange_and_sweep(ev_pos, ev_delta, bounds, seg_lo,
                                   seg_hi, n_dev, cap, min_dep,
                                   wrap18)

    sh = P("x")
    rep = P()
    return jax.jit(shard_map_fn(
        step, mesh,
        in_specs=(sh, sh, sh, sh,      # reads
                  sh, sh, sh,          # cigar stream
                  rep, rep, rep, rep, rep),
        out_specs=(rep, rep, rep)))


@functools.lru_cache(maxsize=None)
def _events_exchange_finalize(mesh: Mesh, n_dev: int, cap: int,
                              min_dep: int, wrap18: bool):
    """Bucketed-exchange finalize over pre-extracted event rows — the
    multi-host path: every process decodes its own input files (the
    150 Gb-reads workload is decode-bound, so feed scaling IS the
    scaling) and contributes its events as rows on its local devices;
    one ``all_to_all`` lands each event on the device owning its
    genome range (NVLink within a host, the network across), and the
    replicated tables come back identical on every process. ALSO
    returns the per-device sorted sweep state as sharded rows, so
    follow-up segment batches (query chunks, a second table pass)
    evaluate against the cached device-resident state without
    repeating the all_to_all + sort."""

    def step(pos2d, delta2d, bounds, seg_lo, seg_hi):
        pos_sw, depth, c_cov, c_sum, overflow, lo, hi = \
            _exchange_sorted(pos2d[0], delta2d[0], bounds, n_dev, cap,
                             min_dep, wrap18)
        cover, dsum = _state_eval(pos_sw, depth, c_cov, c_sum, lo, hi,
                                  seg_lo, seg_hi, min_dep)
        return (cover, dsum, overflow, pos_sw[None], depth[None],
                c_cov[None], c_sum[None])

    row = P("x", None)
    rep = P()
    return jax.jit(shard_map_fn(
        step, mesh, in_specs=(row, row, rep, rep, rep),
        out_specs=(rep, rep, rep, row, row, row, row)))


@functools.lru_cache(maxsize=None)
def _events_eval_step(mesh: Mesh, min_dep: int):
    """Eval-only companion of _events_exchange_finalize: psum'd
    segment stats against the cached sharded sweep state."""

    def step(pos_s2, depth2, c_cov2, c_sum2, bounds, seg_lo, seg_hi):
        rid = jax.lax.axis_index("x")
        lo, hi = bounds[rid], bounds[rid + 1]
        return _state_eval(pos_s2[0], depth2[0], c_cov2[0], c_sum2[0],
                           lo, hi, seg_lo, seg_hi, min_dep)

    row = P("x", None)
    rep = P()
    return jax.jit(shard_map_fn(
        step, mesh, in_specs=(row, row, row, row, rep, rep, rep),
        out_specs=(rep, rep)))


@functools.lru_cache(maxsize=None)
def _pmax_scalar_step(mesh: Mesh):
    """Replicated max of a per-device scalar row (multi-host row-size
    agreement). Cached so repeat calls reuse one compiled program."""
    return jax.jit(shard_map_fn(
        lambda v: jax.lax.pmax(v[0], "x"), mesh,
        in_specs=P("x"), out_specs=P()))


def sharded_coverage_step(mesh: Mesh, flags_mask: int, min_mapq: int,
                          min_dep: int, wrap18: bool = False):
    """Build a full coverage step over the mesh (any shape; devices are
    flattened into one range-sharding axis).

    The returned function takes globally-shaped arrays:
      tid/pos/flag/mapq: (N,) int32 — reads, sharded over devices
      op_code/op_len/op_read: (M,) int32 — CIGAR stream, sharded over
        devices; op_read indexes into the *local* read shard
      offsets/limits: (n_targets,) int64 — replicated genome layout
      bounds: (n_dev + 1,) int64 — replicated genome range cuts
      seg_lo/seg_hi: (B,) int64 — replicated segment boundaries
    and returns replicated (cover, depth_sum) int64 arrays of shape
    (B,). Capacity for the bucketed exchange starts at 2x the balanced
    per-pair load and doubles on overflow (hot ranges are rare but
    must stay correct).
    """
    flat = Mesh(mesh.devices.reshape(-1), ("x",))
    n_dev = int(mesh.devices.size)

    def run(tid, pos, flag, mapq, opc, opl, opr, offsets, limits,
            bounds, seg_lo, seg_hi):
        m_local = -(-int(opc.shape[0]) // n_dev)
        # 2 events per op, 2x safety over the balanced per-pair share
        cap = pad_pow2(-(-4 * m_local // n_dev), floor=8)
        max_cap = pad_pow2(2 * m_local, floor=8)
        while True:
            step = _exchange_step(flat, n_dev, cap, int(flags_mask),
                                  int(min_mapq), int(min_dep),
                                  bool(wrap18))
            cover, dsum, overflow = step(tid, pos, flag, mapq, opc,
                                         opl, opr, offsets, limits,
                                         bounds, seg_lo, seg_hi)
            if int(overflow) == 0 or cap >= max_cap:
                return cover, dsum
            cap = min(cap * 2, max_cap)

    return run
