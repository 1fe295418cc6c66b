"""ShardedCoverageEngine: the multi-chip production engine.

The reference's core identity is a scheduler fanning chromosome groups
over threads that write disjoint per-base array shards
(src/PanDepth.cpp:4151-4260).  The device analog shards the
*flattened genome position axis* into contiguous ranges, one per
device of a mesh:

- the host buckets every coverage event by the range owning its
  position (one ``searchsorted`` over the range bounds) and places
  each bucket directly on its owning device — events never cross the
  interconnect at all, beating both the all-gather and the
  all-to-all formulations (those exist for on-device feeds, see
  sharding/mesh.py);
- each device runs the same sort+scan sweep as the single-chip engine
  (device/sweep.py) over its own range only, with the depth *carried
  into* the range injected as one synthetic event whose delta is the
  sum of all deltas left of the range — an ``all_gather`` of one
  scalar per device;
- region statistics are additive over disjoint position ranges, so
  each device evaluates its clipped share of every segment and the
  final tables are one ``psum``.

Per-device memory and compute are O(E / n_devices); the only
collective traffic is n_devices scalars plus the (B,) result vectors.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

from pandepth_jax import boot as _boot

_boot.configure_jax()  # x64 + cache config must precede jax use

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from pandepth_jax.device.engine import (SegmentStats, dense_from_state,
                                        pos_dtype_for)
from pandepth_jax.device.events import SENTINEL, pad_pow2
from pandepth_jax.device.layout import GenomeLayout
from pandepth_jax.device import sweep as sweep_mod
from pandepth_jax.io.bam import ReadBatch


# numpy twin of device/events.extract_events for host-side feeds —
# the one implementation lives in the jax-free hosteval module
from pandepth_jax.device.hosteval import host_extract_events  # noqa: F401,E402


@functools.lru_cache(maxsize=None)
def _flat_mesh(devices: tuple) -> Mesh:
    return Mesh(np.asarray(devices), ("gs",))


@functools.lru_cache(maxsize=None)
def _sharded_steps(mesh: Mesh, n_dev: int, min_dep: int, wrap18: bool):
    """(finalize, eval) jitted shard_map programs for one mesh/config.

    finalize: (pos2d, delta2d, bounds, seg_lo, seg_hi)
        -> (cover, dsum, pos_s2, depth2, c_cov2, c_sum2)
    eval:     (pos_s2, depth2, c_cov2, c_sum2, bounds, seg_lo, seg_hi)
        -> (cover, dsum)
    2-D arrays are sharded over rows (one row per device); bounds and
    segment boundaries are replicated; cover/dsum are replicated.
    """

    def local_eval(pos_s, depth, c_cov, c_sum, lo, hi, seg_lo, seg_hi):
        md = jnp.int32(min_dep)
        lo_q = jnp.clip(seg_lo, lo, hi).astype(pos_s.dtype)
        hi_q = jnp.clip(seg_hi, lo, hi).astype(pos_s.dtype)
        cover, dsum = sweep_mod.eval_pair(pos_s, depth, c_cov, c_sum,
                                          md, lo_q, hi_q)
        return (jax.lax.psum(cover, "gs"), jax.lax.psum(dsum, "gs"))

    def finalize(pos2d, delta2d, bounds, seg_lo, seg_hi):
        pos, delta = pos2d[0], delta2d[0]
        rid = jax.lax.axis_index("gs")
        lo, hi = bounds[rid], bounds[rid + 1]
        # depth carried into this range = sum of all deltas to the left;
        # buckets are disjoint position ranges in device order, so the
        # left-sum is an exclusive prefix over the per-device delta sums
        total = jnp.sum(delta, dtype=jnp.int64)
        sums = jax.lax.all_gather(total, "gs")
        carry = jnp.sum(
            jnp.where(jnp.arange(n_dev) < rid, sums, 0)).astype(jnp.int32)
        pos2 = jnp.concatenate([lo[None].astype(pos.dtype), pos])
        del2 = jnp.concatenate([carry[None], delta])
        pos_s, depth, c_cov, c_sum, _ = sweep_mod.sort_events(
            pos2, del2, min_dep=min_dep, wrap18=wrap18)
        cover, dsum = local_eval(pos_s, depth, c_cov, c_sum, lo, hi,
                                 seg_lo, seg_hi)
        return (cover, dsum, pos_s[None], depth[None], c_cov[None],
                c_sum[None])

    def eval_only(pos_s2, depth2, c_cov2, c_sum2, bounds, seg_lo,
                  seg_hi):
        rid = jax.lax.axis_index("gs")
        lo, hi = bounds[rid], bounds[rid + 1]
        return local_eval(pos_s2[0], depth2[0], c_cov2[0], c_sum2[0],
                          lo, hi, seg_lo, seg_hi)

    row = P("gs", None)
    rep = P()
    fin = jax.jit(jax.shard_map(
        finalize, mesh=mesh,
        in_specs=(row, row, rep, rep, rep),
        out_specs=(rep, rep, row, row, row, row)))
    ev = jax.jit(jax.shard_map(
        eval_only, mesh=mesh,
        in_specs=(row, row, row, row, rep, rep, rep),
        out_specs=(rep, rep)))
    return fin, ev


class ShardedCoverageEngine:
    """CoverageEngine-compatible engine sharding the genome axis over
    all devices of a mesh (events accumulate on the host and are
    bucketed by range at finalize time)."""

    # host bucketing filters sentinels anyway: unpadded feeds are best
    wants_padded_events = False

    def __init__(self, layout: GenomeLayout, flags_mask: int = 1796,
                 min_mapq: int = -1, min_dep: int = 1,
                 wrap18: bool = False, devices=None):
        self.layout = layout
        self.flags_mask = int(flags_mask)
        self.min_mapq = int(min_mapq)
        self.min_dep = max(int(min_dep), 1)
        self.wrap18 = bool(wrap18)
        devices = tuple(devices if devices is not None
                        else jax.devices())
        self.mesh = _flat_mesh(devices)
        self.n_dev = len(devices)
        self.bounds = layout.shard_bounds(self.n_dev)
        self.pos_dtype = pos_dtype_for(layout.total)
        self.pos_sentinel = int(np.iinfo(self.pos_dtype).max)
        self._chunks: List[Tuple[np.ndarray, np.ndarray]] = []
        self._state = None        # sharded (pos_s2, depth2, c_cov2, c_sum2)
        self._host_state = None   # merged (pos, depth) numpy
        self.n_reads_seen = 0

    @property
    def pos_bits32(self) -> bool:
        return self.pos_dtype is not np.int64

    @property
    def pos_sentinel32(self) -> int:
        return int(np.array(self.pos_sentinel,
                            np.uint64).astype(np.uint32).view(np.int32))

    # ----------------------------------------------------------- feeds
    def _push(self, pos: np.ndarray, delta: np.ndarray) -> None:
        self._chunks.append((pos, delta))
        self._state = None
        self._host_state = None

    def add_start_end(self, starts: np.ndarray,
                      ends: np.ndarray) -> None:
        if starts.shape[0] == 0:
            return
        pos = np.concatenate([starts, ends])
        delta = np.concatenate([np.ones(starts.shape[0], np.int32),
                                np.full(ends.shape[0], -1, np.int32)])
        live = pos < self.pos_sentinel
        self._push(pos[live].astype(self.pos_dtype, copy=False),
                   delta[live])

    def add_padded_events(self, starts: np.ndarray,
                          ends: np.ndarray) -> None:
        self.add_start_end(starts, ends)

    def add_intervals(self, tid: np.ndarray, start0: np.ndarray,
                      end0: np.ndarray) -> None:
        if tid.shape[0] == 0:
            return
        lay = self.layout
        floor = lay.offsets[tid]
        limit = lay.limits[tid]
        s = np.clip(floor + start0, floor, limit)
        e = np.clip(floor + end0, floor, limit)
        live = e > s
        self.add_start_end(s[live], e[live])

    def add_events(self, pos: np.ndarray, delta: np.ndarray) -> None:
        live = (pos < SENTINEL) & (delta != 0)
        if not live.any():
            return
        self._push(pos[live].astype(self.pos_dtype, copy=False),
                   delta[live].astype(np.int32, copy=False))

    def add_batch(self, batch: ReadBatch) -> None:
        if batch.n_reads == 0:
            return
        self.n_reads_seen += batch.n_reads
        s, e = host_extract_events(batch, self.layout.offsets,
                                   self.layout.limits, self.flags_mask,
                                   self.min_mapq)
        self.add_start_end(s, e)

    # -------------------------------------------------------- finalize
    def _bucketed(self) -> Tuple[np.ndarray, np.ndarray]:
        """(n_dev, cap) position/delta rows: row d holds exactly the
        events inside [bounds[d], bounds[d+1]) (events at the global
        end land in the last range), sentinel-padded."""
        n_dev = self.n_dev
        if self._chunks:
            pos = np.concatenate([c[0] for c in self._chunks])
            delta = np.concatenate([c[1] for c in self._chunks])
        else:
            pos = np.zeros(0, self.pos_dtype)
            delta = np.zeros(0, np.int32)
        dest = np.searchsorted(self.bounds[1:-1], pos,
                               side="right").astype(np.int32)
        np.minimum(dest, n_dev - 1, out=dest)
        order = np.argsort(dest, kind="stable")
        counts = np.bincount(dest, minlength=n_dev)
        cap = pad_pow2(int(counts.max()) if counts.size else 1,
                       floor=256)
        pos2d = np.full((n_dev, cap), self.pos_sentinel, self.pos_dtype)
        delta2d = np.zeros((n_dev, cap), np.int32)
        pos_s = pos[order]
        delta_s = delta[order]
        offs = np.concatenate([[0], np.cumsum(counts)])
        for d in range(n_dev):
            a, b = int(offs[d]), int(offs[d + 1])
            pos2d[d, : b - a] = pos_s[a:b]
            delta2d[d, : b - a] = delta_s[a:b]
        return pos2d, delta2d

    def _seg_batch(self, lo: np.ndarray, hi: np.ndarray, b: int):
        bp = pad_pow2(b, floor=256)
        lo_c = np.zeros(bp, np.int64)
        hi_c = np.zeros(bp, np.int64)
        lo_c[:b] = lo
        hi_c[:b] = hi
        return lo_c, hi_c

    def segment_stats(self, seg_tid: np.ndarray, seg_start: np.ndarray,
                      seg_end: np.ndarray,
                      chunk: int = 1 << 20) -> SegmentStats:
        """Stats for 1-based inclusive [seg_start, seg_end] segments
        (same boundary clamping as the single-chip engine)."""
        lay = self.layout
        lo = lay.offsets[seg_tid] + np.maximum(
            np.asarray(seg_start, np.int64) - 1, 0)
        hi = lay.offsets[seg_tid] + np.asarray(seg_end, np.int64)
        lo = np.minimum(lo, lay.limits[seg_tid])
        hi = np.minimum(hi, lay.limits[seg_tid])
        hi = np.maximum(hi, lo)

        b = lo.shape[0]
        bounds = jnp.asarray(self.bounds)
        cover = np.empty(b, np.int64)
        dsum = np.empty(b, np.int64)
        for i in range(0, b, chunk):
            j = min(i + chunk, b)
            lo_c, hi_c = self._seg_batch(lo[i:j], hi[i:j], j - i)
            if self._state is None:
                pos2d, delta2d = self._bucketed()
                fin, _ = _sharded_steps(self.mesh, self.n_dev,
                                        self.min_dep, self.wrap18)
                out = fin(pos2d, delta2d, bounds, jnp.asarray(lo_c),
                          jnp.asarray(hi_c))
                self._state = out[2:6]
                qc, qs = out[0], out[1]
            else:
                _, ev = _sharded_steps(self.mesh, self.n_dev,
                                       self.min_dep, self.wrap18)
                qc, qs = ev(*self._state, bounds, jnp.asarray(lo_c),
                            jnp.asarray(hi_c))
            cover[i:j] = np.asarray(qc)[: j - i]
            dsum[i:j] = np.asarray(qs)[: j - i]
        return SegmentStats(cover=cover, depth_sum=dsum)

    # ----------------------------------------------------------- dense
    def _merged_host_state(self):
        """(pos, depth) numpy arrays merged across devices: globally
        position-sorted breakpoints with absolute depth values."""
        if self._host_state is None:
            if self._state is None:
                # force a finalize with a trivial query batch
                self.segment_stats(np.zeros(1, np.int64),
                                   np.ones(1, np.int64),
                                   np.ones(1, np.int64))
            pos2 = np.asarray(self._state[0])
            dep2 = np.asarray(self._state[1])
            keep = pos2 < self.pos_sentinel
            # rows are disjoint ascending ranges: row-major flatten of
            # the kept events is globally sorted
            self._host_state = (pos2[keep].astype(np.int64),
                                dep2[keep])
        return self._host_state

    def dense_depth(self, tid: int, start0: int = 0,
                    end0: Optional[int] = None) -> np.ndarray:
        lay = self.layout
        if end0 is None:
            end0 = int(lay.lengths[tid])
        pos_np, depth_np = self._merged_host_state()
        lo = int(lay.offsets[tid]) + start0
        hi = int(lay.offsets[tid]) + end0
        return dense_from_state(pos_np, depth_np, lo, hi)
