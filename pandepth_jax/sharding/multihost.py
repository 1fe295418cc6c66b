"""Multi-host production engine: distributed decode, one event
exchange, replicated tables.

The reference binary is one process; its ceiling is one machine
(SURVEY.md §2.3). Here every host joins a ``jax.distributed`` job and
decodes ITS OWN shard of the input files (process_read_shard) — the
150 Gb-reads workload is decode-bound, so feed scaling is the actual
scaling. Events go through the range-bucketed ``all_to_all`` of
sharding/mesh.py (NVLink within a host, the network across); every
process gets
identical replicated tables and only process 0 writes them
(run._finalize_and_write).

Multi-sample additivity (the reference's BamList_main,
src/PanDepth.cpp:2029-3410) is what makes file sharding correct:
depth sums over files regardless of which host decoded which file.
"""

from __future__ import annotations

import os

import numpy as np

from pandepth_jax import boot as _boot

_boot.configure_jax()  # x64 + cache config must precede jax use

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pandepth_jax.device.events import pad_pow2
from pandepth_jax.device.layout import GenomeLayout
from pandepth_jax.sharding.engine import ShardedCoverageEngine
from pandepth_jax.sharding import mesh as mesh_mod


class MultihostCoverageEngine(ShardedCoverageEngine):
    """ShardedCoverageEngine over ALL processes' devices.

    Feeds accumulate host-side exactly like the single-controller
    engine; finalize pads every process's local events to a globally
    agreed row size, places rows on local devices, and runs the
    bucketed-exchange step. Results are replicated — every rank can
    evaluate follow-up segment batches against its cached replicated
    state without further collectives. Site dumps (``-a``) write
    range-sharded: every rank emits its ranges' rows and rank 0
    assembles (write_site_depth)."""

    def __init__(self, layout: GenomeLayout, flags_mask: int = 1796,
                 min_mapq: int = -1, min_dep: int = 1,
                 wrap18: bool = False):
        super().__init__(layout, flags_mask=flags_mask,
                         min_mapq=min_mapq, min_dep=min_dep,
                         wrap18=wrap18, devices=jax.devices())
        self._local = jax.local_devices()
        self._flat = Mesh(np.asarray(jax.devices()), ("x",))
        # events ride the inherited 32-bit tier whenever the padded
        # genome fits (pos_dtype_for): halves the exchanged bytes AND
        # the sort width vs the round-2 int64 layout

    # ----------------------------------------------------------------
    def _local_events(self):
        if self._chunks:
            pos = np.concatenate([c[0] for c in self._chunks])
            delta = np.concatenate([c[1] for c in self._chunks])
        else:
            pos = np.zeros(0, self.pos_dtype)
            delta = np.zeros(0, np.int32)
        return pos.astype(self.pos_dtype, copy=False), delta

    def _row_cap(self, n_local_rows: int) -> int:
        """Globally agreed per-device row size: pmax of the local
        per-row need (every process must build the same global shape).
        The jitted pmax program is cached per mesh (a fresh @jax.jit
        closure per call would retrace every time). One process IS the
        globe — skip the collective."""
        if jax.process_count() == 1:
            return int(n_local_rows)
        gmax = mesh_mod._pmax_scalar_step(self._flat)
        need = np.zeros(len(self._local), np.int64)
        need[:] = n_local_rows
        arrs = [jax.device_put(need[i: i + 1], d)
                for i, d in enumerate(self._local)]
        sh = NamedSharding(self._flat, P("x"))
        g = jax.make_array_from_single_device_arrays(
            (self.n_dev,), sh, arrs)
        return int(jax.device_get(gmax(g)))

    def _global_rows(self, pos: np.ndarray, delta: np.ndarray,
                     cap: int):
        """(n_dev_global, cap) event arrays: this process's events are
        split round-robin-contiguously over its local devices' rows;
        other rows come from the other processes."""
        L = len(self._local)
        per = -(-max(pos.shape[0], 1) // L)
        sh = NamedSharding(self._flat, P("x", None))
        rows_p, rows_d = [], []
        for i, d in enumerate(self._local):
            a, b = i * per, min((i + 1) * per, pos.shape[0])
            rp = np.full((1, cap), self.pos_sentinel, self.pos_dtype)
            rd = np.zeros((1, cap), np.int32)
            if b > a:
                rp[0, : b - a] = pos[a:b]
                rd[0, : b - a] = delta[a:b]
            rows_p.append(jax.device_put(rp, d))
            rows_d.append(jax.device_put(rd, d))
        gp = jax.make_array_from_single_device_arrays(
            (self.n_dev, cap), sh, rows_p)
        gd = jax.make_array_from_single_device_arrays(
            (self.n_dev, cap), sh, rows_d)
        return gp, gd

    # ----------------------------------------------------------------
    def segment_stats(self, seg_tid, seg_start, seg_end,
                      chunk: int = 1 << 20):
        lay = self.layout
        lo = lay.offsets[seg_tid] + np.maximum(
            np.asarray(seg_start, np.int64) - 1, 0)
        hi = lay.offsets[seg_tid] + np.asarray(seg_end, np.int64)
        lo = np.minimum(lo, lay.limits[seg_tid])
        hi = np.minimum(hi, lay.limits[seg_tid])
        hi = np.maximum(hi, lo)
        b = lo.shape[0]

        cover = np.empty(b, np.int64)
        dsum = np.empty(b, np.int64)
        bounds = jnp.asarray(self.bounds)
        for i in range(0, b, chunk):
            j = min(i + chunk, b)
            bp = pad_pow2(j - i, floor=256)
            lo_c = np.zeros(bp, np.int64)
            hi_c = np.zeros(bp, np.int64)
            lo_c[: j - i] = lo[i:j]
            hi_c[: j - i] = hi[i:j]
            if self._state is None:
                # one exchange + sort per FEED (not per chunk/call):
                # the finalize also returns the sharded sweep state,
                # and every later batch rides the cheap eval program
                # (the class docstring's cached-replicated-state
                # contract). Exchange capacity: every host KNOWS its
                # rows' per-destination bucket counts (one bincount),
                # so one pmax agrees on the EXACT global (src, dst)
                # bucket max — no balanced-share guess, no overflow
                # retry re-running the whole exchange+sort (the
                # doubling loop below stays as a safety net only).
                pos, delta = self._local_events()
                L = len(self._local)
                per = -(-max(pos.shape[0], 1) // L)
                need = 1
                for r in range(L):
                    sl = pos[r * per: (r + 1) * per]
                    if sl.shape[0]:
                        dst = np.searchsorted(self.bounds[1:-1], sl,
                                              side="right")
                        need = max(need, int(np.bincount(
                            np.minimum(dst, self.n_dev - 1),
                            minlength=self.n_dev).max()))
                rcap = self._row_cap(per)
                rcap = pad_pow2(rcap, floor=256)
                gp, gd = self._global_rows(pos, delta, rcap)
                ex = pad_pow2(self._row_cap(need), floor=8)
                mx = pad_pow2(2 * rcap, floor=8)
                while True:
                    fin = mesh_mod._events_exchange_finalize(
                        self._flat, self.n_dev, ex, self.min_dep,
                        self.wrap18)
                    out = fin(gp, gd, bounds, jnp.asarray(lo_c),
                              jnp.asarray(hi_c))
                    if int(out[2]) == 0 or ex >= mx:
                        break
                    ex = min(ex * 2, mx)
                qc, qs = out[0], out[1]
                self._state = out[3:7]
            else:
                ev = mesh_mod._events_eval_step(self._flat,
                                                self.min_dep)
                qc, qs = ev(*self._state, bounds, jnp.asarray(lo_c),
                            jnp.asarray(hi_c))
            cover[i:j] = np.asarray(qc)[: j - i]
            dsum[i:j] = np.asarray(qs)[: j - i]
        from pandepth_jax.device.engine import SegmentStats

        return SegmentStats(cover=cover, depth_sum=dsum)

    # ------------------------------------------------------- site dump
    def write_site_depth(self, path: str, names, lengths,
                         tids_with_regions) -> None:
        """Multihost ``-a``: every rank writes the SiteDepth rows of
        the genome ranges its local devices own (one part file per
        device row; the per-row sweep state is already absolute-depth
        thanks to the carried-in synthetic event), then rank 0
        concatenates the parts in range order — gzip members
        concatenate, and ascending flat ranges are ascending output
        lines, so the result is byte-identical content to the
        single-host writer (reference src/PanDepth.cpp:4264-4284).

        MUST be called on every rank (it ends in a global barrier);
        the parts ride the job's shared filesystem."""
        from pandepth_jax.device.engine import dense_from_state
        from pandepth_jax.stats.tables import write_site_depth_range
        from pandepth_jax.io.text import GzTextWriter

        if self._state is None:
            # collective finalize on all ranks with a trivial query
            self.segment_stats(np.zeros(1, np.int64),
                               np.ones(1, np.int64),
                               np.ones(1, np.int64))
        lay = self.layout
        pos2, dep2 = self._state[0], self._state[1]
        for sp, sd in zip(pos2.addressable_shards,
                          dep2.addressable_shards):
            r = sp.index[0].start or 0
            part = f"{path}.part{r:05d}"
            try:  # a crashed previous run may have left a stale part;
                # ranges that write nothing this run must not let it
                # survive into rank 0's concatenation
                os.remove(part)
            except OSError:
                pass
            lo, hi = int(self.bounds[r]), int(self.bounds[r + 1])
            if hi <= lo:
                continue
            pos_row = np.asarray(sp.data)[0].astype(np.int64,
                                                    copy=False)
            dep_row = np.asarray(sd.data)[0]
            write_site_depth_range(
                part, names, lengths, lay.offsets,
                tids_with_regions, lo, hi,
                lambda a, b: dense_from_state(pos_row, dep_row, a, b))

        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices("pandepth_site_depth")
        if jax.process_index() != 0:
            return
        wrote = False
        with open(path, "wb") as out:
            import shutil

            for r in range(self.n_dev):
                part = f"{path}.part{r:05d}"
                if not os.path.exists(part):
                    continue
                with open(part, "rb") as fh:
                    shutil.copyfileobj(fh, out, 1 << 20)
                os.remove(part)
                wrote = True
        import glob

        for stale in glob.glob(f"{path}.part*"):
            # e.g. a previous run at a larger device count crashed
            try:
                os.remove(stale)
            except OSError:
                pass
        if not wrote:  # keep an (empty) gzip file for parity
            with GzTextWriter(path):
                pass
