"""HostCoverageEngine: the CoverageEngine interface with a pure
host-CPU compute core — IMPORTS NO JAX.

Election (run._want_host_finalize): ``PANDEPTH_HOST_FINALIZE=1``. It
is the engine for machines without an accelerator, and the reference
that the device engines are checked against on the chip: the native
host sweep (io/native pancov_host_finalize: parallel radix sort + one
sweep) shares no code with device/sweep.py. A run through this engine
never touches jax at all.

Every statistic is byte-identical to the device engine by
construction: both are event sweeps with the same clamping, the same
``Q(hi) - Q(lo)`` prefix-integral evaluation and the same wrap18
semantics (tests/test_host_engine.py proves equality and oracle
parity)."""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from pandepth_jax.device import hosteval as he
from pandepth_jax.device.hosteval import SegmentStats
from pandepth_jax.device.layout import GenomeLayout


class HostCoverageEngine:
    """CoverageEngine-compatible engine; feeds stay host-resident."""

    wants_padded_events = True
    wants_encoded_windows = False
    # _is_writer_rank: a host-engine run is trivially the writer; it
    # must never force a jax backend init at write time (inside a warm
    # daemon init_started() is True, but this engine never needs jax)
    jax_free = True

    def __init__(self, layout: GenomeLayout, flags_mask: int = 1796,
                 min_mapq: int = -1, min_dep: int = 1,
                 wrap18: bool = False):
        self.layout = layout
        self.flags_mask = int(flags_mask)
        self.min_mapq = int(min_mapq)
        self.min_dep = max(int(min_dep), 1)
        self.wrap18 = bool(wrap18)
        self.pos_dtype = he.pos_dtype_for(layout.total)
        self.pos_sentinel = int(np.iinfo(self.pos_dtype).max)
        self._stage: List[Tuple[np.ndarray, np.ndarray]] = []
        self._extra: List[Tuple[np.ndarray, np.ndarray]] = []
        self._state: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._sweep = None  # state + derived prefix integrals
        self.n_reads_seen = 0
        self.keep_state = True

    @property
    def pos_bits32(self) -> bool:
        return self.pos_dtype is not np.int64

    @property
    def pos_sentinel32(self) -> int:
        return int(np.array(self.pos_sentinel,
                            np.uint64).astype(np.uint32).view(np.int32))

    # ------------------------------------------------ streaming fold
    def begin_streaming_fold(self, seg_tid: np.ndarray,
                             seg_start: np.ndarray,
                             seg_end: np.ndarray,
                             threshold_pairs: Optional[int] = None
                             ) -> None:
        """Bounded-memory accumulation for coordinate-sorted feeds.

        The plain engine stages every event until finalize — O(events)
        RSS, linear in read count. But a
        coordinate-sorted BAM's events arrive with nondecreasing
        START positions, so once the stream's frontier (max start
        seen) passes P, no future event can land below P — everything
        below the frontier is FINAL. With the query segments known up
        front (run.py always parses targets before the feed), staged
        chunks fold incrementally: sort the below-frontier events,
        extend the running prefix integrals ``Q_cov``/``Q_sum`` at
        every query boundary passed, carry (depth, Q_cov, Q_sum) at
        the cutoff forward, and keep only the straddling events. RSS
        is capped at O(fold window + boundaries) no matter the read
        count — the sweep-engine analog of the reference's flat 10 Mb
        windowed scan (src/PanDepth.cpp:676-679, :4129-4145).

        Sortedness is VERIFIED, not assumed: any event below the
        previous cutoff raises (the declared SO:coordinate order was a
        lie; rerun with PANDEPTH_STREAM_FOLD=0). ``segment_stats``
        afterwards only answers queries whose boundaries were
        registered here (run.py passes the same arrays)."""
        lo, hi = he.clamp_segments(self.layout, seg_tid, seg_start,
                                   seg_end)
        self._fold_bx = np.unique(np.concatenate([lo, hi]))
        nb = self._fold_bx.shape[0]
        self._fold_done_cov = np.zeros(nb, np.int64)
        self._fold_done_sum = np.zeros(nb, np.int64)
        self._fold_next_b = 0
        self._fold_cutoff = 0
        self._fold_carry_depth = 0
        self._fold_carry_cov = 0
        self._fold_carry_sum = 0
        self._fold_left: List[Tuple[np.ndarray, np.ndarray]] = []
        self._fold_frontier = 0
        self._fold_staged_pairs = 0
        self._fold_threshold = int(
            threshold_pairs if threshold_pairs is not None
            else os.environ.get("PANDEPTH_FOLD_PAIRS", 12 << 20))
        self._fold_engaged = False
        # folds run on ONE background thread so the feed keeps
        # producing while the native sort answers the previous fold
        # (the fold is ~0.25 s per 12M pairs; at 240M reads ~20 folds
        # blocked the producer ~5 s through the bounded queue)
        self._fold_thread = None
        self._fold_exc: Optional[BaseException] = None
        self._fold_sched_cutoff = 0
        self._fold_left_pending: List[Tuple[np.ndarray,
                                            np.ndarray]] = []
        self._fold_active = True

    @property
    def fold_active(self) -> bool:
        return bool(getattr(self, "_fold_active", False))

    def _fold_join(self) -> None:
        t = self._fold_thread
        if t is not None:
            t.join()
            self._fold_thread = None
        if self._fold_exc is not None:
            exc = self._fold_exc
            self._fold_exc = None
            raise exc

    def _maybe_fold_async(self) -> None:
        """Snapshot the stage and fold it on the background thread;
        backpressure only when staging runs 2x past the threshold
        while a fold is still in flight."""
        t = self._fold_thread
        if t is not None and t.is_alive():
            if self._fold_staged_pairs < 2 * self._fold_threshold:
                return
        self._fold_join()
        cutoff = self._fold_frontier
        if cutoff <= self._fold_sched_cutoff:
            return
        self._fold_sched_cutoff = cutoff
        stage = self._stage
        self._stage = []
        self._fold_staged_pairs = 0
        if self._fold_left_pending:
            self._fold_left.extend(self._fold_left_pending)
            self._fold_left_pending = []
        import threading

        def run():
            try:
                self._fold(cutoff, stage)
            except BaseException as e:  # surfaced at join
                self._fold_exc = e

        self._fold_thread = threading.Thread(
            target=run, name="pandepth-fold", daemon=True)
        self._fold_thread.start()

    def _fold(self, cutoff: int, stage) -> None:
        """Fold ``stage`` + leftover events below ``cutoff`` into the
        running boundary integrals; keep the rest for the next fold.
        Runs on the background fold thread (or the caller's thread at
        finalize); fold state (_fold_left, carries, done arrays) is
        touched ONLY here and at snapshot points after a join."""
        dbg = os.environ.get("PANDEPTH_FOLD_DEBUG")
        if dbg:
            import sys as _sys
            import time as _time

            _t0 = _time.perf_counter()
            _n_stage = sum(s.shape[0] for s, _ in stage)
            _n_left = sum(p.shape[0] for p, _ in self._fold_left)
        self._fold_engaged = True
        prev = self._fold_cutoff
        sent = self.pos_dtype(self.pos_sentinel)
        # sortedness check: any event below the previous cutoff means
        # the declared coordinate order was a lie (cheap vectorized
        # mins over the raw chunks)
        for s, _e in stage:
            # a pair's start <= its end, so starts alone witness any
            # below-cutoff event (sentinel slots are the max value and
            # never the min)
            if s.shape[0] and int(s.min()) < prev:
                raise RuntimeError(
                    "streaming fold: an event arrived below the "
                    "previous fold cutoff — the input is not "
                    "coordinate-sorted as its header declared; rerun "
                    "with PANDEPTH_STREAM_FOLD=0")
        # the ENTIRE fold eval rides the native finalize: events above
        # the cutoff cannot affect integrals at or below it, so the
        # staged chunks go in unfiltered; each pending boundary b in
        # (prev, cutoff] is the query (prev, b], and a synthetic
        # +carry event at prev carries the running depth in. One
        # native radix sort + eval per fold, no big numpy
        # intermediates (an earlier all-numpy fold eval cost 3-6 s a
        # fold on this VM's slow page faults).
        bx = self._fold_bx
        j = int(np.searchsorted(bx, cutoff, side="right"))
        pend = bx[self._fold_next_b:j]
        qlo = np.full(pend.shape[0] + 1, prev, np.int64)
        qhi = np.empty(pend.shape[0] + 1, np.int64)
        qhi[:-1] = pend
        # the carry query integrates (prev, cutoff] — clamped to the
        # layout's end: integrals past the last possible boundary are
        # never read, and an unclamped int64 sentinel here would send
        # the slabbed >4 Gb path iterating 2^32 coordinate slabs
        qhi[-1] = max(min(cutoff, int(self.layout.limits[-1])),
                      int(prev))
        carry_disp = (self._fold_carry_depth & he.WRAP18_MASK) \
            if self.wrap18 else self._fold_carry_depth
        xp = [p for p, _ in self._fold_left] + \
            [np.asarray([prev], self.pos_dtype)]
        xd = [d for _, d in self._fold_left] + \
            [np.asarray([carry_disp], np.int32)]
        cover, dsum, _ = he.finalize_events(
            stage, np.concatenate(xp), np.concatenate(xd),
            self.pos_sentinel, qlo, qhi, self.min_dep, self.wrap18,
            keep_state=False)
        if pend.shape[0]:
            self._fold_done_cov[self._fold_next_b:j] = \
                self._fold_carry_cov + cover[:-1]
            self._fold_done_sum[self._fold_next_b:j] = \
                self._fold_carry_sum + dsum[:-1]
            self._fold_next_b = j
        self._fold_carry_cov += int(cover[-1])
        self._fold_carry_sum += int(dsum[-1])
        # leftover + carry depth from cheap masks over the raw chunks
        # (no sort needed: the next fold's native sort re-sorts them)
        cut = self.pos_dtype(min(cutoff, int(self.pos_sentinel)))
        new_left: List[Tuple[np.ndarray, np.ndarray]] = []
        dcarry = 0
        for s, e in stage:
            ms = (s >= cut) & (s < sent)
            me = (e >= cut) & (e < sent)
            ks = int(ms.sum())
            ke = int(me.sum())
            dcarry += (int((s < cut).sum()) - int((e < cut).sum()))
            if ks:
                new_left.append((s[ms], np.ones(ks, np.int32)))
            if ke:
                new_left.append((e[me], np.full(ke, -1, np.int32)))
        for p, d in self._fold_left:
            keep = p >= cut
            dcarry += int(d[~keep].sum())
            if keep.any():
                new_left.append((p[keep], d[keep]))
        self._fold_left = new_left
        self._fold_carry_depth += dcarry
        self._fold_cutoff = cutoff
        # release the fold interval's freed pages: boot.disable_thp
        # pins M_TRIM/M_MMAP at 1 GB so glibc retains every freed
        # staging buffer, and with the producer's worker threads
        # allocating concurrently the retained regions fragment —
        # RSS climbed ~250 MB per fold interval until trimmed
        try:
            import ctypes

            ctypes.CDLL(None).malloc_trim(0)
        except Exception:
            pass
        if dbg:
            print(f"[fold] cutoff={cutoff} stage_pairs={_n_stage} "
                  f"left_in={_n_left} pend={pend.shape[0]} "
                  f"left_out={sum(p.shape[0] for p, _ in self._fold_left)} "
                  f"wall={_time.perf_counter() - _t0:.3f}s",
                  file=_sys.stderr)

    def _fold_finalize(self) -> None:
        """Join the in-flight fold, then fold everything left
        (cutoff past any real coordinate)."""
        self._fold_join()
        if self._fold_left_pending:
            self._fold_left.extend(self._fold_left_pending)
            self._fold_left_pending = []
        if self._stage or self._fold_left or \
                self._fold_next_b < self._fold_bx.shape[0]:
            stage = self._stage
            self._stage = []
            self._fold_staged_pairs = 0
            self._fold(int(self.pos_sentinel), stage)

    def _fold_segment_stats(self, seg_tid, seg_start, seg_end
                            ) -> SegmentStats:
        self._fold_finalize()
        lo, hi = he.clamp_segments(self.layout, seg_tid, seg_start,
                                   seg_end)
        bx = self._fold_bx
        il = np.searchsorted(bx, lo)
        ih = np.searchsorted(bx, hi)
        if (il >= bx.shape[0]).any() or (ih >= bx.shape[0]).any() or \
                (bx[np.minimum(il, bx.shape[0] - 1)] != lo).any() or \
                (bx[np.minimum(ih, bx.shape[0] - 1)] != hi).any():
            raise RuntimeError(
                "streaming fold: segment_stats called with boundaries "
                "that were not registered via begin_streaming_fold")
        return SegmentStats(
            cover=self._fold_done_cov[ih] - self._fold_done_cov[il],
            depth_sum=self._fold_done_sum[ih]
            - self._fold_done_sum[il])

    # ----------------------------------------------------------- feeds
    def _dirty(self) -> None:
        if getattr(self, "_feeds_released", False):
            # the staged feeds were dropped when the sorted state was
            # built (they are redundant then — and at 16M events they
            # are ~130 MB of the w100 RSS); a LATE feed after that
            # reconstructs the state as (pos, delta) extras so no
            # event is lost
            pos_s, depth = self._state
            delta = np.diff(depth.astype(np.int64),
                            prepend=np.int64(0)).astype(np.int32)
            self._extra.append((pos_s.astype(self.pos_dtype,
                                             copy=False), delta))
            self._feeds_released = False
        self._state = None
        self._sweep = None

    def add_start_end(self, starts: np.ndarray,
                      ends: np.ndarray) -> None:
        if starts.shape[0] == 0:
            return
        s = starts.astype(self.pos_dtype, copy=False)
        e = ends.astype(self.pos_dtype, copy=False)
        self._stage.append((s, e))
        self._dirty()
        if getattr(self, "_fold_active", False):
            valid = s[s < self.pos_dtype(self.pos_sentinel)]
            if valid.shape[0]:
                m = int(valid.max())
                if m > self._fold_frontier:
                    self._fold_frontier = m
            self._fold_staged_pairs += int(s.shape[0])
            if self._fold_staged_pairs >= self._fold_threshold:
                self._maybe_fold_async()

    add_padded_events = add_start_end

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
        if pos.shape[0] == 0:
            return
        p = np.minimum(pos, self.pos_sentinel).astype(self.pos_dtype,
                                                      copy=False)
        if getattr(self, "_fold_active", False):
            live = p < self.pos_dtype(self.pos_sentinel)
            pv = p[live]
            # checked against the consumer-side scheduled cutoff (the
            # fold thread owns _fold_cutoff)
            if pv.shape[0] and int(pv.min()) < self._fold_sched_cutoff:
                raise RuntimeError(
                    "streaming fold: add_events below the fold "
                    "cutoff; rerun with PANDEPTH_STREAM_FOLD=0")
            self._fold_left_pending.append(
                (pv, np.asarray(delta, np.int32)[live]))
            return
        self._extra.append((p, np.asarray(delta, np.int32)))
        self._dirty()

    def add_batch(self, batch) -> None:
        if batch.n_reads == 0:
            return
        self.n_reads_seen += batch.n_reads
        s, e = he.host_extract_events(batch, self.layout.offsets,
                                      self.layout.limits,
                                      self.flags_mask, self.min_mapq)
        self.add_start_end(s, e)

    def add_encoded_window(self, n: int, dd: np.ndarray,
                           ll: np.ndarray, excd: np.ndarray,
                           excl: np.ndarray, base: int) -> None:
        """Safety valve: wants_encoded_windows is False, but a feed
        that produced compact windows anyway decodes host-side."""
        from pandepth_jax.device.hosteval import decode_enc_host

        s, e = decode_enc_host(dd, ll, excd, excl, base, n)
        self.add_start_end(s, e)

    # run.py warm-up hooks are device-only: nothing to warm here
    def plan_finalize_warmup(self, n_segments: int,
                             want_state: bool) -> None:
        pass

    def maybe_warm_finalize(self, frac: float,
                            pairs_produced: int) -> None:
        pass

    # -------------------------------------------------------- finalize
    def _extras(self):
        if not self._extra:
            return None, None
        return (np.concatenate([p for p, _ in self._extra]),
                np.concatenate([d for _, d in self._extra]))

    def _ensure_state(self):
        if getattr(self, "_fold_active", False):
            if getattr(self, "_fold_engaged", False):
                raise RuntimeError(
                    "streaming fold keeps no global sweep state "
                    "(dense/sorted evals need the plain engine); "
                    "run.py must not elect the fold for this mode")
            self._fold_active = False
        if self._state is None:
            xp, xd = self._extras()
            _, _, self._state = he.finalize_events(
                self._stage, xp, xd, self.pos_sentinel,
                np.zeros(1, np.int64), np.ones(1, np.int64),
                self.min_dep, self.wrap18, keep_state=True)
            # the raw feeds are redundant once the sorted state
            # exists; drop them (at 16M events they are ~130 MB of
            # the mode-6/site RSS). _dirty() reconstructs the state
            # as extras if a late feed ever arrives.
            self._stage = []
            self._extra = []
            self._feeds_released = True
        return self._state

    def _host_sweep(self):
        if self._sweep is None:
            pos_s, depth = self._ensure_state()
            self._sweep = he.derive_integrals(
                pos_s.astype(np.int64, copy=False), depth,
                self.min_dep)
        return self._sweep

    def segment_stats(self, seg_tid: np.ndarray, seg_start: np.ndarray,
                      seg_end: np.ndarray, chunk: int = 1 << 20,
                      keep_state: Optional[bool] = None
                      ) -> SegmentStats:
        if getattr(self, "_fold_active", False):
            if getattr(self, "_fold_engaged", False):
                return self._fold_segment_stats(seg_tid, seg_start,
                                                seg_end)
            # the feed never crossed the fold threshold: deactivate
            # and keep the plain path (native query eval) so
            # normal-scale runs pay nothing for the deep-coverage
            # insurance
            self._fold_active = False
        keep = self.keep_state if keep_state is None else keep_state
        lo, hi = he.clamp_segments(self.layout, seg_tid, seg_start,
                                   seg_end)
        if self._state is not None:
            sweep = self._host_sweep()
            pos_s = sweep[0]
            qc_lo, qs_lo = he.host_q_eval(
                sweep, self.min_dep, lo,
                np.searchsorted(pos_s, lo, side="left"))
            qc_hi, qs_hi = he.host_q_eval(
                sweep, self.min_dep, hi,
                np.searchsorted(pos_s, hi, side="left"))
            return SegmentStats(cover=qc_hi - qc_lo,
                                depth_sum=qs_hi - qs_lo)
        xp, xd = self._extras()
        cover, dsum, state = he.finalize_events(
            self._stage, xp, xd, self.pos_sentinel, lo, hi,
            self.min_dep, self.wrap18, keep_state=keep)
        if keep:
            self._state = state
        return SegmentStats(cover=cover, depth_sum=dsum)

    def segment_stats_sorted_host(self, seg_tid, seg_start, seg_end
                                  ) -> Optional[SegmentStats]:
        if getattr(self, "_fold_active", False) and \
                getattr(self, "_fold_engaged", False):
            return None  # caller falls back to segment_stats
        return he.eval_sorted_host(self.layout, self.min_dep,
                                   self._host_sweep(), seg_tid,
                                   seg_start, seg_end)

    def window_stats_host(self, seg_tid, seg_start, seg_end,
                          win: int) -> Optional[SegmentStats]:
        if getattr(self, "_fold_active", False) and \
                getattr(self, "_fold_engaged", False):
            return None  # caller falls back to segment_stats
        return he.window_grid_host(self.layout, self.min_dep,
                                   self._host_sweep(), seg_tid,
                                   seg_start, seg_end, win)

    def dense_depth(self, tid: int, start0: int = 0,
                    end0: Optional[int] = None) -> np.ndarray:
        lay = self.layout
        if end0 is None:
            end0 = int(lay.lengths[tid])
        pos_s, depth = self._ensure_state()
        return he.dense_from_state(
            pos_s.astype(np.int64, copy=False), depth,
            int(lay.offsets[tid]) + start0,
            int(lay.offsets[tid]) + end0)
