"""End-to-end run orchestration (the reference's ``main`` /
``paf_main`` / ``BamList_main`` engines, src/PanDepth.cpp:3441-5134,
:852-2024, :2029-3410 — implemented once, not cloned per engine).

Dispatch (src/PanDepth.cpp:3452-3480, List_main :3413-3438):
- more than one input file: multi-sample accumulation; ``.paf[.gz]``
  extension on the first file selects the PAF engine;
- single ``.paf[.gz]``: PAF engine;
- otherwise SAM/BAM/CRAM single-file engine.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from pandepth_jax.config import (MODE_CHR, MODE_WIN_BIG,
                                 MODE_WIN_SMALL, RunConfig)
from pandepth_jax.device.layout import GenomeLayout
from pandepth_jax.io.bam import BamHeader, BamReader
from pandepth_jax.io.fasta import gc_count_ranges, load_ref_bases
from pandepth_jax.io.paf import iter_paf_events, paf_contig_table
from pandepth_jax.io.sam_text import SamReader
from pandepth_jax.stats.tables import (aggregate_genes, mode6_window_rows,
                                       output_prefix, table_path,
                                       write_site_depth, write_tables)
from pandepth_jax.targets.model import TargetSet
from pandepth_jax.targets.parse import parse_targets
from pandepth_jax.targets.windows import synthesize_default_targets
from pandepth_jax.utils.log import RunStats, maybe_profile, phase, \
    set_verbose, verbose


def _strip_gz(path: str) -> str:
    return path[:-3] if path.endswith(".gz") else path


def _ext(path: str) -> str:
    base = os.path.basename(path)
    return base.rsplit(".", 1)[1] if "." in base else ""


def is_paf(path: str) -> bool:
    return _ext(_strip_gz(path)).lower() == "paf"


def open_alignment(path: str, threads: int = 0):
    """Sniff BAM (BGZF) vs SAM text vs CRAM and return a reader with a
    ``.header`` and ``.batches()``. BAM prefers the native C++ decoder
    (libpancov_io) and falls back to the pure Python one."""
    with open(path, "rb") as fh:
        magic = fh.read(4)
    if magic[:4] == b"CRAM":
        from pandepth_jax.io.cram import CramReader
        return CramReader(path)
    if magic[:2] == b"\x1f\x8b":
        # could be BAM-in-BGZF or gzipped SAM; readers sniff content
        try:
            from pandepth_jax.io.native import (NativeBamReader,
                                                load_library)
            if load_library() is not None:
                return NativeBamReader(path, threads=threads)
        except (ValueError, RuntimeError, OSError):
            pass
        try:
            return BamReader(path)
        except ValueError as e:
            # only fall back to gzipped SAM text when the stream is NOT
            # a BAM; a malformed BAM (bad header/record) is a hard error
            if "bad magic" not in str(e):
                raise
            return SamReader(path)
    return SamReader(path)


def index_present(path: str) -> bool:
    return any(os.path.exists(path + suf)
               for suf in (".bai", ".csi", ".crai"))


def _want_host_finalize() -> bool:
    """Host-engine election: ``PANDEPTH_HOST_FINALIZE=1`` runs the
    jax-free HostCoverageEngine — the path for machines without an
    accelerator, and the reference the device engines are checked
    against. Sharded and jax.distributed runs always keep the device
    engines. Decided from env ONLY, so the launcher can route before
    jax initializes."""
    if os.environ.get("PANDEPTH_SHARDED") not in (None, "0"):
        return False
    if os.environ.get("PANDEPTH_MULTIHOST") == "1":
        return False  # set by sharding/launch.py before run()
    return os.environ.get("PANDEPTH_HOST_FINALIZE") == "1"


def make_engine(layout, **kw):
    """Production engine selection: the host engine when elected (see
    _want_host_finalize), the multihost exchange engine in a
    jax.distributed job, the genome-range-sharded engine whenever the
    process sees more than one device (the device analog of the
    reference's chromosome-group thread scheduler,
    src/PanDepth.cpp:4151-4260), the single-device engine otherwise.
    ``PANDEPTH_SHARDED=0/1`` forces the single/sharded choice. With
    ``-v`` the choice is logged as ``INFO: engine=... device=...``."""
    if _want_host_finalize():
        from pandepth_jax.device.host_engine import HostCoverageEngine

        # elected on EVERY coordinate tier: genomes <= 4 Gb ride the
        # native 32-bit radix-sort kernel directly; larger layouts
        # (int64 positions — wheat-scale pangenomes) keep the SAME
        # native kernel via 2 Gb coordinate slabs with carry-chained
        # integrals (hosteval._finalize_events_slabbed); the numpy
        # argsort twin remains only as the no-native-library fallback
        # (tests/test_uint32_tier.py pins all three paths)
        engine = HostCoverageEngine(layout, **kw)
        device = "host"
    else:
        from pandepth_jax import boot

        jax = boot.configure_jax()
        force = os.environ.get("PANDEPTH_SHARDED")
        devices = jax.devices()
        if force != "0" and jax.process_count() > 1:
            from pandepth_jax.sharding.multihost import \
                MultihostCoverageEngine

            engine = MultihostCoverageEngine(layout, **kw)
        elif force == "1" or (force != "0" and len(devices) > 1):
            from pandepth_jax.sharding.engine import \
                ShardedCoverageEngine

            engine = ShardedCoverageEngine(layout, **kw)
        else:
            from pandepth_jax.device.engine import CoverageEngine

            engine = CoverageEngine(layout, **kw)
        device = (f"{devices[0].platform}:{devices[0].device_kind}"
                  f" x{len(devices)}")
    if verbose():
        print(f"INFO: engine={type(engine).__name__} device={device}",
              file=sys.stderr)
    return engine


def run(config: RunConfig) -> int:
    if not config.inputs or not config.out_prefix:
        print("Error: lack argument -i or -o ", file=sys.stderr)
        return 1
    if config.verbose:
        set_verbose(True)
    if len(config.inputs) > 1:
        print("INFO: Run multi-file data ")
        if is_paf(config.inputs[0]):
            return run_paf(config)
        return run_alignment(config)
    if is_paf(config.inputs[0]):
        print("INFO: Run paf Format data ")
        return run_paf(config)
    return run_alignment(config)


# ----------------------------------------------------------------------
def _prepare_targets(config: RunConfig, names: List[str],
                     lengths: np.ndarray, chr2tid: Dict[str, int],
                     ref_bases) -> Tuple[int, TargetSet]:
    mode = config.mode
    targets: Optional[TargetSet] = None
    if mode != MODE_CHR and config.target_file:
        targets = parse_targets(config.target_file, mode, chr2tid,
                                feature=config.feature_type,
                                ref_bases=ref_bases)
    if targets is None or targets.n_genes == 0:
        # reference falls back to default tiling whenever the merged
        # region map is empty (src/PanDepth.cpp:3975-4051)
        mode, targets = synthesize_default_targets(
            names, lengths, config.win_size, ref_bases)
    return mode, targets


def _is_writer_rank(engine=None) -> bool:
    """Multihost runs compute identical replicated tables on every
    process (the collectives require all ranks); only rank 0 writes.
    Runs whose engine never initialized jax (host engine) are
    trivially the writer — asking jax.process_index() would force a
    backend init at WRITE time. boot.init_started() tracks our own
    init; ``engine.jax_free`` covers the warm-daemon case where the
    daemon started the background init but THIS run rides the host
    sweep."""
    from pandepth_jax import boot

    if getattr(engine, "jax_free", False) and \
            os.environ.get("PANDEPTH_MULTIHOST") != "1":
        return True
    if os.environ.get("PANDEPTH_MULTIHOST") != "1" and \
            not boot.init_started():
        return True
    try:
        jax = boot.configure_jax()
        return jax.process_index() == 0
    except Exception:
        return True


def _finalize_and_write(config: RunConfig, engine: CoverageEngine,
                        mode: int, targets: TargetSet, names: List[str],
                        lengths: np.ndarray, gc_cols: bool,
                        ref_bases, stats: Optional[RunStats] = None
                        ) -> None:
    prefix = output_prefix(config.out_prefix)
    # single-query modes skip shipping the sweep state back from the
    # device; -a (dense dump) and mode 6 (second stats pass) need it
    if hasattr(engine, "keep_state"):
        engine.keep_state = bool(config.site_output) \
            or mode == MODE_WIN_SMALL
    with phase(stats, "segstats"):
        seg_tid = targets.gene_tid[targets.seg_gene]
        seg = None
        if targets.gene_id is None and targets.n_segments > (1 << 20) \
                and hasattr(engine, "window_stats_host"):
            # synthesized tilings (chr / win modes) are regular grids;
            # at genome scale (e.g. -w 150 on 3 Gb = 20M windows) the
            # O(E+W) host grid eval replaces ~20 chunked device
            # dispatches and ~320 MB of boundary uploads.
            # window_stats_host validates the grid and returns None if
            # it doesn't match.
            from pandepth_jax.targets.windows import MEM_BIN_WINDOWS

            grid_w = config.win_size if mode == MODE_WIN_BIG \
                else MEM_BIN_WINDOWS
            seg = engine.window_stats_host(
                seg_tid, np.asarray(targets.seg_start),
                np.asarray(targets.seg_end), grid_w)
        if seg is None:
            seg = engine.segment_stats(seg_tid,
                                       np.asarray(targets.seg_start),
                                       np.asarray(targets.seg_end))
        gene_cover, gene_dsum = aggregate_genes(targets, seg.cover,
                                                seg.depth_sum)

    win6_rows = None
    win6_done = False
    if mode == MODE_WIN_SMALL:
        def stats_fn(seg_tid, s, e):
            # the regular tiling evaluates as piece-scatter + cumsum
            # (O(E+W), no per-window gathers); irregular batches fall
            # back to the sorted-boundary host eval, then the device
            st = None
            if hasattr(engine, "window_stats_host"):
                st = engine.window_stats_host(seg_tid, s, e,
                                              config.win_size)
            if st is None and hasattr(engine,
                                      "segment_stats_sorted_host"):
                st = engine.segment_stats_sorted_host(seg_tid, s, e)
            if st is None:
                st = engine.segment_stats(seg_tid, s, e)
            return st.cover, st.depth_sum

        gc_fn = None
        if gc_cols and not config.quirk_mode6_gc_zero:
            def gc_fn(tid, s, e):
                seq = (ref_bases or {}).get(int(tid), b"")
                return gc_count_ranges(seq, s, e)
        with phase(stats, "win6"):
            # per-contig streaming writer: never holds the whole
            # genome tiling (~30 M rows at -w 100 on 3 Gb was the
            # config's dominant RSS); falls back to the one-shot rows
            # when the native formatter is unavailable
            from pandepth_jax.stats.tables import write_win6_streaming

            win6_done = write_win6_streaming(
                table_path(prefix, mode), gc_cols, names, lengths,
                targets.tids_with_regions(), config.win_size,
                stats_fn, gc_fn, is_writer=_is_writer_rank(engine))
            if not win6_done:
                win6_rows = mode6_window_rows(
                    names, lengths, targets.tids_with_regions(),
                    config.win_size, stats_fn, gc_fn)

    if config.site_output and hasattr(engine, "write_site_depth"):
        # multihost site dump: range-sharded collective write — every
        # rank participates (ends in a barrier), so it runs before the
        # writer-rank gate
        with phase(stats, "write"):
            engine.write_site_depth(prefix + ".SiteDepth.gz", names,
                                    lengths, targets.tids_with_regions())
    if not _is_writer_rank(engine):
        return
    with phase(stats, "write"):
        if not win6_done:
            write_tables(table_path(prefix, mode), mode, gc_cols,
                         names, targets, gene_cover, gene_dsum,
                         win6_rows)

        if config.site_output and not hasattr(engine,
                                              "write_site_depth"):
            write_site_depth(prefix + ".SiteDepth.gz", names, lengths,
                             targets.tids_with_regions(),
                             engine.dense_depth)


def _try_native_load(path: str, config: RunConfig,
                     ext_offsets=None, ext_limits=None, regions=None):
    """Native load when the file is BAM and the library builds.

    Targeted runs with an index use the one-shot block-skipping loader
    (only target-overlapping BGZF blocks are inflated). Everything
    else uses the bounded-memory streaming loader: windows of the file
    are inflated and walked behind a producer thread while the engine
    uploads the previous window's events (``PANDEPTH_STREAM=0`` forces
    the round-1 whole-file loader)."""
    try:
        with open(path, "rb") as fh:
            magic = fh.read(4)
    except OSError:
        raise
    if magic[:2] != b"\x1f\x8b":
        return None
    try:
        from pandepth_jax.io.native import (NativeBamLoad,
                                            NativeBamStream,
                                            load_library)
        if load_library() is None:
            return None
        use_stream = os.environ.get("PANDEPTH_STREAM", "1") != "0"
        vranges = None
        if regions is not None and regions[3] == 1:
            from pandepth_jax.io.bamindex import (chunks_for_windows,
                                                  load_index_for)
            idx = load_index_for(path)
            if idx is not None:
                # index-driven block skipping: decompress only the
                # BGZF blocks whose records can overlap the windows
                vranges = chunks_for_windows(idx, regions)
            if vranges is not None and use_stream:
                # ranged streaming: block skipping with bounded
                # memory — the producer seeks between merged chunk
                # ranges instead of one-shot-loading them all
                return NativeBamStream(path, config.flags,
                                       config.min_mapq,
                                       threads=config.threads,
                                       ext_offsets=ext_offsets,
                                       ext_limits=ext_limits,
                                       regions=regions,
                                       vranges=vranges)
        elif regions is None and not use_stream:
            from pandepth_jax.io.bamindex import (full_file_splits,
                                                  load_index_for)
            idx = load_index_for(path)
            if idx is not None:
                # no target restriction: split the stream at known
                # record boundaries for a parallel full-file walk
                vranges = full_file_splits(
                    idx, max(config.threads, os.cpu_count() or 1))
                if vranges.shape[0] <= 1:
                    vranges = None
        if vranges is not None:
            return NativeBamLoad(path, config.flags, config.min_mapq,
                                 threads=config.threads,
                                 ext_offsets=ext_offsets,
                                 ext_limits=ext_limits,
                                 regions=regions, vranges=vranges)
        if use_stream:
            return NativeBamStream(path, config.flags,
                                   config.min_mapq,
                                   threads=config.threads,
                                   ext_offsets=ext_offsets,
                                   ext_limits=ext_limits,
                                   regions=regions)
        return NativeBamLoad(path, config.flags, config.min_mapq,
                             threads=config.threads,
                             ext_offsets=ext_offsets,
                             ext_limits=ext_limits, regions=regions)
    except (ValueError, RuntimeError, OSError):
        return None


def _enc_caps() -> Tuple[int, int]:
    """The encoded-window buffer sizes (must agree with
    CoverageEngine.enc_cap/enc_exc — both read the same env vars)."""
    return (int(os.environ.get("PANDEPTH_ENC_CAP", 1 << 19)),
            int(os.environ.get("PANDEPTH_ENC_EXC", 1 << 13)))


class _EncPuller:
    """Stateful encoded-window puller over a NativeBamStream: owns the
    u8 -> u16 code-tier upgrade so windows can be pulled BEFORE the
    device engine exists (pre-engine stash while jax initializes in
    the background, boot.py) and the remainder streamed after."""

    def __init__(self, r, cap: int, exc: int):
        self.r, self.cap, self.exc = r, cap, exc
        self._take = r.take_enc_acc
        self._on_u8 = True
        self.eof = False

    def next(self):
        """One (n, dd, ll, excd, excl, base) window, or None at EOF."""
        win = self._take(self.cap, self.exc)
        if win is None:
            self.eof = True
            return None
        if self._on_u8 and win[0] < self.cap \
                and (self.r.last_nd >= self.exc
                     or self.r.last_nl >= self.exc):
            # short buffer through escape saturation: the input is
            # sparser than 8-bit zigzag covers — upgrade the rest of
            # the feed to 16-bit codes (4 B/pair). (Track the tier
            # with a flag: bound-method identity is useless —
            # `take is r.take_enc_acc` is always False.)
            self._take = self.r.take_enc_acc16
            self._on_u8 = False
        return win


def _feed_stream(engine, r, puller: Optional[_EncPuller] = None,
                 stash=()) -> None:
    """Pull event windows from a NativeBamStream into the engine.

    The compact-encoded path (engine.wants_encoded_windows) ships
    ~2 B/event and uploads each window asynchronously while the
    producer decodes the next one — by finalize time the events are
    already device-resident. A window that stalls the encoder
    (escape-list overflow, e.g. an unsorted BAM) drains through the
    raw take32 path instead.

    ``puller``/``stash`` carry windows pulled before the engine
    existed (run_alignment's pre-engine overlap with the background
    jax init)."""
    if getattr(engine, "wants_encoded_windows", False) and \
            hasattr(r, "take_enc_acc"):
        for win in stash:
            engine.add_encoded_window(*win)
        p = puller if puller is not None else \
            _EncPuller(r, engine.enc_cap, engine.enc_exc)
        can_warm = hasattr(engine, "maybe_warm_finalize") and \
            hasattr(r, "progress")
        while not p.eof:
            win = p.next()
            if win is not None:
                engine.add_encoded_window(*win)
                if can_warm:
                    engine.maybe_warm_finalize(*r.progress())
        engine.n_reads_seen += r.n_records
        r.close()
        return
    if puller is not None or stash:
        # windows were already pulled through the encoder but this
        # engine has no encoded-window path (e.g. the sharded engine):
        # host-decode them — mixing take_enc_acc with take32 on one
        # stream would lose the encoder's accumulated pairs
        from pandepth_jax.device.hosteval import decode_enc_host

        p = puller if puller is not None else _EncPuller(r, *_enc_caps())
        for win in stash:
            n, dd, ll, excd, excl, base = win
            engine.add_start_end(*decode_enc_host(dd, ll, excd, excl,
                                                  base, n))
        while not p.eof:
            win = p.next()
            if win is not None:
                n, dd, ll, excd, excl, base = win
                engine.add_start_end(*decode_enc_host(dd, ll, excd,
                                                      excl, base, n))
        engine.n_reads_seen += r.n_records
        r.close()
        return
    while True:
        n = r.wait()
        if n < 0:
            break
        if engine.pos_bits32:
            s32, e32 = r.take32(max(n, 1), engine.pos_sentinel32)
            engine.add_padded_events(s32.view(engine.pos_dtype),
                                     e32.view(engine.pos_dtype))
        else:
            s, e = r.take64(n)
            engine.add_start_end(s, e)
    engine.n_reads_seen += r.n_records
    r.close()


def _cheap_header(path: str) -> Optional[BamHeader]:
    """Header without decoding the file body (BAM only)."""
    import struct
    import zlib

    try:
        with open(path, "rb") as fh:
            magic = fh.read(2)
        if magic != b"\x1f\x8b":
            return None
        from pandepth_jax.io.bam import read_bam_header

        return read_bam_header(path)
    except OSError:
        raise
    except (ValueError, struct.error, zlib.error, IndexError):
        return None


def _filter_batch_to_windows(batch, windows) -> None:
    """Python-path equivalent of the C++ mode-1 region restriction:
    drop reads not overlapping any fetch window (marks tid = -1)."""
    off, starts, ends = windows[:3]
    if starts.shape[0] == 0:
        batch.tid[:] = -1
        return
    pos = batch.pos.astype(np.int64)
    end = batch.end_pos()
    keep = np.zeros(batch.tid.shape[0], bool)
    for tid in np.unique(batch.tid):
        if tid < 0 or tid + 1 >= off.shape[0]:
            continue
        a, b = int(off[tid]), int(off[tid + 1])
        if a == b:
            continue
        sel = batch.tid == tid
        idx = np.searchsorted(starts[a:b], end[sel] - 1, side="right")
        ok = idx > 0
        cand = np.maximum(idx - 1, 0)
        ok &= ends[a:b][cand] > pos[sel]
        keep[sel] = ok
    batch.tid[~keep] = -1


def _intervals_in_windows(tid: np.ndarray, read_lo: np.ndarray,
                          read_hi: np.ndarray, windows) -> np.ndarray:
    """Mode-1 fetch filter on whole-read spans (the per-run twin of
    _filter_batch_to_windows): keep runs whose READ overlaps any fetch
    window of its contig."""
    off, starts, ends = windows[:3]
    keep = np.zeros(tid.shape[0], bool)
    if starts.shape[0] == 0:
        return keep
    for t in np.unique(tid):
        if t < 0 or t + 1 >= off.shape[0]:
            continue
        a, b = int(off[t]), int(off[t + 1])
        if a == b:
            continue
        sel = tid == t
        idx = np.searchsorted(starts[a:b], read_hi[sel] - 1,
                              side="right")
        ok = idx > 0
        cand = np.maximum(idx - 1, 0)
        ok &= ends[a:b][cand] > read_lo[sel]
        keep[sel] = ok
    return keep


class _RegionCursor:
    """Python-path equivalent of the C++ mode-2 sorted-stream cursor
    (reference no-index loop, src/PanDepth.cpp:4604-4671), including
    its quirks: the chromosome-finishing read is counted, and a read
    landing in a gap after a cursor advance is counted too. Filters are
    assumed already applied (FLAG/MAPQ).

    Vectorized: within a coordinate-sorted stream the cursor is
    monotone in position, so each read's effective region is one
    ``searchsorted`` over the tid's region ends; only the
    chromosome-finishing events (at most one per tid per batch) need
    sequencing, to replicate the reference's break-out-of-the-loop
    behavior when the LAST pending chromosome finishes."""

    def __init__(self, regions):
        self.off, self.s1, self.e1 = (np.asarray(a, np.int64)
                                      for a in regions[:3])
        self.cursor = self.off[:-1].copy()
        self.done = self.off[:-1] == self.off[1:]
        self.chrs_left = int((~self.done).sum())
        self.stream_done = False

    def filter_batch(self, batch, flags_mask: int,
                     min_mapq: int) -> None:
        n = batch.tid.shape[0]
        if n == 0:
            return
        if self.stream_done:
            batch.tid[:] = -1
            return
        end = batch.end_pos().astype(np.int64)
        pos0 = batch.pos.astype(np.int64)
        tid = batch.tid
        n_chr = self.done.shape[0]

        active = (batch.flag & flags_mask) == 0
        if min_mapq >= 1:
            active &= batch.mapq >= min_mapq
        valid = (tid >= 0) & (tid < n_chr)
        drop = np.zeros(n, bool)
        drop |= ~valid
        cutoff = n  # batch index where stream_done fired, if any

        finishes = []  # (batch_index, tid)
        for t in np.unique(tid[valid]):
            if self.done[t]:
                drop |= tid == t
                continue
            a, b = int(self.off[t]), int(self.off[t + 1])
            sel = np.nonzero((tid == t) & active)[0]
            if sel.shape[0] == 0:
                continue
            # cursor after each read = first region whose end >= pos
            # (monotone in a sorted stream; filtered reads don't move
            # it, and they're excluded from `sel`)
            c = np.searchsorted(self.e1[a:b], pos0[sel], side="left")
            fin = c >= (b - a)       # advanced past the last region
            cc = np.minimum(c, b - a - 1) + a
            # a read that ADVANCED the cursor is kept even when it
            # lands in the gap before its new region (the reference
            # falls through without re-checking, quirk); only
            # non-advancing reads are dropped for ending before the
            # current region's start
            prev_c = np.empty(cc.shape[0], np.int64)
            prev_c[0] = self.cursor[t]
            prev_c[1:] = cc[:-1]
            drop_t = (end[sel] < self.s1[cc]) & ~fin & (cc == prev_c)
            drop[sel[drop_t]] = True
            self.cursor[t] = cc[-1]
            if fin.any():
                k = int(sel[np.argmax(fin)])
                finishes.append((k, int(t)))
                # reads after the finisher on a done chromosome drop
                later = sel[sel > k]
                drop[later] = True

        # sequence chromosome-finishing events in stream order; the
        # read finishing the LAST pending chromosome is itself dropped
        # (the reference breaks out of its loop) and ends the stream
        for k, t in sorted(finishes):
            if k >= cutoff:
                break
            self.done[t] = True
            self.chrs_left -= 1
            if self.chrs_left == 0:
                self.stream_done = True
                drop[k] = True
                cutoff = k
                break
        if cutoff < n:
            drop[cutoff + 1:] = True
        batch.tid[drop] = -1


def _run_site_split(config: RunConfig, header: BamHeader, mode: int,
                    targets: TargetSet, names: List[str],
                    lengths: np.ndarray, gc_cols: bool,
                    stats: RunStats) -> int:
    """Deep-coverage ``-a`` and deep multi-sample ``.list``: one
    ranged pass PER CONTIG.

    The one-shot paths hold O(events) — the site dump until the dense
    write, the pooled multi-file accumulation until its single stats
    pass (the streaming fold cannot apply there: pooled depth is the
    SUM across files, so no boundary is final until every file has
    contributed, and the indicator depth>=minDep is non-linear in the
    sum). At deep coverage that overtakes the reference's flat
    per-base arrays (src/PanDepth.cpp:4129-4145, multi-file
    :2687-2699). Indexed inputs let each contig be processed to
    COMPLETION independently instead: BAI-ranged streaming feeds of
    just that contig from EVERY input (first-file contig space, quirk
    Q5), pooled into one engine, its segment stats (+ dense SiteDepth
    rows with ``-a``) emitted, everything freed before the next
    contig — memory O(max contig pooled events), total IO still one
    pass over each file (the ranges tile them). Elected by
    run_alignment past PANDEPTH_SITE_SPLIT_BYTES of total compressed
    input (PANDEPTH_SITE_SPLIT=1/0 forces). Output decompresses
    byte-identically to the one-shot paths (same 64 Mb member
    framing, same stats; tests/test_site_split.py pins it against
    both the reference and our one-shot writer)."""
    from pandepth_jax.device.host_engine import HostCoverageEngine

    layout = GenomeLayout(lengths)
    prefix = output_prefix(config.out_prefix)
    site_path = prefix + ".SiteDepth.gz"
    seg_tid = targets.gene_tid[targets.seg_gene]
    seg_start = np.asarray(targets.seg_start)
    seg_end = np.asarray(targets.seg_end)
    cover = np.zeros(seg_tid.shape[0], np.int64)
    dsum = np.zeros(seg_tid.shape[0], np.int64)
    region_tids = targets.tids_with_regions()
    region_set = set(int(t) for t in region_tids)
    woff, wstart, wend = targets.fetch_windows(lengths)

    native_write = None
    try:
        from pandepth_jax.io.native import load_library

        lib = load_library()
        if lib is not None:
            native_write = lib.pancov_site_depth_write
    except Exception:
        pass

    wrote = False
    if config.site_output:
        open(site_path, "wb").close()
    n = len(names)
    for tid in range(n):
        if tid not in region_set:
            continue
        # this contig's fetch windows as a full-shaped regions tuple
        a, b = int(woff[tid]), int(woff[tid + 1])
        sub_off = np.zeros(n + 1, np.int64)
        sub_off[tid + 1:] = b - a
        regs = (sub_off, wstart[a:b], wend[a:b], 1)
        engine = HostCoverageEngine(layout,
                                    flags_mask=config.flags,
                                    min_mapq=config.min_mapq,
                                    min_dep=config.min_depth,
                                    wrap18=True)
        with phase(stats, "feed"):
            for i, path in enumerate(config.inputs):
                # later files ride the FIRST file's contig space
                # (quirk Q5), exactly like the one-shot multi loop
                r = _try_native_load(
                    path, config,
                    ext_offsets=None if i == 0 else layout.offsets,
                    ext_limits=None if i == 0 else layout.limits,
                    regions=regs)
                if r is None:
                    raise RuntimeError(
                        "split pass needs the native ranged loader")
                _feed_stream(engine, r)
        stats.reads_seen += engine.n_reads_seen
        with phase(stats, "segstats"):
            m = seg_tid == tid
            # the sorted state is only needed for the dense -a rows;
            # a stats-only pass skips the O(contig events) state
            # round-trip entirely
            engine.keep_state = bool(config.site_output)
            st = engine.segment_stats(seg_tid[m], seg_start[m],
                                      seg_end[m])
            cover[m] = st.cover
            dsum[m] = st.depth_sum
        if not config.site_output:
            del engine
            continue
        with phase(stats, "write"):
            if native_write is not None:
                # same 64 Mb-member framing + writer pool as the
                # one-shot write_site_depth (members concatenate
                # byte-identically); each job expands only its slice
                from pandepth_jax.stats.tables import _run_member_jobs

                ln = int(lengths[tid])
                chunk_bp = 64 << 20
                jobs = []
                for lo in range(0, max(ln, 1), chunk_bp):
                    hi = min(lo + chunk_bp, ln)

                    def job(p, eng=engine, tid=tid, lo=lo, hi=hi):
                        d = np.ascontiguousarray(
                            eng.dense_depth(tid, lo, hi), np.int32)
                        return native_write(p.encode(),
                                            names[tid].encode(),
                                            lo, d, d.shape[0], 0)

                    jobs.append(job)
                _run_member_jobs(site_path, jobs,
                                 workers=min(4, os.cpu_count() or 1))
            else:
                import gzip as _gz

                d = np.ascontiguousarray(engine.dense_depth(tid),
                                         np.int32)
                with _gz.open(site_path, "at" if wrote else "wt",
                              compresslevel=1) as out:
                    nm = names[tid]
                    for k, v in enumerate(d.tolist()):
                        out.write(f"{nm}\t{k}\t{v}\n")
                del d
            wrote = True
        del engine
        # release this contig's freed pages: with M_TRIM/M_MMAP pinned
        # at 1 GB (boot.disable_thp) the per-pass buffers otherwise
        # accumulate as retained heap across contigs (measured 8.8 GB
        # at the 400M-read .list row before trimming)
        try:
            import ctypes

            ctypes.CDLL(None).malloc_trim(0)
        except Exception:
            pass

    if config.site_output and not wrote:
        # parity with the one-shot writer: an empty dump is still a
        # valid (empty) gzip member, not a 0-byte file
        from pandepth_jax.io.text import GzTextWriter

        with GzTextWriter(site_path):
            pass
    print("INFO: Input data read done")
    with phase(stats, "write"):
        gene_cover, gene_dsum = aggregate_genes(targets, cover, dsum)
        write_tables(table_path(prefix, mode), mode, gc_cols, names,
                     targets, gene_cover, gene_dsum, None)
    stats.emit()
    return 0


def run_alignment(config: RunConfig) -> int:
    stats = RunStats()
    header: Optional[BamHeader] = _cheap_header(config.inputs[0])
    reader = None
    if header is None:
        # SAM text / CRAM / no native library: open fully
        with phase(stats, "open"):
            reader = open_alignment(config.inputs[0],
                                    threads=config.threads)
        header = reader.header
    names, lengths = header.names, header.lengths
    chr2tid = header.name_to_tid()

    ref_bases = None
    gc_cols = False
    if config.gc:
        if not config.reference:
            print("Error: lack reference sequence (-r) for GC parse",
                  file=sys.stderr)
            return 1
        ref_bases = load_ref_bases(config.reference, chr2tid)
        gc_cols = True

    with phase(stats, "targets"):
        mode, targets = _prepare_targets(config, names, lengths,
                                         chr2tid, ref_bases)

    # the reference's SiteInfo whole-genome arrays wrap depth at 18 bits
    # (quirk Q1); they are used when dumping sites, in small-window mode,
    # without a usable index, and in multi-file mode
    has_index = index_present(config.inputs[0]) and config.use_index
    wrap18 = (config.site_output or mode == MODE_WIN_SMALL
              or not has_index or len(config.inputs) > 1)

    # deep-coverage -a / deep multi-sample .list: past
    # PANDEPTH_SITE_SPLIT_BYTES of total compressed input, process one
    # contig per BAI-ranged pass (pooled across every input) so memory
    # is O(max contig pooled events) instead of O(total events) — the
    # reference stays flat O(genome) there (src/PanDepth.cpp:4129-4145,
    # :2687-2699); this keeps us bounded too. PANDEPTH_SITE_SPLIT=1/0
    # forces.
    if ((config.site_output or len(config.inputs) > 1)
            and reader is None and config.use_index
            and all(index_present(p) for p in config.inputs)
            and mode not in (MODE_WIN_BIG, MODE_WIN_SMALL)
            and _want_host_finalize()):
        force = os.environ.get("PANDEPTH_SITE_SPLIT")
        split_bytes = int(os.environ.get(
            "PANDEPTH_SITE_SPLIT_BYTES", 1 << 30))
        try:
            big = sum(os.path.getsize(p)
                      for p in config.inputs) >= split_bytes
        except OSError:
            big = False
        native_ok = False
        if force == "1" or (force is None and big):
            try:
                from pandepth_jax.io.native import load_library

                native_ok = load_library() is not None
            except Exception:
                native_ok = False
        if native_ok:
            return _run_site_split(config, header, mode, targets,
                                   names, lengths, gc_cols, stats)

    # which reads actually count depends on the reference's per-file
    # path: indexed -> region-fetch overlap (mode 1); no index but
    # coordinate-sorted -> stateful region cursor (mode 2); unsorted ->
    # every read. Only parsed-target modes are observable.
    fetch_win = cursor_reg = None
    if mode in (1, 2, 3, 4):
        fetch_win = (*targets.fetch_windows(lengths), 1)
        cursor_reg = (*targets.merged_spans(len(names)), 2)

    def regions_for(path: str, hdr: Optional[BamHeader]):
        if fetch_win is None:
            return None
        if index_present(path) and config.use_index:
            return fetch_win
        if hdr is not None and hdr.sort_order == "coordinate":
            return cursor_reg
        return None

    # start the first file's native loader BEFORE the engine exists:
    # make_engine blocks on the (possibly background, see boot.py) jax
    # init, and the loader's C++ producer threads inflate ahead of it
    # without holding the GIL
    r0 = None
    if reader is None:
        r0 = _try_native_load(config.inputs[0], config,
                              regions=regions_for(config.inputs[0],
                                                  header))

    # while the background jax init runs (boot.py), pull encoded event
    # windows into a host stash so the decode pipeline never idles
    # behind make_engine; bounded (the stash is ~2 MB/window) so a
    # huge file can't undo the loader's flat-RSS guarantee
    puller0 = None
    stash0: List[tuple] = []
    # the engine doesn't exist yet (jax is still initializing in the
    # background): pull encoded windows only when the engine will want
    # them — an engine without the encoded path (the sharded one)
    # still drains them correctly through decode_enc_host
    from pandepth_jax.device.hosteval import wants_encoded_windows

    enc_hint = wants_encoded_windows()
    if r0 is not None and hasattr(r0, "take_enc_acc") and enc_hint:
        from pandepth_jax import boot

        if boot.init_started() and not boot.is_ready():
            puller0 = _EncPuller(r0, *_enc_caps())
            while len(stash0) < 64 and not puller0.eof \
                    and not boot.is_ready():
                win = puller0.next()
                if win is not None:
                    stash0.append(win)

    engine = make_engine(GenomeLayout(lengths),
                         flags_mask=config.flags,
                         min_mapq=config.min_mapq,
                         min_dep=config.min_depth, wrap18=wrap18)

    # arm the finalize-program warm-up: the fused finalize's shape
    # signature is (query pad, encoded-block counts); the query side
    # is already known here and the block side becomes predictable
    # from feed progress (engine.maybe_warm_finalize below), letting
    # the ~2 s first-dispatch program load overlap the feed. Single
    # input only: multi-file feeds accumulate across files so one
    # file's progress predicts nothing. Skip the synthesized-grid
    # genome-scale case _finalize_and_write routes to the host eval.
    if len(config.inputs) == 1 and \
            hasattr(engine, "plan_finalize_warmup") and \
            not (targets.gene_id is None
                 and targets.n_segments > (1 << 20)):
        engine.plan_finalize_warmup(
            targets.n_segments,
            want_state=bool(config.site_output)
            or mode == MODE_WIN_SMALL)

    # bounded-memory deep coverage: a coordinate-sorted single-file
    # feed lets the host engine fold staged events incrementally into
    # running prefix integrals at the (already known) query
    # boundaries, capping one-shot RSS regardless of read count — the
    # sweep-engine analog of the reference's flat 10 Mb windowed scan
    # (src/PanDepth.cpp:676-679). Excluded: site dumps and mode 6
    # (need the full sweep state), genome-scale synthesized grids
    # (window_grid_host path), multi-file accumulation (each file
    # restarts the coordinate frontier). PANDEPTH_STREAM_FOLD=0
    # disables.
    if (len(config.inputs) == 1
            and hasattr(engine, "begin_streaming_fold")
            and not config.site_output and mode != MODE_WIN_SMALL
            and not (targets.gene_id is None
                     and targets.n_segments > (1 << 20))
            and os.environ.get("PANDEPTH_STREAM_FOLD", "1") != "0"
            and (has_index or header.sort_order == "coordinate")):
        engine.begin_streaming_fold(
            targets.gene_tid[targets.seg_gene],
            np.asarray(targets.seg_start),
            np.asarray(targets.seg_end))

    n_targets = len(names)
    for i, path in enumerate(config.inputs):
      with phase(stats, "feed"):
        hdr_i = header if i == 0 else _cheap_header(path)
        if i == 0 and reader is None:
            r = r0
            if r is None:
                r = open_alignment(path, threads=config.threads)
        elif i == 0:
            r = reader
        else:
            # multi-sample mode indexes the FIRST file's contig space
            # (quirk Q5): impose its layout on every later file
            r = _try_native_load(path, config,
                                 ext_offsets=engine.layout.offsets,
                                 ext_limits=engine.layout.limits,
                                 regions=regions_for(path, hdr_i))
            if r is None:
                r = open_alignment(path, threads=config.threads)
        if hasattr(r, "wait") and hasattr(r, "take32"):
            if r is r0:
                _feed_stream(engine, r, puller=puller0, stash=stash0)
            else:
                _feed_stream(engine, r)
            continue
        if hasattr(r, "events"):
            if engine.wants_padded_events and \
                    engine.pos_bits32 and \
                    hasattr(r, "events32_padded"):
                s32, e32, _m = r.events32_padded(
                    max(r.n_events, 1), engine.pos_sentinel32)
                engine.add_padded_events(s32.view(engine.pos_dtype),
                                         e32.view(engine.pos_dtype))
            else:
                starts, ends = r.events()
                engine.add_start_end(starts, ends)
            engine.n_reads_seen += r.n_records
            r.close()
            continue
        regs = regions_for(path, getattr(r, "header", hdr_i))
        from pandepth_jax.io.sam_text import SamReader as _SR

        if regs is None and isinstance(r, _SR):
            # native SAM text parse straight to events
            try:
                from pandepth_jax.io.native import (NativePafLoad,
                                                    load_library)
                if load_library() is not None:
                    sl = NativePafLoad(path, config.flags,
                                       config.min_mapq, names,
                                       engine.layout.offsets,
                                       engine.layout.limits,
                                       kind="sam")
                    if engine.wants_padded_events and \
                            engine.pos_bits32:
                        s32, e32 = sl.events32_padded(
                            max(sl.n_events, 1),
                            engine.pos_sentinel32)
                        engine.add_padded_events(
                            s32.view(engine.pos_dtype),
                            e32.view(engine.pos_dtype))
                    else:
                        engine.add_start_end(*sl.events64())
                    engine.n_reads_seen += sl.n_lines
                    sl.close()
                    continue
            except (ValueError, RuntimeError, OSError):
                pass
        crai_offsets = None
        if regs is not None and regs[3] == 1 and \
                hasattr(r, "interval_batches"):
            # indexed CRAM: .crai query -> decode only containers
            # whose span overlaps a fetch window (block skipping, the
            # sam_index_load/cram path of the reference,
            # src/PanDepth.cpp:4120-4124, :430-434)
            from pandepth_jax.io.cram import (crai_select_offsets,
                                              load_crai)

            crai = load_crai(path + ".crai")
            if crai is not None:
                crai_offsets = crai_select_offsets(crai, regs)
        if (regs is None or crai_offsets is not None) and \
                hasattr(r, "interval_batches"):
            # vectorized CRAM slice -> aligned-run intervals; collect
            # before committing so a mid-file fallback never
            # double-counts
            from pandepth_jax.io.cram import CramVectorFallback

            try:
                collected = list(r.interval_batches(
                    offsets=crai_offsets))
            except CramVectorFallback:
                collected = None
            if collected is not None:
                for (tid_a, flag_a, mapq_a, s0, e0, n_rec,
                     read_lo, read_hi) in collected:
                    keep = (flag_a & config.flags) == 0
                    if config.min_mapq >= 1:
                        keep &= mapq_a >= config.min_mapq
                    keep &= (tid_a >= 0) & (tid_a < n_targets)
                    if crai_offsets is not None:
                        keep &= _intervals_in_windows(
                            tid_a, read_lo, read_hi, regs)
                    engine.add_intervals(tid_a[keep], s0[keep],
                                         e0[keep])
                    engine.n_reads_seen += n_rec
                continue
        cursor = _RegionCursor(regs) if regs is not None and \
            regs[3] == 2 else None
        for batch in r.batches(max_reads=config.max_reads_per_batch):
            # out-of-range tids would be UB in the reference — drop
            if i > 0:
                batch.tid[batch.tid >= n_targets] = -1
            if cursor is not None:
                cursor.filter_batch(batch, config.flags,
                                    config.min_mapq)
            elif regs is not None:
                _filter_batch_to_windows(batch, regs)
            engine.add_batch(batch)

    print("INFO: Input data read done")
    stats.reads_seen = engine.n_reads_seen
    with maybe_profile():
        with phase(stats, "stats+write"):
            _finalize_and_write(config, engine, mode, targets, names,
                                lengths, gc_cols, ref_bases, stats)
    stats.emit()
    return 0


def run_paf(config: RunConfig) -> int:
    ref_by_tid = None
    if config.reference:
        # -r alone enables GC columns in the PAF engine (RefIn=true at
        # src/PanDepth.cpp:881). Documented divergence: without -c the
        # reference reads freed kseq buffers for those GC counts (UB
        # garbage); we always compute real GC from the fasta.
        names, lengths, chr2tid, ref_by_tid = \
            paf_contigs_from_fasta(config.reference)
        gc_cols = True
    else:
        if config.gc:
            print("Error: lack reference sequence (-r) for GC parse",
                  file=sys.stderr)
            return 1
        # the reference scans only the FIRST file for the contig table
        # (src/PanDepth.cpp:919-943); later files' unknown contigs fall
        # into tid 0 like any unknown name
        names, lengths = paf_contig_table(config.inputs[:1])
        chr2tid = {n: i for i, n in enumerate(names)}
        gc_cols = False

    mode, targets = _prepare_targets(config, names, lengths, chr2tid,
                                     ref_by_tid)

    engine = make_engine(GenomeLayout(lengths),
                         flags_mask=config.flags,
                         min_mapq=config.min_mapq,
                         min_dep=config.min_depth, wrap18=True)

    for path in config.inputs:
        native_done = False
        try:
            from pandepth_jax.io.native import (NativePafLoad,
                                                load_library)
            if load_library() is not None:
                pl = NativePafLoad(path, config.flags, config.min_mapq,
                                   names, engine.layout.offsets,
                                   engine.layout.limits)
                if engine.wants_padded_events and \
                        engine.pos_bits32:
                    s32, e32 = pl.events32_padded(
                        max(pl.n_events, 1),
                        engine.pos_sentinel32)
                    engine.add_padded_events(
                        s32.view(engine.pos_dtype),
                        e32.view(engine.pos_dtype))
                else:
                    engine.add_start_end(*pl.events64())
                pl.close()
                native_done = True
        except (ValueError, RuntimeError, OSError):
            native_done = False
        if native_done:
            continue
        for tid, s, e in iter_paf_events(path, chr2tid, config.flags,
                                         config.min_mapq):
            engine.add_intervals(tid, s, e)

    print("INFO: Input data read done")
    _finalize_and_write(config, engine, mode, targets, names, lengths,
                        gc_cols, ref_by_tid)
    return 0


def paf_contigs_from_fasta(path: str):
    """ONE streaming pass over the -r fasta: contig table + per-tid
    PackedGC (a second pass would re-gunzip and re-pack a 3 Gb
    reference for nothing). Duplicate names get distinct tids exactly
    like the reference's per-record ID++ / RefBase[ID] fasta load
    (src/PanDepth.cpp:885-896); chr2tid keeps the LAST tid per name
    (C++ map operator[] assignment)."""
    from pandepth_jax.io.fasta import iter_fasta_gc

    names: List[str] = []
    lengths: List[int] = []
    ref_by_tid = {}
    for name, gc in iter_fasta_gc(path):
        ref_by_tid[len(names)] = gc
        names.append(name)
        lengths.append(len(gc))
    chr2tid = {n: i for i, n in enumerate(names)}
    return names, np.asarray(lengths, np.int64), chr2tid, ref_by_tid
