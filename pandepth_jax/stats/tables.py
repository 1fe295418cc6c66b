"""Stat-table assembly and gzip TSV writers, byte-compatible with the
reference's output (src/PanDepth.cpp:4057-4112 naming/headers,
:4879-5134 row writers, :4264-4417 site/mode-6 writers).

Formatting contract (parity-critical, SURVEY.md §6):
- floats printed with C++ ``fixed setprecision(2)`` == Python ``:.2f``;
- rows grouped by ascending tid; within a chromosome sorted by region
  start, ties sub-ordered by region id (C++ map<string> byte order);
- every table ends with a ``##RegionLength: ...`` footer;
- chr mode aggregates the 10 Mb pseudo-genes per chromosome;
- mode 6 (windows < 150 bp) re-tiles whole contigs at stat time and,
  with ``-c -r``, prints the REAL GC(%) — a documented divergence from
  the reference, which clears the reference bases before this writer
  runs and therefore always prints 0.00 (quirk Q4, src/PanDepth.cpp:4094
  vs :4327; see README "documented divergences").
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from pandepth_jax.config import (MODE_BED3, MODE_BED4, MODE_CHR, MODE_GFF,
                                 MODE_GTF, MODE_WIN_BIG, MODE_WIN_SMALL)
from pandepth_jax.io.text import GzTextWriter, add_gz_suffix
from pandepth_jax.targets.model import TargetSet
from pandepth_jax.targets.windows import small_window_tiling


def output_prefix(out_arg: str) -> str:
    """Reference naming dance: force .gz, strip it, strip a trailing
    .stat/.bed extension (src/PanDepth.cpp:4057-4067)."""
    p = add_gz_suffix(out_arg)[:-3]
    root, ext = os.path.splitext(p)
    if ext in (".stat", ".bed"):
        p = root
    return p


def table_path(prefix: str, mode: int) -> str:
    if mode in (MODE_BED3, MODE_BED4):
        return prefix + ".bed.stat.gz"
    if mode in (MODE_WIN_BIG, MODE_WIN_SMALL):
        return prefix + ".win.stat.gz"
    if mode == MODE_CHR:
        return prefix + ".chr.stat.gz"
    return prefix + ".gene.stat.gz"


def table_header(mode: int, gc: bool) -> str:
    id_col = "GeneID"
    if mode == MODE_BED3:
        id_col = "RegionID"
    gc_col = "GC(%)\t" if gc else ""
    if mode in (MODE_WIN_BIG, MODE_WIN_SMALL):
        return (f"#Chr\tStart\tEnd\tLength\tCoveredSite\tTotalDepth\t"
                f"{gc_col}Coverage(%)\tMeanDepth\n")
    if mode == MODE_CHR:
        return (f"#Chr\tLength\tCoveredSite\tTotalDepth\t"
                f"{gc_col}Coverage(%)\tMeanDepth\n")
    return (f"#Chr\tStart\tEnd\t{id_col}\tLength\tCoveredSite\tTotalDepth\t"
            f"{gc_col}Coverage(%)\tMeanDepth\n")


def _footer(ss_len: int, ss_cov: int, ss_total: int, gc: bool,
            ss_gc: int) -> str:
    coverage = ss_cov * 100.0 / ss_len if ss_len else float("nan")
    mean = ss_total * 1.0 / ss_len if ss_len else float("nan")
    if gc:
        gcr = ss_gc * 100.0 / ss_len if ss_len else float("nan")
        return (f"##RegionLength: {ss_len}\tCoveredSite: {ss_cov}\t"
                f"GC(%): {gcr:.2f}\tCoverage(%): {coverage:.2f}\t"
                f"MeanDepth: {mean:.2f}\n")
    return (f"##RegionLength: {ss_len}\tCoveredSite: {ss_cov}\t"
            f"Coverage(%): {coverage:.2f}\tMeanDepth: {mean:.2f}\n")


def _id_row_order(targets: TargetSet):
    """Output row order for ID tables: tid-major, start-minor, C++
    ``map<string>`` byte order for start ties
    (src/PanDepth.cpp:4909-4923). Returns (order, encoded_ids)."""
    ids_enc = [s.encode() for s in targets.gene_id]
    order = np.lexsort((np.array(ids_enc), targets.gene_start,
                        targets.gene_tid))
    return order, ids_enc


def aggregate_genes(targets: TargetSet, seg_cover: np.ndarray,
                    seg_dsum: np.ndarray):
    """Sum per-segment stats into per-gene CoveredSite/TotalDepth."""
    n = targets.n_genes
    sg = targets.seg_gene
    if sg.shape[0] == n and n and sg[0] == 0 and \
            np.all(np.diff(sg) == 1):
        # one segment per gene in order (every synthesized tiling;
        # 20M windows at -w 150 on 3 Gb): skip the slow ufunc.at
        return (np.asarray(seg_cover, np.int64),
                np.asarray(seg_dsum, np.int64))
    cover = np.zeros(n, np.int64)
    dsum = np.zeros(n, np.int64)
    np.add.at(cover, sg, seg_cover)
    np.add.at(dsum, sg, seg_dsum)
    return cover, dsum


def write_tables(path: str, mode: int, gc: bool, names: Sequence[str],
                 targets: TargetSet, gene_cover: np.ndarray,
                 gene_dsum: np.ndarray,
                 win6_rows=None) -> None:
    """Write the stat table for any mode.

    ``win6_rows``: for mode 6 only — (tid, start1, end1, cover, dsum,
    gc_count) arrays already in output order (mode6_window_rows).
    """
    # native row formatters engage beyond a trivial row count: the
    # Python loop runs ~135k rows/s (0.25 s of a 1.4 s cold gene run
    # at the reference's own 33k-gene scale), the C formatter ~30x
    # that; below the threshold the member/temp-file framing overhead
    # isn't worth it
    if mode == MODE_WIN_BIG and targets.n_genes > 2048 and \
            _write_win_big_native(path, gc, names, targets, gene_cover,
                                  gene_dsum):
        return
    if mode == MODE_WIN_SMALL and win6_rows[0].shape[0] > 2048 and \
            _write_win6_native(path, gc, names, win6_rows):
        return
    if mode in (MODE_GFF, MODE_GTF, MODE_BED3, MODE_BED4) and \
            targets.n_genes > 2048 and \
            _write_id_rows_native(path, mode, gc, names, targets,
                                  gene_cover, gene_dsum):
        return

    with GzTextWriter(path) as out:
        out.write(table_header(mode, gc))
        ss_len = ss_cov = ss_total = ss_gc = 0

        if mode == MODE_WIN_SMALL:
            w_tid, w_s, w_e, w_cov, w_dsum, w_gcc = win6_rows
            w_len = w_e - w_s + 1
            for i in range(w_tid.shape[0]):
                length = int(w_len[i])
                cov, dsum, gcc = int(w_cov[i]), int(w_dsum[i]), \
                    int(w_gcc[i])
                coverage = cov * 100.0 / length
                mean = dsum * 1.0 / length
                if gc:
                    gcr = gcc * 100.0 / length
                    out.write(f"{names[w_tid[i]]}\t{w_s[i]}\t{w_e[i]}\t"
                              f"{length}\t{cov}\t{dsum}\t{gcr:.2f}\t"
                              f"{coverage:.2f}\t{mean:.2f}\n")
                else:
                    out.write(f"{names[w_tid[i]]}\t{w_s[i]}\t{w_e[i]}\t"
                              f"{length}\t{cov}\t{dsum}\t"
                              f"{coverage:.2f}\t{mean:.2f}\n")
                ss_len += length
                ss_cov += cov
                ss_total += dsum
                ss_gc += gcc
            out.write(_footer(ss_len, ss_cov, ss_total, gc, ss_gc))
            return

        if targets.gene_id is not None:
            order, _ = _id_row_order(targets)
        else:  # synthesized tilings have unique starts per contig
            order = np.lexsort((targets.gene_start, targets.gene_tid))

        if mode == MODE_CHR:
            # per-chromosome aggregation of the 10 Mb pseudo-genes
            # (src/PanDepth.cpp:5053-5085)
            for tid in np.unique(targets.gene_tid):
                sel = targets.gene_tid == tid
                c_len = int(targets.gene_length[sel].sum())
                c_cov = int(gene_cover[sel].sum())
                c_tot = int(gene_dsum[sel].sum())
                c_gc = int(targets.gene_gc[sel].sum())
                coverage = c_cov * 100.0 / c_len
                mean = c_tot * 1.0 / c_len
                if gc:
                    gcr = c_gc * 100.0 / c_len
                    out.write(f"{names[tid]}\t{c_len}\t{c_cov}\t{c_tot}\t"
                              f"{gcr:.2f}\t{coverage:.2f}\t{mean:.2f}\n")
                else:
                    out.write(f"{names[tid]}\t{c_len}\t{c_cov}\t{c_tot}\t"
                              f"{coverage:.2f}\t{mean:.2f}\n")
                ss_len += c_len
                ss_cov += c_cov
                ss_total += c_tot
                ss_gc += c_gc
            out.write(_footer(ss_len, ss_cov, ss_total, gc, ss_gc))
            return

        with_id = mode in (MODE_GFF, MODE_GTF, MODE_BED3, MODE_BED4)
        for g in order:
            tid = int(targets.gene_tid[g])
            length = int(targets.gene_length[g])
            cov = int(gene_cover[g])
            dsum = int(gene_dsum[g])
            gcc = int(targets.gene_gc[g])
            coverage = cov * 100.0 / length
            mean = dsum * 1.0 / length
            row = (f"{names[tid]}\t{int(targets.gene_start[g])}\t"
                   f"{int(targets.gene_end[g])}\t")
            if with_id:
                row += f"{targets.gene_id[g]}\t"
            row += f"{length}\t{cov}\t{dsum}\t"
            if gc:
                row += f"{gcc * 100.0 / length:.2f}\t"
            row += f"{coverage:.2f}\t{mean:.2f}\n"
            out.write(row)
            ss_len += length
            ss_cov += cov
            ss_total += dsum
            ss_gc += gcc
        out.write(_footer(ss_len, ss_cov, ss_total, gc, ss_gc))


def _run_member_jobs(path: str, jobs, workers: Optional[int] = None
                     ) -> None:
    """Run per-contig/per-range native row-writer calls concurrently.

    Each job is ``fn(out_path) -> rc`` producing ONE complete gzip
    member (the C calls release the GIL, so a thread pool gets real
    parallelism out of deflate); members land in temp part files and
    are appended to ``path`` in submission order — gzip members
    concatenate losslessly, which is also how the single-threaded
    writers already framed their output.

    Parts DRAIN as they complete (in order) while later jobs still
    run: the previous run-all-then-copy shape left a serial tail that
    re-read every part from disk after the last job finished — at a
    3 Gb ``-a`` dump (48 jobs, ~5.3 GB of members) that tail doubled
    the wall (167 s -> ~85 s measured). Bounded in-flight parts also
    cap the temp footprint."""
    import collections
    import concurrent.futures
    import shutil

    if len(jobs) == 1:
        part = f"{path}.m0"
        try:
            rc = jobs[0](part)
            if rc != 0:
                raise OSError(f"table row write failed ({rc}): {path}")
            with open(path, "ab") as out, open(part, "rb") as fh:
                shutil.copyfileobj(fh, out, 1 << 20)
        finally:
            try:
                os.remove(part)
            except OSError:
                pass
        return

    w = min(len(jobs), workers or os.cpu_count() or 1)
    pending = collections.deque()  # (future, part_path) in file order

    with open(path, "ab") as out:
        def drain_one():
            fut, part = pending.popleft()
            try:
                rc = fut.result()
                if rc != 0:
                    raise OSError(
                        f"table row write failed ({rc}): {path}")
                with open(part, "rb") as fh:
                    shutil.copyfileobj(fh, out, 1 << 20)
            finally:
                # popped parts leave the outer cleanup's view; remove
                # here (success or failure) so errors never leak parts
                try:
                    os.remove(part)
                except OSError:
                    pass

        try:
            with concurrent.futures.ThreadPoolExecutor(w) as ex:
                for i, j in enumerate(jobs):
                    while len(pending) >= 2 * w:
                        drain_one()
                    part = f"{path}.m{i}"
                    pending.append((ex.submit(j, part), part))
                while pending:
                    drain_one()
        finally:
            for _, part in pending:
                try:
                    os.remove(part)
                except OSError:
                    pass


def _write_id_rows_native(path: str, mode: int, gc: bool,
                          names: Sequence[str], targets: TargetSet,
                          gene_cover: np.ndarray,
                          gene_dsum: np.ndarray) -> bool:
    """Genome-scale gene/bed tables: stream the ID rows through the C
    formatter (one gzip member per contig; header/footer as python
    members). The Python row loop tops out around 150k rows/s; bed
    fixtures at the reference's own benchmark scale have ~175k rows."""
    if targets.gene_id is None:
        return False
    try:
        from pandepth_jax.io.native import load_library

        lib = load_library()
    except Exception:
        lib = None
    if lib is None:
        return False
    import gzip as _gzip

    order, ids_enc = _id_row_order(targets)
    with _gzip.open(path, "wt", compresslevel=1) as fh:
        fh.write(table_header(mode, gc))
    length = np.ascontiguousarray(targets.gene_length[order], np.int64)
    cover = np.ascontiguousarray(gene_cover[order], np.int64)
    dsum = np.ascontiguousarray(gene_dsum[order], np.int64)
    gcc = np.ascontiguousarray(targets.gene_gc[order], np.int64) \
        if gc else np.zeros(order.shape[0], np.int64)
    starts = np.ascontiguousarray(targets.gene_start[order], np.int64)
    ends = np.ascontiguousarray(targets.gene_end[order], np.int64)
    tid_arr = targets.gene_tid[order]
    ids = [ids_enc[g] for g in order]
    jobs = []
    for tid in np.unique(tid_arr):
        sel = np.nonzero(tid_arr == tid)[0]
        a, b = int(sel[0]), int(sel[-1]) + 1
        blob = b"".join(ids[a:b])
        offs = np.zeros(b - a + 1, np.int64)
        offs[1:] = np.cumsum([len(s) for s in ids[a:b]])
        arr = np.frombuffer(blob, np.uint8) if blob \
            else np.zeros(1, np.uint8)

        def job(p, tid=tid, a=a, b=b, arr=arr, offs=offs):
            return lib.pancov_id_rows_write(
                p.encode(), 0, names[int(tid)].encode(),
                starts[a:b], ends[a:b], arr, offs,
                length[a:b], cover[a:b], dsum[a:b], gcc[a:b], b - a,
                1 if gc else 0)
        jobs.append(job)
    _run_member_jobs(path, jobs)
    ss_len = int(targets.gene_length.sum())
    ss_cov = int(gene_cover.sum())
    ss_total = int(gene_dsum.sum())
    ss_gc = int(targets.gene_gc.sum()) if gc else 0
    with _gzip.open(path, "at", compresslevel=1) as fh:
        fh.write(_footer(ss_len, ss_cov, ss_total, gc, ss_gc))
    return True


def _write_win_big_native(path: str, gc: bool, names: Sequence[str],
                          targets: TargetSet, gene_cover: np.ndarray,
                          gene_dsum: np.ndarray) -> bool:
    """Genome-scale mode-5 tables: stream rows through the C formatter
    (one gzip member per contig; header/footer as python members)."""
    try:
        from pandepth_jax.io.native import load_library

        lib = load_library()
    except Exception:
        lib = None
    if lib is None:
        return False
    import gzip as _gzip

    with _gzip.open(path, "wt", compresslevel=1) as fh:
        fh.write(table_header(MODE_WIN_BIG, gc))
    # synthesized tilings are already (tid, start)-sorted
    z = np.zeros(targets.n_genes, np.int64)
    gcc = np.ascontiguousarray(targets.gene_gc, np.int64) if gc else z
    length = np.ascontiguousarray(targets.gene_length, np.int64)
    cover = np.ascontiguousarray(gene_cover, np.int64)
    dsum = np.ascontiguousarray(gene_dsum, np.int64)
    starts = np.ascontiguousarray(targets.gene_start, np.int64)
    ends = np.ascontiguousarray(targets.gene_end, np.int64)
    tid_arr = targets.gene_tid
    jobs = []
    for tid in np.unique(tid_arr):
        sel = np.nonzero(tid_arr == tid)[0]
        a, b = int(sel[0]), int(sel[-1]) + 1

        def job(p, tid=tid, a=a, b=b):
            return lib.pancov_win_rows_write(
                p.encode(), 0, names[int(tid)].encode(),
                np.ascontiguousarray(starts[a:b]),
                np.ascontiguousarray(ends[a:b]),
                np.ascontiguousarray(length[a:b]),
                np.ascontiguousarray(cover[a:b]),
                np.ascontiguousarray(dsum[a:b]),
                np.ascontiguousarray(gcc[a:b]), b - a, 1 if gc else 0)
        jobs.append(job)
    _run_member_jobs(path, jobs)
    with _gzip.open(path, "at", compresslevel=1) as fh:
        fh.write(_footer(int(length.sum()), int(cover.sum()),
                         int(dsum.sum()), gc, int(gcc.sum())))
    return True


def _write_win6_native(path: str, gc: bool, names: Sequence[str],
                       win6_rows) -> bool:
    """Genome-scale mode-6 tables through the same C row formatter as
    mode 5 (identical column layout; src/PanDepth.cpp:4313-4340)."""
    try:
        from pandepth_jax.io.native import load_library

        lib = load_library()
    except Exception:
        lib = None
    if lib is None:
        return False
    import gzip as _gzip

    w_tid, w_s, w_e, w_cov, w_dsum, w_gcc = win6_rows
    w_len = w_e - w_s + 1
    with _gzip.open(path, "wt", compresslevel=1) as fh:
        fh.write(table_header(MODE_WIN_SMALL, gc))
    gcc = w_gcc if gc else np.zeros(w_tid.shape[0], np.int64)
    jobs = []
    for tid in np.unique(w_tid):
        sel = np.nonzero(w_tid == tid)[0]
        a, b = int(sel[0]), int(sel[-1]) + 1

        def job(p, tid=tid, a=a, b=b):
            return lib.pancov_win_rows_write(
                p.encode(), 0, names[int(tid)].encode(),
                np.ascontiguousarray(w_s[a:b]),
                np.ascontiguousarray(w_e[a:b]),
                np.ascontiguousarray(w_len[a:b]),
                np.ascontiguousarray(w_cov[a:b]),
                np.ascontiguousarray(w_dsum[a:b]),
                np.ascontiguousarray(gcc[a:b]), b - a, 1 if gc else 0)
        jobs.append(job)
    _run_member_jobs(path, jobs)
    with _gzip.open(path, "at", compresslevel=1) as fh:
        fh.write(_footer(int(w_len.sum()), int(w_cov.sum()),
                         int(w_dsum.sum()), gc, int(gcc.sum())))
    return True


def _win6_use(names: Sequence[str], lengths: np.ndarray,
              tids_with_regions: np.ndarray):
    """Contigs that get mode-6 windows, in output order: regioned and
    longer than 1 bp (src/PanDepth.cpp:4313-4317). The ONE definition
    both the streaming and the one-shot writers share — they must
    agree byte-for-byte."""
    region_set = set(int(t) for t in tids_with_regions)
    return [tid for tid in range(len(names))
            if tid in region_set and int(lengths[tid]) > 1]


def write_win6_streaming(path: str, gc: bool, names: Sequence[str],
                         lengths: np.ndarray,
                         tids_with_regions: np.ndarray, win: int,
                         stats_fn, gc_counts_fn=None,
                         is_writer: bool = True) -> bool:
    """Mode-6 table without materializing the whole-genome tiling.

    The one-shot path (mode6_window_rows + _write_win6_native) holds
    every window row of the genome at once — ~30 M rows x 44 B at
    ``-w 100`` on 3 Gb, the dominant RSS of that config. Here windows
    are built and evaluated PER CONTIG (~2.5 M rows a pop — the
    reference's own 10 Mb-bin discipline writ large,
    src/PanDepth.cpp:676-679), and each contig's rows are split into
    ~1 M-row chunks formatted + deflated as independent gzip members
    by a small thread pool (the C row formatter releases the GIL —
    row formatting + deflate dominate this table at genome scale:
    ~30 M rows / ~1.3 GB of text at ``-w 100`` on 3 Gb, vs a few
    seconds of eval). Member part files are appended to ``path`` in
    (contig, chunk) order, so the decompressed bytes are identical to
    the single-threaded one-shot writer's: same header, same row
    bytes, same footer. In-flight parts are capped to bound both RSS
    and temp-file footprint. ``PANDEPTH_WIN6_CHUNK_ROWS`` overrides
    the chunk size (tests force multi-chunk contigs with it).

    ``stats_fn``/``gc_counts_fn`` run on EVERY rank in the same order
    (multihost engines issue collectives from them); only the writer
    rank touches the file. Returns False (caller falls back to the
    one-shot path) when the native formatter is unavailable."""
    try:
        from pandepth_jax.io.native import load_library

        lib = load_library()
    except Exception:
        lib = None
    if lib is None:
        return False
    import collections
    import concurrent.futures
    import gzip as _gzip
    import shutil

    use = _win6_use(names, lengths, tids_with_regions)
    if is_writer:
        with _gzip.open(path, "wt", compresslevel=1) as fh:
            fh.write(table_header(MODE_WIN_SMALL, gc))
    ss_len = ss_cov = ss_total = ss_gc = 0
    w = int(win)
    chunk_rows = int(os.environ.get("PANDEPTH_WIN6_CHUNK_ROWS",
                                    1 << 20))
    workers = min(4, os.cpu_count() or 1)
    out = open(path, "ab") if is_writer else None
    pending = collections.deque()  # (future, part_path) in file order
    part_seq = 0

    def drain_one():
        fut, part = pending.popleft()
        try:
            rc = fut.result()
            if rc != 0:
                raise OSError(f"win6 row write failed ({rc}): {path}")
            with open(part, "rb") as fh:
                shutil.copyfileobj(fh, out, 1 << 20)
        finally:
            # popped parts are no longer covered by the outer cleanup;
            # remove here (success or failure) so error paths never
            # leak a .m<N> temp file next to the output
            try:
                os.remove(part)
            except OSError:
                pass

    try:
        with concurrent.futures.ThreadPoolExecutor(workers) as ex:
            for tid in use:
                tiling = small_window_tiling(int(lengths[tid]), w)
                seg_tid = np.full(tiling.shape[0], tid, np.int32)
                starts = np.ascontiguousarray(tiling[:, 0])
                ends = np.ascontiguousarray(tiling[:, 1])
                cover, dsum = stats_fn(seg_tid, starts, ends)
                cover = np.ascontiguousarray(cover, np.int64)
                dsum = np.ascontiguousarray(dsum, np.int64)
                if gc_counts_fn is not None:
                    gcc = np.ascontiguousarray(
                        gc_counts_fn(tid, starts, ends), np.int64)
                else:
                    gcc = np.zeros(tiling.shape[0], np.int64)
                length = ends - starts + 1
                ss_len += int(length.sum())
                ss_cov += int(cover.sum())
                ss_total += int(dsum.sum())
                ss_gc += int(gcc.sum())
                if out is None:
                    continue
                name_b = names[tid].encode()
                for lo in range(0, tiling.shape[0], chunk_rows):
                    hi = min(lo + chunk_rows, tiling.shape[0])
                    while len(pending) >= 2 * workers:
                        drain_one()
                    part = f"{path}.m{part_seq}"
                    part_seq += 1
                    pending.append((ex.submit(
                        lib.pancov_win_rows_write, part.encode(), 0,
                        name_b, starts[lo:hi], ends[lo:hi],
                        length[lo:hi], cover[lo:hi], dsum[lo:hi],
                        gcc[lo:hi], hi - lo, 1 if gc else 0), part))
            while pending:
                drain_one()
    finally:
        for _, part in pending:
            try:
                os.remove(part)
            except OSError:
                pass
        if out is not None:
            out.close()
    if is_writer:
        with _gzip.open(path, "at", compresslevel=1) as fh:
            fh.write(_footer(ss_len, ss_cov, ss_total, gc, ss_gc))
    return True


def write_site_depth(path: str, names: Sequence[str], lengths: np.ndarray,
                     tids_with_regions: np.ndarray, dense_depth_fn) -> None:
    """``.SiteDepth.gz``: chr, 0-based pos, depth for every base of every
    chromosome that has regions (src/PanDepth.cpp:4264-4284). Uses the
    C++ formatter when available (~30x the Python loop)."""
    native_write = None
    try:
        from pandepth_jax.io.native import load_library

        lib = load_library()
        if lib is not None:
            native_write = lib.pancov_site_depth_write
    except Exception:
        pass

    region_set = set(int(t) for t in tids_with_regions)
    if native_write is not None:
        # one gzip member per 64 Mb position range: members
        # concatenate byte-identically to per-contig members, each job
        # holds only a 256 MB dense slice instead of a whole contig
        # (a 250 Mb contig is ~1 GB of int32; 4 such jobs in flight
        # put the 3 Gb -a run at 4.3 GB RSS), and a 3 Gb genome yields
        # ~48 jobs that load-balance the writer pool far better than
        # 12 contig-sized ones
        chunk_bp = 64 << 20
        jobs = []
        for tid in range(len(names)):
            if tid not in region_set:
                continue
            ln = int(lengths[tid])
            for lo in range(0, max(ln, 1), chunk_bp):
                hi = min(lo + chunk_bp, ln)

                def job(p, tid=tid, lo=lo, hi=hi):
                    # dense expansion inside the job: np.repeat and
                    # the C gzip formatter both release the GIL, so
                    # ranges overlap across the member pool
                    d = np.ascontiguousarray(
                        dense_depth_fn(tid, lo, hi), np.int32)
                    return native_write(p.encode(),
                                        names[tid].encode(),
                                        lo, d, d.shape[0], 0)
                jobs.append(job)
        if not jobs:  # keep an (empty) file for parity
            with GzTextWriter(path):
                pass
            return
        # materialize the (possibly lazily merged) sweep state once,
        # single-threaded, before the pool races to build it
        try:
            dense_depth_fn(int(next(iter(region_set))), 0, 0)
        except TypeError:
            pass
        open(path, "wb").close()
        _run_member_jobs(path, jobs, workers=min(4, os.cpu_count()
                                                 or 1))
        return

    with GzTextWriter(path) as out:
        for tid in range(len(names)):
            if tid not in region_set:
                continue
            d = dense_depth_fn(tid)
            name = names[tid]
            chunk = 1 << 20
            for i in range(0, d.shape[0], chunk):
                block = d[i: i + chunk]
                out.write("".join(
                    f"{name}\t{i + k}\t{v}\n"
                    for k, v in enumerate(block.tolist())))


def write_site_depth_range(path: str, names: Sequence[str],
                           lengths: np.ndarray, offsets: np.ndarray,
                           tids_with_regions: np.ndarray,
                           lo: int, hi: int, dense_fn) -> bool:
    """One shard of a range-partitioned ``.SiteDepth.gz``: the rows for
    flat genome positions ``[lo, hi)`` restricted to chromosomes that
    have regions, written to ``path`` as concatenated gzip members.

    Because contig offsets ascend with tid and the site dump is
    ordered (tid, pos), a contiguous flat range maps to a contiguous
    run of output lines — per-range part files concatenated in range
    order reproduce the single-writer file exactly (multihost ``-a``,
    reference writer src/PanDepth.cpp:4264-4284). ``dense_fn(a, b)``
    returns int32 per-base depth for flat ``[a, b)``. Returns True if
    any row was written (no file is created otherwise)."""
    native_write = None
    try:
        from pandepth_jax.io.native import load_library

        lib = load_library()
        if lib is not None:
            native_write = lib.pancov_site_depth_write
    except Exception:
        pass

    region_set = set(int(t) for t in tids_with_regions)
    wrote = False
    for tid in range(len(names)):
        if tid not in region_set:
            continue
        off = int(offsets[tid])
        a = max(lo, off)
        b = min(hi, off + int(lengths[tid]))
        if b <= a:
            continue
        d = np.ascontiguousarray(dense_fn(a, b), np.int32)
        if native_write is not None:
            rc = native_write(path.encode(), names[tid].encode(),
                              a - off, d, b - a, 1 if wrote else 0)
            if rc != 0:
                raise OSError(f"site depth range write failed ({rc}):"
                              f" {path}")
        else:
            with _gzip.open(path, "at" if wrote else "wt",
                            compresslevel=1) as out:
                name = names[tid]
                for k, v in enumerate(d.tolist()):
                    out.write(f"{name}\t{a - off + k}\t{v}\n")
        wrote = True
    return wrote


def mode6_window_rows(names: Sequence[str], lengths: np.ndarray,
                      tids_with_regions: np.ndarray, win_size: int,
                      stats_fn, gc_counts_fn=None):
    """Build mode-6 rows: re-tile each regioned contig with the small
    window size (src/PanDepth.cpp:4313-4317).

    One batched ``stats_fn(seg_tid, seg_start, seg_end) -> (cover,
    dsum)`` call over every window of every contig (a 3 Gb genome at
    ``-w 100`` is ~30 M windows — one device dispatch, not one per
    contig); ``gc_counts_fn(tid, starts, ends) -> int64 array`` (or
    None for the reference's cleared-RefBase 0.00 behavior, quirk Q4).
    Returns (tid, start1, end1, cover, dsum, gcc) arrays in output
    order.
    """
    # preallocate and fill per contig: a 3 Gb genome at -w 100 is ~30M
    # windows, and this host's page faults are slow enough that the
    # list-then-concatenate shape would double the fresh-page bill
    use = _win6_use(names, lengths, tids_with_regions)
    counts = [(int(lengths[t]) - 2) // win_size + 1 for t in use]
    total = sum(counts)
    if total == 0:
        z64 = np.zeros(0, np.int64)
        return (np.zeros(0, np.int32), z64, z64, z64, z64, z64)
    seg_tid = np.empty(total, np.int32)
    starts = np.empty(total, np.int64)
    ends = np.empty(total, np.int64)
    off = 0
    for tid, n in zip(use, counts):
        tiling = small_window_tiling(int(lengths[tid]), win_size)
        seg_tid[off: off + n] = tid
        starts[off: off + n] = tiling[:, 0]
        ends[off: off + n] = tiling[:, 1]
        off += n
    cover, dsum = stats_fn(seg_tid, starts, ends)
    if gc_counts_fn is not None:
        gcc = np.empty(total, np.int64)
        off = 0
        for tid, n in zip(use, counts):
            gcc[off: off + n] = gc_counts_fn(
                int(tid), starts[off: off + n], ends[off: off + n])
            off += n
    else:
        gcc = np.zeros(total, np.int64)
    return (seg_tid, starts, ends, np.asarray(cover, np.int64),
            np.asarray(dsum, np.int64), gcc)
