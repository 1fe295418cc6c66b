"""Default-region synthesis for chromosome and window modes.

When no GFF/BED targets exist the reference tiles every contig with
pseudo-genes (src/PanDepth.cpp:3975-4051):

- no ``-w``: mode 0 (chr), 10 Mb bins;
- ``-w`` < 150: mode 6, 10 Mb bins (the real small windows are applied
  at stat time over whole-contig depth, src/PanDepth.cpp:4290-4417);
- ``-w`` >= 150: mode 5, bins of exactly the window size.

The tiling loop starts with ``End = 2`` and tests ``End <= len`` before
each iteration, so contigs of length < 2 get NO regions at all and are
absent from every output table — replicated here. The same check runs
against the PREVIOUS window's ``End + 2``, which drops a final window
of exactly 1 base (a window starts at position s only when s < len):
a contig with ``(len - 1) % bin == 0`` loses its last base from every
chr/win table and fetch region — also replicated (found by
differential fuzzing; the reference behaves this way in all four
engines, src/PanDepth.cpp:4000-4044, :2555-2608, :1380-1441).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from pandepth_jax.config import (MEM_BIN_WINDOWS, MODE_CHR, MODE_WIN_BIG,
                                 MODE_WIN_SMALL)
from pandepth_jax.targets.model import TargetSet


def synthesize_default_targets(
        names: Sequence[str], lengths: np.ndarray, win_size: int,
        ref_bases: Optional[Dict[int, bytes]] = None
) -> Tuple[int, TargetSet]:
    """Return (mode, targets) tiling every contig; see module docstring.

    Built vectorized: mode 5 on a 3 Gb genome is ~20M windows, far too
    many for a per-window Python loop. The tiling below is exactly the
    reference loop's output: ceil(len/bin) windows for contigs with
    len >= 2, none otherwise.
    """
    if win_size == 0:
        mode, bin_w = MODE_CHR, MEM_BIN_WINDOWS
    elif win_size < 150:
        mode, bin_w = MODE_WIN_SMALL, MEM_BIN_WINDOWS
    else:
        mode, bin_w = MODE_WIN_BIG, win_size

    tids = []
    starts = []
    ends = []
    gcs = []
    for tid in range(len(names)):
        clen = int(lengths[tid])
        if clen < 2:
            continue
        # arange end = clen (strict): a window never STARTS at the
        # last base — the reference's 1-base final-window drop
        s = np.arange(1, clen, bin_w, dtype=np.int64)
        e = np.minimum(s + bin_w - 1, clen)
        tids.append(np.full(s.shape[0], tid, np.int32))
        starts.append(s)
        ends.append(e)
        if ref_bases is not None and tid in ref_bases:
            from pandepth_jax.io.fasta import gc_count_ranges

            gcs.append(gc_count_ranges(ref_bases[tid], s, e))
        else:
            gcs.append(np.zeros(s.shape[0], np.int64))

    if tids:
        gene_tid = np.concatenate(tids)
        gene_start = np.concatenate(starts)
        gene_end = np.concatenate(ends)
        gene_gc = np.concatenate(gcs)
    else:
        gene_tid = np.zeros(0, np.int32)
        gene_start = gene_end = gene_gc = np.zeros(0, np.int64)
    n = gene_tid.shape[0]
    targets = TargetSet(
        mode=mode,
        gene_tid=gene_tid,
        gene_id=None,  # ids are never printed for synthesized modes
        gene_start=gene_start,
        gene_end=gene_end,
        gene_length=(gene_end - gene_start + 1),
        gene_gc=gene_gc,
        seg_gene=np.arange(n, dtype=np.int32),
        # one segment per window: share the gene arrays (read-only use)
        seg_start=gene_start,
        seg_end=gene_end,
    )
    return mode, targets


def small_window_tiling(chr_len: int, win_size: int) -> np.ndarray:
    """Mode-6 stat windows for one contig: 1-based [start, end] pairs.

    Replicates ``for (j = 1; j < CC; j += WinSize)`` with
    ``End = min(j - 1 + WinSize, CC)`` (src/PanDepth.cpp:4313-4317) —
    note the strict ``j < CC`` drops a final 1-base window when the
    contig length falls exactly on a window boundary + 1.
    """
    starts = np.arange(1, chr_len, win_size, dtype=np.int64)
    ends = np.minimum(starts + win_size - 1, chr_len)
    return np.stack([starts, ends], axis=1)
