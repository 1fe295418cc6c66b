"""Target/region model.

The reference keeps per-target accumulators in
``map<int, map<string, GeneInfo>>`` (GeneInfo: include/DataClass.h:62-80)
keyed by (tid, gene-id), where each record appends a (start, end) segment
to ``CDSList`` and updates span/length (src/PanDepth.cpp:3638-3641).
We keep the same merge semantics but flatten everything into columnar
numpy arrays ready for the device sweep:

- one row per *gene* (= output table row),
- one row per *segment* (= CDSList entry), linked to its gene.

Coordinates follow the reference convention: 1-based inclusive
``[start, end]`` in the input files; the device sweep works on 0-based
half-open ``[start-1, end)``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class TargetSet:
    """Columnar target regions (genes + their segments)."""

    mode: int
    # per-gene arrays (row index = gene index, insertion order)
    gene_tid: np.ndarray      # int32
    gene_id: Optional[List[str]]  # None for synthesized tilings (never printed)
    gene_start: np.ndarray    # int64, 1-based min segment start
    gene_end: np.ndarray      # int64, 1-based max segment end
    gene_length: np.ndarray   # int64, sum of segment lengths (overlaps double-count)
    gene_gc: np.ndarray       # int64, GC base count over segments (0 if no ref)
    # per-segment arrays
    seg_gene: np.ndarray      # int32 -> gene row
    seg_start: np.ndarray     # int64, 1-based inclusive
    seg_end: np.ndarray       # int64, 1-based inclusive

    @property
    def n_genes(self) -> int:
        return int(self.gene_tid.shape[0])

    @property
    def n_segments(self) -> int:
        return int(self.seg_start.shape[0])

    def tids_with_regions(self) -> np.ndarray:
        """Sorted unique tids that have at least one target (the key set of
        the reference's RegionMerger, src/PanDepth.cpp:3912-3972)."""
        return np.unique(self.gene_tid)

    def merged_spans(self, n_targets: int):
        """The reference's RegionMerger: per-tid merged gene spans as
        1-based closed intervals, sorted by start — map semantics with
        max-end dedup then overlap sweep (src/PanDepth.cpp:3912-3972).

        Returns (per_tid_offsets[n+1], starts1, ends1) int64 arrays.
        """
        off = np.zeros(n_targets + 1, np.int64)
        tid = np.asarray(self.gene_tid, np.int64)
        s = np.asarray(self.gene_start, np.int64)
        e = np.asarray(self.gene_end, np.int64)
        if tid.shape[0] == 0:
            return off, np.zeros(0, np.int64), np.zeros(0, np.int64)
        # fold (tid, pos) into one sortable key; the +m shift keeps
        # negative starts (BED atoi quirk) inside their tid's band
        m = np.int64(max(int(np.abs(s).max()), int(np.abs(e).max())) + 2)
        ks = tid * (2 * m) + s + m
        ke = tid * (2 * m) + e + m
        order = np.argsort(ks, kind="stable")
        ks, ke = ks[order], ke[order]
        run_max = np.maximum.accumulate(ke)
        new = np.ones(ks.shape[0], bool)
        new[1:] = ks[1:] > run_max[:-1]
        grp = np.flatnonzero(new)
        ms = ks[grp]
        me = np.maximum.reduceat(ke, grp)
        mt = ms // (2 * m)
        off[1:] = np.cumsum(np.bincount(mt, minlength=n_targets))
        return (off, ms - mt * (2 * m) - m, me - mt * (2 * m) - m)

    def fetch_windows(self, lengths: np.ndarray):
        """The indexed paths' htslib fetch windows: merged gene spans
        padded the way the region strings are built (beg = max(start-1,
        1), end = min(end+1, chr_len), src/PanDepth.cpp:700-703), as
        0-based half-open intervals.

        Returns (per_tid_offsets[n+1], starts0, ends0) int64 arrays
        with windows sorted per tid (ends strictly increasing).
        """
        n_t = len(lengths)
        m_off, m_s, m_e = self.merged_spans(n_t)
        tid = np.repeat(np.arange(n_t, dtype=np.int64),
                        np.diff(m_off))
        b0 = np.maximum(m_s - 1, 1) - 1
        e0 = np.minimum(m_e + 1, np.asarray(lengths, np.int64)[tid])
        keep = e0 > b0
        off = np.zeros(n_t + 1, np.int64)
        off[1:] = np.cumsum(np.bincount(tid[keep], minlength=n_t))
        return off, b0[keep], e0[keep]


class GeneAccumulator:
    """Replicates the reference's (tid, gene-id) keyed accumulation.

    Repeated records for the same key take min start / max end, sum the
    per-record span into GeneLength, and append the segment
    (src/PanDepth.cpp:3638-3641). GC quirk: the reference counts GC over
    ``[start-1, end)`` only in the branches that *create* a GeneInfo —
    the merge branch never touches GeneGCGC (src/PanDepth.cpp:3646-3650)
    — so a multi-segment gene's GC(%) is its first segment's GC count
    over the summed length. Replicated.
    """

    def __init__(self, mode: int,
                 ref_bases: Optional[Dict[int, bytes]] = None):
        self.mode = mode
        self._ref = ref_bases
        self._index: Dict[Tuple[int, str], int] = {}
        self._tid: List[int] = []
        self._id: List[str] = []
        self._start: List[int] = []
        self._end: List[int] = []
        self._length: List[int] = []
        self._gc: List[int] = []
        self._seg_gene: List[int] = []
        self._seg_start: List[int] = []
        self._seg_end: List[int] = []
        self._arrays: Optional[dict] = None  # add_bulk fast path

    def _materialize(self) -> None:
        """Spill the add_bulk arrays into the row-wise lists so a
        subsequent ``add`` can keep merging (rare path)."""
        a = self._arrays
        self._arrays = None
        self._tid = a["gene_tid"].tolist()
        self._id = a["gene_id"]
        self._start = a["gene_start"].tolist()
        self._end = a["gene_end"].tolist()
        self._length = a["gene_length"].tolist()
        self._gc = a["gene_gc"].tolist()
        self._seg_gene = a["seg_gene"].tolist()
        self._seg_start = a["seg_start"].tolist()
        self._seg_end = a["seg_end"].tolist()
        self._index = {(t, i): r for r, (t, i) in
                       enumerate(zip(self._tid, self._id))}

    def _gc_count(self, tid: int, start: int, end: int) -> int:
        if self._ref is None:
            return 0
        seq = self._ref.get(tid)
        if seq is None:
            return 0
        if not isinstance(seq, (bytes, bytearray)):  # PackedGC
            import numpy as np

            return int(seq.count_ranges(np.array([start]),
                                        np.array([end]))[0])
        frag = seq[max(start - 1, 0): end]
        return frag.count(b"G") + frag.count(b"C") + \
            frag.count(b"g") + frag.count(b"c")

    def add(self, tid: int, gene_id: str, start: int, end: int) -> None:
        if self._arrays is not None:
            self._materialize()
        key = (tid, gene_id)
        row = self._index.get(key)
        if row is None:
            row = len(self._tid)
            self._index[key] = row
            self._tid.append(tid)
            self._id.append(gene_id)
            self._start.append(start)
            self._end.append(end)
            self._length.append(end - start + 1)
            self._gc.append(self._gc_count(tid, start, end))
        else:
            if start < self._start[row]:
                self._start[row] = start
            if end > self._end[row]:
                self._end[row] = end
            self._length[row] += end - start + 1
            # no GC accumulation on merge (reference quirk, see class doc)
        self._seg_gene.append(row)
        self._seg_start.append(start)
        self._seg_end.append(end)

    def add_bulk(self, tid: np.ndarray, ids_s: np.ndarray,
                 start: np.ndarray, end: np.ndarray) -> None:
        """Vectorized twin of repeated ``add`` calls over columnar
        rows (the native GFF/GTF tokenizer's output; ``ids_s`` is a
        fixed-width 'S<w>' id array): same (tid, gene-id) keyed merge
        — min start / max end / summed span — with insertion-order
        gene rows and the first-segment-only GC quirk."""
        n = int(start.shape[0])
        if n == 0:
            return
        if self._tid or self._arrays is not None:
            # already accumulating: stay row-wise
            if self._arrays is not None:
                self._materialize()
            for i in range(n):
                gid = ids_s[i].decode("utf-8", "surrogateescape")
                self.add(int(tid[i]), gid, int(start[i]), int(end[i]))
            return
        tid = np.asarray(tid, np.int64)
        start = np.asarray(start, np.int64)
        end = np.asarray(end, np.int64)
        # (tid, id) key as one int64: one string unique, the rest int
        idu, idinv = np.unique(ids_s, return_inverse=True)
        key = tid * (idu.shape[0] + 1) + idinv
        _, first_idx, inv = np.unique(key, return_index=True,
                                      return_inverse=True)
        order = np.argsort(first_idx, kind="stable")  # insertion order
        rank = np.empty(order.shape[0], np.int64)
        rank[order] = np.arange(order.shape[0])
        row = rank[inv]
        g = order.shape[0]
        # per-gene min/max/sum via one stable sort + reduceat
        ordseg = np.argsort(row, kind="stable")
        bnd = np.searchsorted(row[ordseg], np.arange(g))
        gs = np.minimum.reduceat(start[ordseg], bnd)
        ge = np.maximum.reduceat(end[ordseg], bnd)
        gl = np.add.reduceat((end - start + 1)[ordseg], bnd)
        first = first_idx[order]  # input row creating each gene
        gc = np.zeros(g, np.int64)
        if self._ref is not None:
            from pandepth_jax.io.fasta import gc_count_ranges
            ftid = tid[first]
            for t in np.unique(ftid):
                seq = self._ref.get(int(t))
                if not seq:
                    continue
                sel = ftid == t
                gc[sel] = gc_count_ranges(seq, start[first][sel],
                                          end[first][sel])
        self._arrays = {
            "gene_tid": tid[first],
            "gene_id": [ids_s[i].decode("utf-8", "surrogateescape")
                        for i in first],
            "gene_start": gs, "gene_end": ge, "gene_length": gl,
            "gene_gc": gc, "seg_gene": row,
            "seg_start": start, "seg_end": end,
        }

    def build(self) -> TargetSet:
        if self._arrays is not None:
            a = self._arrays
            return TargetSet(
                mode=self.mode,
                gene_tid=a["gene_tid"].astype(np.int32),
                gene_id=list(a["gene_id"]),
                gene_start=a["gene_start"].astype(np.int64),
                gene_end=a["gene_end"].astype(np.int64),
                gene_length=a["gene_length"].astype(np.int64),
                gene_gc=a["gene_gc"].astype(np.int64),
                seg_gene=a["seg_gene"].astype(np.int32),
                seg_start=a["seg_start"].astype(np.int64),
                seg_end=a["seg_end"].astype(np.int64),
            )
        return TargetSet(
            mode=self.mode,
            gene_tid=np.asarray(self._tid, np.int32),
            gene_id=list(self._id),
            gene_start=np.asarray(self._start, np.int64),
            gene_end=np.asarray(self._end, np.int64),
            gene_length=np.asarray(self._length, np.int64),
            gene_gc=np.asarray(self._gc, np.int64),
            seg_gene=np.asarray(self._seg_gene, np.int32),
            seg_start=np.asarray(self._seg_start, np.int64),
            seg_end=np.asarray(self._seg_end, np.int64),
        )
