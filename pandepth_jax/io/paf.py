"""PAF / PAF.gz parsing to coverage events.

Replicates the reference PAF engine's record handling
(src/PanDepth.cpp:1534-1618):

- contig table from the ``-r`` fasta (in fasta order) or, absent that,
  first-seen order of PAF columns 6-7 (src/PanDepth.cpp:873-943);
- when FLAG mask has 0x100 set, lines *containing the substring*
  ``tp:A:S`` anywhere are dropped (src/PanDepth.cpp:1550-1556);
- column 12 (mapq) is atoi'd and compared ``< q`` (src:1562-1566);
- target start/end (cols 8-9, 0-based) are swapped if start > end;
- with a ``cg:Z:`` tag: M/=/X add depth from the 0-based target start,
  D/N advance (src:1577-1607);
- without: the whole span ``[start-1, end)`` is filled — one base
  *before* the 0-based start, quirk Q7 (src:1608-1614);
- unknown target names resolve to tid 0 (C++ map operator[] inserts 0,
  src:1559).
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, List, Tuple

import numpy as np

from pandepth_jax.io.text import iter_text_lines

_CG_RE = re.compile(r"(\d+)([A-Za-z=])")


def paf_contig_table(paths: List[str]) -> Tuple[List[str], np.ndarray]:
    """Scan PAF cols 6-7 for the contig table (first-seen order).

    Native memchr scan when the library is available (the Python line
    loop runs ~300k lines/s — ~30 s of the 8M-line bench file's wall
    was this table pass alone)."""
    names: List[str] = []
    lengths: List[int] = []
    seen: Dict[str, int] = {}
    try:
        import ctypes

        from pandepth_jax.io.native import load_library

        lib = load_library()
    except Exception:
        lib = None
    for path in paths:
        if lib is not None:
            err = ctypes.create_string_buffer(256)
            h = lib.pancov_paf_contigs(path.encode(), err, 256)
            if not h:
                raise OSError(f"open PAF file error: {path}")
            try:
                n = lib.pancov_paf_contigs_count(h)
                bl = lib.pancov_paf_contigs_blob_len(h)
                blob = ctypes.create_string_buffer(max(int(bl), 1))
                lib.pancov_paf_contigs_blob(h, blob)
                lens = np.empty(n, np.int64)
                if n:
                    lib.pancov_paf_contigs_lens(h, lens)
                file_names = blob.raw[:bl].split(b"\x00")[:-1]
            finally:
                lib.pancov_paf_contigs_free(h)
            for nm, ln in zip(file_names, lens):
                chrom = nm.decode()
                if chrom not in seen:
                    seen[chrom] = len(names)
                    names.append(chrom)
                    lengths.append(int(ln))
            continue
        for line in iter_text_lines(path):
            if not line:
                continue
            toks = line.split()
            if len(toks) < 7:
                continue
            chrom = toks[5]
            if chrom not in seen:
                seen[chrom] = len(names)
                names.append(chrom)
                lengths.append(int(toks[6]))
    return names, np.asarray(lengths, np.int64)


def _atoi(s: str) -> int:
    m = re.match(r"\s*([+-]?\d+)", s)
    return int(m.group(1)) if m else 0


def iter_paf_events(path: str, chr2tid: Dict[str, int], flags: int,
                    min_mapq: int,
                    batch: int = 1 << 18
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                        np.ndarray]]:
    """Yield (tid, start0, end0) interval batches (0-based half-open)
    per depth-adding CIGAR segment / span fill."""
    tids: List[int] = []
    starts: List[int] = []
    ends: List[int] = []
    secondary_filter = bool(flags & 0x100)
    lookup = dict(chr2tid)

    def emit():
        out = (np.asarray(tids, np.int32), np.asarray(starts, np.int64),
               np.asarray(ends, np.int64))
        tids.clear()
        starts.clear()
        ends.clear()
        return out

    for line in iter_text_lines(path):
        if not line:
            continue
        if secondary_filter and "tp:A:S" in line:
            continue
        toks = line.split()
        if len(toks) < 12:
            continue
        tid = lookup.setdefault(toks[5], 0)
        qual = _atoi(toks[11])
        if qual < min_mapq:
            continue
        s = _atoi(toks[7])
        e = _atoi(toks[8])
        if s > e:
            s, e = e, s
        cg = None
        # reference requires the cg field index > 1 (src/PanDepth.cpp:1578)
        for i, t in enumerate(toks):
            if t.startswith("cg:Z:"):
                if i > 1:
                    cg = t[5:]
                break
        if cg is not None:
            cursor = s
            for m in _CG_RE.finditer(cg):
                ln = int(m.group(1))
                op = m.group(2)
                if op in ("M", "=", "X"):
                    tids.append(tid)
                    starts.append(cursor)
                    ends.append(cursor + ln)
                    cursor += ln
                elif op in ("D", "N"):
                    cursor += ln
        else:
            tids.append(tid)
            starts.append(s - 1)
            ends.append(e)
        if len(tids) >= batch:
            yield emit()
    if tids:
        yield emit()
