"""GFF/GTF/BED target-file parsing with the reference's exact semantics.

Parity notes (file:line into /root/reference):

- GFF-vs-GTF autodetect scans the first 167 non-blank, non-``#`` lines;
  a line containing ``Parent`` selects GFF (mode 1), else one containing
  ``transcript_id`` selects GTF (mode 2); the *last* informative line
  wins (src/PanDepth.cpp:162-189).
- BED 3-vs-4 column detect looks at the first two lines only
  (src/PanDepth.cpp:280-289).
- GFF gene id: attribute column is the 9th *whitespace* token; it is
  split on ``,``/``;``; the default id is the last ``=``-part of the
  first token, overridden by any ``Parent=`` attribute
  (src/PanDepth.cpp:3571-3586).
- GTF gene id: quotes and semicolons are stripped from the whole line,
  then the id is whitespace token index 9 — the loop meant to honor
  ``transcript_id`` compares the wrong element and never fires (quirk
  Q3, src/PanDepth.cpp:3669-3677); we replicate the observable result.
- BED3 synthesizes ``Chr_Start_End`` ids from the *original string*
  columns (src/PanDepth.cpp:3752); BED4 takes column 4.
- Lines naming contigs absent from the header are skipped with a
  warning (src/PanDepth.cpp:3589-3592); BED lines with start > end are
  skipped with a warning (src/PanDepth.cpp:3754-3758).
"""

from __future__ import annotations

import re
import sys
from typing import Dict, Optional

from pandepth_jax.config import MODE_BED3, MODE_BED4, MODE_GFF, MODE_GTF
from pandepth_jax.targets.model import GeneAccumulator, TargetSet
from pandepth_jax.io.text import iter_text_lines

_WS_SPLIT = re.compile(r"[ \t]+")


def detect_gff_mode(path: str) -> int:
    """Return MODE_GFF / MODE_GTF, or 0 when undetectable."""
    mode = 0
    n = 0
    for line in iter_text_lines(path):
        n += 1
        if n >= 168:
            break
        if len(line) < 2 or line.startswith("#"):
            continue
        if "Parent" in line:
            mode = MODE_GFF
        elif "transcript_id" in line:
            mode = MODE_GTF
    return mode


def detect_bed_mode(path: str) -> int:
    """Return MODE_BED4 when either of the first two lines has exactly 4
    whitespace tokens, else MODE_BED3."""
    lines = []
    for line in iter_text_lines(path):
        lines.append(line)
        if len(lines) == 2:
            break
    while len(lines) < 2:
        lines.append("")
    for line in lines:
        toks = [t for t in _WS_SPLIT.split(line) if t]
        if len(toks) == 4:
            return MODE_BED4
    return MODE_BED3


def _warn_region(line: str) -> None:
    print(f"{line}Warning: This region may be incorrect.\n",
          file=sys.stderr)


def _atoi(s: str) -> int:
    """C atoi: leading whitespace, optional sign, digits; else 0."""
    m = re.match(r"\s*([+-]?\d+)", s)
    return int(m.group(1)) if m else 0


def _try_native_targets(path: str, feature: str, mode: int,
                        chr2tid: Dict[str, int],
                        acc: GeneAccumulator) -> bool:
    """Native GFF/GTF/BED tokenize (~15x the Python line loop on a
    175k-segment annotation) feeding the vectorized accumulator.
    The MODE_* constants match the native mode codes directly."""
    import os
    if os.environ.get("PANDEPTH_NO_NATIVE") == "1":
        return False
    try:
        from pandepth_jax.io.native import (NativeTargetsLoad,
                                            load_library)
        if load_library() is None:
            return False
        tl = NativeTargetsLoad(path, feature, mode, chr2tid)
    except (ValueError, RuntimeError, OSError):
        return False
    tid, s, e, ids_s = tl.columns()
    tl.close()
    acc.add_bulk(tid, ids_s, s, e)
    return True


def parse_targets(path: str, mode: int, chr2tid: Dict[str, int],
                  feature: str = "CDS",
                  ref_bases: Optional[Dict[int, bytes]] = None) -> TargetSet:
    acc = GeneAccumulator(mode, ref_bases)
    if mode == MODE_GFF:
        if not _try_native_targets(path, feature, mode, chr2tid, acc):
            _parse_gff(path, feature, chr2tid, acc)
    elif mode == MODE_GTF:
        if not _try_native_targets(path, feature, mode, chr2tid, acc):
            _parse_gtf(path, feature, chr2tid, acc)
    elif mode == MODE_BED3:
        if not _try_native_targets(path, feature, mode, chr2tid, acc):
            _parse_bed3(path, chr2tid, acc)
    elif mode == MODE_BED4:
        if not _try_native_targets(path, feature, mode, chr2tid, acc):
            _parse_bed4(path, chr2tid, acc)
    else:
        raise ValueError(f"parse_targets: bad mode {mode}")
    return acc.build()


def _parse_gff(path: str, feature: str, chr2tid: Dict[str, int],
               acc: GeneAccumulator) -> None:
    for line in iter_text_lines(path):
        if not line or line.startswith("#"):
            continue
        toks = line.split()
        if len(toks) < 9:
            continue
        if toks[2] != feature:
            continue
        chrom, start, end = toks[0], int(toks[3]), int(toks[4])
        # reference split() drops empty tokens (include/comm.h:87-98)
        attrs = [t for t in re.split(r"[,;]", toks[8]) if t]
        if not attrs:
            continue
        gene_id = attrs[0].split("=")[-1]
        for a in attrs[1:]:
            kv = a.split("=")
            if kv[0] == "Parent":
                gene_id = kv[-1]
        tid = chr2tid.get(chrom)
        if tid is None:
            _warn_region(line)
            continue
        acc.add(tid, gene_id, start, end)


def _parse_gtf(path: str, feature: str, chr2tid: Dict[str, int],
               acc: GeneAccumulator) -> None:
    for line in iter_text_lines(path):
        if not line or line.startswith("#"):
            continue
        clean = line.replace('"', "").replace(";", "")
        toks = [t for t in _WS_SPLIT.split(clean) if t]
        if len(toks) < 10:
            continue
        if toks[2] != feature:
            continue
        chrom, start, end = toks[0], int(toks[3]), int(toks[4])
        gene_id = toks[9]  # quirk Q3: always attribute token 10
        tid = chr2tid.get(chrom)
        if tid is None:
            _warn_region(line)
            continue
        acc.add(tid, gene_id, start, end)


def _parse_bed3(path: str, chr2tid: Dict[str, int],
                acc: GeneAccumulator) -> None:
    # StartStr/EndStr live outside the reference's line loop
    # (src/PanDepth.cpp:3742-3744): short rows inherit the previous
    # row's column strings.
    start_s = end_s = ""
    for line in iter_text_lines(path):
        if not line or line.startswith("#"):
            continue
        toks = line.split()
        if not toks:
            continue
        chrom = toks[0]
        if len(toks) > 1:
            start_s = toks[1]
        if len(toks) > 2:
            end_s = toks[2]
        gene_id = f"{chrom}_{start_s}_{end_s}"
        start, end = _atoi(start_s), _atoi(end_s)
        if start > end:
            _warn_region(line)
            continue
        tid = chr2tid.get(chrom)
        if tid is None:
            _warn_region(line)
            continue
        acc.add(tid, gene_id, start, end)


def _parse_bed4(path: str, chr2tid: Dict[str, int],
                acc: GeneAccumulator) -> None:
    # The reference extracts with `isone >> Chr >> Start >> End >>
    # GeneID` where GeneID is declared OUTSIDE the loop
    # (src/PanDepth.cpp:3547,3652): a row with fewer than 4 columns
    # leaves GeneID holding the PREVIOUS row's id (empty for the
    # first), and missing ints read as 0 (C++11 failed extraction).
    gene_id = ""
    for line in iter_text_lines(path):
        if not line or line.startswith("#"):
            continue
        toks = line.split()
        if not toks:
            continue
        chrom = toks[0]
        start = int(toks[1]) if len(toks) > 1 and _is_int(toks[1]) else 0
        end = int(toks[2]) if len(toks) > 2 and _is_int(toks[2]) else 0
        if len(toks) > 3:
            gene_id = toks[3]
        if start > end:
            _warn_region(line)
            continue
        tid = chr2tid.get(chrom)
        if tid is None:
            _warn_region(line)
            continue
        acc.add(tid, gene_id, start, end)


def _is_int(s: str) -> bool:
    return bool(re.match(r"[+-]?\d+$", s))
