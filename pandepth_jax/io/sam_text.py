"""SAM text decoding to the same columnar ``ReadBatch`` as BAM.

The reference accepts SAM transparently through hts_open; we parse the
text form directly (header @SQ lines define the contig table).
"""

from __future__ import annotations

import re
from typing import Iterator, List

import numpy as np

from pandepth_jax.io.bam import BamHeader, ReadBatch
from pandepth_jax.io.bgzf import BgzfReader

_CIG_RE = re.compile(rb"(\d+)([MIDNSHP=X])")
_OP_OF = {b"M"[0]: 0, b"I"[0]: 1, b"D"[0]: 2, b"N"[0]: 3, b"S"[0]: 4,
          b"H"[0]: 5, b"P"[0]: 6, b"="[0]: 7, b"X"[0]: 8}


class SamReader:
    """Reads SAM (optionally gzipped) into header + columnar batches."""

    def __init__(self, path: str):
        self._data = BgzfReader(path).data
        lines = self._data.split(b"\n")
        names: List[str] = []
        lengths: List[int] = []
        text_lines: List[bytes] = []
        body_start = 0
        for i, ln in enumerate(lines):
            if ln.startswith(b"@"):
                text_lines.append(ln)
                if ln.startswith(b"@SQ"):
                    sn, l = None, None
                    for f in ln.split(b"\t")[1:]:
                        if f.startswith(b"SN:"):
                            sn = f[3:].decode()
                        elif f.startswith(b"LN:"):
                            l = int(f[3:])
                    if sn is not None and l is not None:
                        names.append(sn)
                        lengths.append(l)
            else:
                body_start = i
                break
        else:
            body_start = len(lines)
        self._body = lines[body_start:]
        text = b"\n".join(text_lines)
        if text_lines:
            text += b"\n"
        self.header = BamHeader(text=text.decode("utf-8", "replace"),
                                names=names,
                                lengths=np.asarray(lengths, np.int64))
        self._tid_of = {n.encode(): i for i, n in enumerate(names)}

    def batches(self, max_reads: int = 1 << 18) -> Iterator[ReadBatch]:
        tid, pos, flag, mapq, n_ops = [], [], [], [], []
        op_code: List[int] = []
        op_len: List[int] = []
        op_read: List[int] = []

        def emit() -> ReadBatch:
            batch = ReadBatch(
                tid=np.asarray(tid, np.int32),
                pos=np.asarray(pos, np.int32),
                flag=np.asarray(flag, np.int32),
                mapq=np.asarray(mapq, np.int32),
                n_ops=np.asarray(n_ops, np.int32),
                op_code=np.asarray(op_code, np.int32),
                op_len=np.asarray(op_len, np.int32),
                op_read=np.asarray(op_read, np.int32),
            )
            for lst in (tid, pos, flag, mapq, n_ops, op_code, op_len, op_read):
                lst.clear()
            return batch

        for ln in self._body:
            if not ln or ln.startswith(b"@"):
                continue
            f = ln.split(b"\t")
            if len(f) < 11:
                continue
            rid = len(tid)
            tid.append(self._tid_of.get(f[2], -1))
            pos.append(int(f[3]) - 1)  # SAM POS is 1-based
            flag.append(int(f[1]))
            mapq.append(int(f[4]))
            cig = f[5]
            cnt = 0
            if cig != b"*":
                for m in _CIG_RE.finditer(cig):
                    op_len.append(int(m.group(1)))
                    op_code.append(_OP_OF[m.group(2)[0]])
                    op_read.append(rid)
                    cnt += 1
            n_ops.append(cnt)
            if len(tid) >= max_reads:
                yield emit()
        if tid:
            yield emit()
