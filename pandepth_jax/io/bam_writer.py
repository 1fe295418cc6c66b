"""BAM + BAI writing.

Used by the test-fixture generators (the reference repo ships no test
data, SURVEY.md §4) and available as a general utility. The BAI builder
follows the SAMv1 spec binning scheme so htslib-based tools accept the
index.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pandepth_jax.io.bgzf import BGZF_EOF
import zlib

_OP_CHARS = "MIDNSHP=X"
_OP_OF = {c: i for i, c in enumerate(_OP_CHARS)}
_SEQ_NT16 = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
_REF_CONSUME = {0, 2, 3, 7, 8}
CIGAR_N_OP, CIGAR_S_OP = 3, 4


def cigar_str_to_ops(cig: str) -> List[Tuple[int, int]]:
    ops: List[Tuple[int, int]] = []
    num = ""
    for ch in cig:
        if ch.isdigit():
            num += ch
        else:
            ops.append((_OP_OF[ch], int(num)))
            num = ""
    return ops


def ref_span(ops: Sequence[Tuple[int, int]]) -> int:
    return sum(l for op, l in ops if op in _REF_CONSUME)


def reg2bin(beg: int, end: int) -> int:
    """SAMv1 spec 5.3 bin function for a 0-based half-open interval."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def encode_record(tid: int, pos: int, flag: int, mapq: int, cigar: str,
                  qname: str = "r", seq: Optional[str] = None) -> bytes:
    ops = cigar_str_to_ops(cigar) if cigar and cigar != "*" else []
    read_len = sum(l for op, l in ops if op in (0, 1, 4, 7, 8))
    if seq is None and read_len:
        seq = "A" * read_len
    seq = seq or ""
    span = ref_span(ops)
    end = pos + span if span > 0 else pos + 1
    # BAM caps n_cigar at 2^16-1: store the htslib placeholder
    # (l_qseq S, ref_span N) in the CIGAR field and the real ops in a
    # CG:B,I aux tag (the convention bam_tag2cigar reverses on read)
    use_cg = len(ops) > 0xFFFF and len(seq) > 0
    stored = [(CIGAR_S_OP, len(seq)), (CIGAR_N_OP, span)] if use_cg \
        else ops
    name_b = qname.encode() + b"\x00"
    rec = struct.pack("<iiBBHHHiiii", tid, pos, len(name_b), mapq,
                      reg2bin(pos, end) if tid >= 0 else 4680,
                      len(stored), flag, len(seq), -1, -1, 0)
    rec += name_b
    cig = np.empty(len(ops), np.uint32)
    for k, (op, l) in enumerate(ops):
        cig[k] = (l << 4) | op
    if use_cg:
        rec += struct.pack("<II", (len(seq) << 4) | CIGAR_S_OP,
                           (span << 4) | CIGAR_N_OP)
    else:
        rec += cig.tobytes()
    packed = bytearray()
    for i in range(0, len(seq), 2):
        hi = _SEQ_NT16.get(seq[i].upper(), 15) << 4
        lo = _SEQ_NT16.get(seq[i + 1].upper(), 15) if i + 1 < len(seq) else 0
        packed.append(hi | lo)
    rec += bytes(packed)
    rec += b"\xff" * len(seq)  # qual: missing
    if use_cg:
        rec += b"CGBI" + struct.pack("<I", len(ops)) + cig.tobytes()
    return struct.pack("<i", len(rec)) + rec


class _BlockTrackingBgzf:
    """BGZF writer that records (uncompressed_start, file_offset) per block
    so virtual file offsets can be reconstructed for the BAI."""

    MAX_PAYLOAD = 0xFF00

    def __init__(self, fh):
        self._fh = fh
        self._buf = bytearray()
        self.blocks: List[Tuple[int, int]] = []  # (u_start, file_off)
        self._u_written = 0

    @property
    def u_pos(self) -> int:
        return self._u_written + len(self._buf)

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= self.MAX_PAYLOAD:
            self._flush(bytes(self._buf[: self.MAX_PAYLOAD]))
            del self._buf[: self.MAX_PAYLOAD]

    def flush_block(self) -> None:
        if self._buf:
            self._flush(bytes(self._buf))
            self._buf.clear()

    def _flush(self, payload: bytes) -> None:
        self.blocks.append((self._u_written, self._fh.tell()))
        co = zlib.compressobj(6, zlib.DEFLATED, -15)
        cdata = co.compress(payload) + co.flush()
        bsize = len(cdata) + 26
        hdr = struct.pack("<4BI2BH2BH H", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
                          0x42, 0x43, 2, bsize - 1)
        self._fh.write(hdr + cdata +
                       struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                                   len(payload)))
        self._u_written += len(payload)

    def close(self) -> None:
        self.flush_block()
        self._fh.write(BGZF_EOF)

    def voffset(self, u: int) -> int:
        """Virtual offset for uncompressed position ``u`` (requires the
        block containing ``u`` to be flushed or be the next to flush)."""
        for u_start, foff in reversed(self.blocks):
            if u >= u_start:
                return (foff << 16) | (u - u_start)
        return 0


def write_bam(path: str, names: Sequence[str], lengths: Sequence[int],
              records: Sequence[Tuple], header_text: Optional[str] = None,
              make_index: bool = True) -> None:
    """Write a BAM (+ .bai) file.

    ``records``: tuples (tid, pos0, flag, mapq, cigar_str) sorted however
    the caller wants; pass coordinate-sorted input when ``make_index``.
    """
    if header_text is None:
        header_text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
            f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in zip(names, lengths))
    hdr = b"BAM\x01"
    tb = header_text.encode()
    hdr += struct.pack("<i", len(tb)) + tb
    hdr += struct.pack("<i", len(names))
    for n, l in zip(names, lengths):
        nb = n.encode() + b"\x00"
        hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", l)

    rec_marks: List[Tuple[int, int, int, int, int]] = []  # tid,pos,end,u0,u1
    with open(path, "wb") as fh:
        w = _BlockTrackingBgzf(fh)
        w.write(hdr)
        w.flush_block()  # records start on a block boundary (htslib-style)
        for tid, pos, flag, mapq, cigar, *rest in records:
            qname = rest[0] if rest else f"r{len(rec_marks)}"
            u0 = w.u_pos
            w.write(encode_record(tid, pos, flag, mapq, cigar, qname=qname))
            span = ref_span(cigar_str_to_ops(cigar)) if cigar != "*" else 0
            end = pos + span if span > 0 else pos + 1
            rec_marks.append((tid, pos, end, u0, w.u_pos))
        w.close()

        if make_index:
            _write_bai(path + ".bai", len(names), rec_marks, w)


def write_uniform_bam(path: str, names: Sequence[str],
                      lengths: Sequence[int], tid, pos, flag, mapq,
                      read_len: int = 150, make_index: bool = True,
                      compresslevel: int = 1, threads: int = 4) -> None:
    """Fast vectorized writer for benchmark-scale fixtures: every record
    has the same read length and a single ``<read_len>M`` CIGAR, so the
    record block is built with one numpy reshape and BGZF-compressed on
    a thread pool (zlib releases the GIL)."""
    import concurrent.futures

    import numpy as np

    tid = np.asarray(tid, np.int32)
    pos = np.asarray(pos, np.int32)
    flag = np.asarray(flag, np.uint16)
    mapq = np.asarray(mapq, np.uint8)
    n = tid.shape[0]

    header_text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        f"@SQ\tSN:{nm}\tLN:{ln}\n" for nm, ln in zip(names, lengths))
    hdr = b"BAM\x01"
    tb = header_text.encode()
    hdr += struct.pack("<i", len(tb)) + tb + struct.pack("<i", len(names))
    for nm, ln in zip(names, lengths):
        nb = nm.encode() + b"\x00"
        hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", ln)

    qname_len = 9  # "rXXXXXXX\0"
    seq_bytes = (read_len + 1) // 2
    body = 32 + qname_len + 4 + seq_bytes + read_len
    rec_size = 4 + body
    end = pos + read_len

    # vectorized reg2bin for typical short intervals
    b = np.full(n, 0, np.uint16)
    e1 = end - 1
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9),
                        (26, 1)):
        hit = (pos >> shift) == (e1 >> shift)
        b = np.where((b == 0) & hit, base + (pos >> shift), b)
    def build_slice(lo: int, hi: int) -> bytes:
        """Record block bytes for records [lo, hi)."""
        m = hi - lo
        rec = np.zeros((m, rec_size), np.uint8)

        def put_le(col, arr, width):
            a = np.ascontiguousarray(arr)
            raw = a.view(np.uint8).reshape(m, a.itemsize)[:, :width]
            rec[:, col: col + width] = raw

        put_le(0, np.full(m, body, np.int32), 4)
        put_le(4, tid[lo:hi], 4)
        put_le(8, pos[lo:hi], 4)
        rec[:, 12] = qname_len
        rec[:, 13] = mapq[lo:hi]
        put_le(14, b[lo:hi].astype(np.uint16), 2)
        put_le(16, np.full(m, 1, np.uint16), 2)       # n_cigar
        put_le(18, flag[lo:hi], 2)
        put_le(20, np.full(m, read_len, np.int32), 4)
        put_le(24, np.full(m, -1, np.int32), 4)
        put_le(28, np.full(m, -1, np.int32), 4)
        # tlen stays 0
        qn = np.char.add(
            "r", np.char.zfill(np.arange(lo, hi).astype("U7"), 7))
        rec[:, 36: 36 + qname_len - 1] = \
            qn.astype(f"S{qname_len - 1}").view(np.uint8).reshape(
                m, qname_len - 1)
        put_le(36 + qname_len,
               np.full(m, (read_len << 4) | 0, np.uint32), 4)
        rec[:, 40 + qname_len: 40 + qname_len + seq_bytes] = 0x11
        rec[:, 40 + qname_len + seq_bytes:] = 0xFF    # no qual
        return rec.tobytes()

    chunk = 0xFF00

    def bgzf_block(pl: bytes) -> bytes:
        co = zlib.compressobj(compresslevel, zlib.DEFLATED, -15)
        cdata = co.compress(pl) + co.flush()
        bsize = len(cdata) + 26
        return (struct.pack("<4BI2BH2BH H", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF,
                            6, 0x42, 0x43, 2, bsize - 1) + cdata +
                struct.pack("<II", zlib.crc32(pl) & 0xFFFFFFFF, len(pl)))

    # stream record slices to disk: materializing all n records at
    # once is O(n * rec_size) host memory (137 GB at the deep-coverage
    # fixture's 240M x 375 bp). The 0xFF00 payload-piece grid stays
    # GLOBAL (a carry buffer spans slice boundaries) so the virtual-
    # offset math below is unchanged.
    slice_recs = max(1, (256 << 20) // rec_size)
    block_offs: list = []
    off = 0
    with open(path, "wb") as fh, \
            concurrent.futures.ThreadPoolExecutor(threads) as ex:
        carry = hdr

        def flush(data: bytes, final: bool) -> None:
            nonlocal carry, off
            buf = carry + data
            cut = len(buf) if final else (len(buf) // chunk) * chunk
            pieces = [buf[i: i + chunk] for i in range(0, cut, chunk)]
            carry = buf[cut:]
            if not pieces:
                return
            out = []
            for blk in ex.map(bgzf_block, pieces):
                block_offs.append(off)
                off += len(blk)
                out.append(blk)
            fh.write(b"".join(out))

        for lo in range(0, n, slice_recs):
            hi = min(lo + slice_recs, n)
            flush(build_slice(lo, hi), final=(hi == n))
        if n == 0:
            flush(b"", final=True)
        fh.write(BGZF_EOF)

    if make_index:
        # map each record's uncompressed offset to a virtual offset
        u0 = len(hdr) + np.arange(n, dtype=np.int64) * rec_size
        u1 = u0 + rec_size
        blk_idx0 = u0 // chunk
        blk_idx1 = u1 // chunk
        # a record ending exactly on a 0xFF00 boundary has blk_idx1 one
        # past the last data block: its end virtual offset must point
        # just past that block (before BGZF_EOF), not back into it
        boffs = np.append(np.asarray(block_offs, np.int64), off)
        v0 = (boffs[blk_idx0] << 16) | (u0 % chunk)
        v1 = (boffs[blk_idx1] << 16) | (u1 % chunk)
        if max(lengths, default=0) >= (1 << 29):
            # BAI's 6-level binning cannot address positions >= 2^29;
            # write a CSI instead (htslib also prefers .csi when both
            # exist)
            write_csi(path + ".csi", len(names), tid, pos, end, v0, v1)
        else:
            _write_bai_from_voffsets(path + ".bai", len(names), tid,
                                     pos, end, b, v0, v1)


def write_csi(path: str, n_ref: int, tid, pos, end, v0, v1,
              min_shift: int = 14, depth: int = 6) -> None:
    """CSI v1 index (generalized binning; depth 6 covers 2^32 bases).

    Stored as plain (uncompressed) gzip-less binary is NOT allowed by
    the spec — CSI files are BGZF — so the payload is BGZF-framed.
    """
    import gzip as _gzip

    import numpy as np

    def reg2bin_csi(b0, e0):
        e0 = np.maximum(e0 - 1, b0)
        out = np.zeros(b0.shape[0], np.int64)
        done = np.zeros(b0.shape[0], bool)
        s = min_shift
        t = ((1 << (3 * depth)) - 1) // 7
        lvl_t = t
        while s <= min_shift + 3 * depth:
            hit = (~done) & ((b0 >> s) == (e0 >> s))
            lvl_t = ((1 << (3 * (depth - (s - min_shift) // 3))) - 1) \
                // 7
            out[hit] = lvl_t + (b0[hit] >> s)
            done |= hit
            s += 3
        return out

    tid = np.asarray(tid)
    pos = np.asarray(pos, np.int64)
    end = np.asarray(end, np.int64)
    bins = reg2bin_csi(pos, end)

    body = bytearray(b"CSI\x01")
    body += struct.pack("<iii", min_shift, depth, 0)
    body += struct.pack("<i", n_ref)
    for t in range(n_ref):
        sel = np.nonzero(tid == t)[0]
        if sel.size == 0:
            body += struct.pack("<i", 0)
            continue
        tb = bins[sel]
        order = np.argsort(tb, kind="stable")
        sel_s = sel[order]
        tb_s = tb[order]
        uniq, starts = np.unique(tb_s, return_index=True)
        body += struct.pack("<i", len(uniq))
        for k, bval in enumerate(uniq):
            lo = starts[k]
            hi = starts[k + 1] if k + 1 < len(uniq) else len(sel_s)
            idxs = sel_s[lo:hi]
            a = v0[idxs].astype(np.int64)
            bb = v1[idxs].astype(np.int64)
            brk = np.nonzero(bb[:-1] != a[1:])[0]
            si = np.concatenate(([0], brk + 1))
            ei = np.concatenate((brk, [len(idxs) - 1]))
            loff = int(a[0])
            body += struct.pack("<IQi", int(bval), loff, len(si))
            pairs = np.empty((len(si), 2), "<u8")
            pairs[:, 0] = a[si]
            pairs[:, 1] = bb[ei]
            body += pairs.tobytes()
    # CSI is BGZF-framed; reuse the BGZF writer
    from pandepth_jax.io.bgzf import BgzfWriter

    with open(path, "wb") as fh:
        with BgzfWriter(fh) as w:
            w.write(bytes(body))


def _write_bai_from_voffsets(path: str, n_ref: int, tid, pos, end,
                             bins, v0, v1) -> None:
    """Vectorized-ish BAI assembly from precomputed virtual offsets."""
    import numpy as np

    out = bytearray(b"BAI\x01" + struct.pack("<i", n_ref))
    for t in range(n_ref):
        sel = np.nonzero(tid == t)[0]
        if sel.size == 0:
            out += struct.pack("<ii", 0, 0)
            continue
        tb = bins[sel]
        order = np.argsort(tb, kind="stable")
        sel_s = sel[order]
        tb_s = tb[order]
        uniq, starts = np.unique(tb_s, return_index=True)
        out += struct.pack("<i", len(uniq))
        for k, bval in enumerate(uniq):
            lo = starts[k]
            hi = starts[k + 1] if k + 1 < len(uniq) else len(sel_s)
            idxs = sel_s[lo:hi]
            # merge runs of records whose chunks touch (vectorized)
            a = v0[idxs].astype(np.int64)
            bb = v1[idxs].astype(np.int64)
            brk = np.nonzero(bb[:-1] != a[1:])[0]
            si = np.concatenate(([0], brk + 1))
            ei = np.concatenate((brk, [len(idxs) - 1]))
            pairs = np.empty((len(si), 2), "<u8")
            pairs[:, 0] = a[si]
            pairs[:, 1] = bb[ei]
            out += struct.pack("<Ii", int(bval), len(si))
            out += pairs.tobytes()
        # linear index (reads span at most 2 of the 16 kb windows here)
        k0 = (pos[sel] >> 14).astype(np.int64)
        k1 = (np.maximum(end[sel] - 1, pos[sel]) >> 14).astype(np.int64)
        n_intv = int(k1.max()) + 1
        big = np.iinfo(np.int64).max
        lin = np.full(n_intv, big, np.int64)
        vv = v0[sel].astype(np.int64)
        np.minimum.at(lin, k0, vv)
        np.minimum.at(lin, k1, vv)
        filled = np.where(lin == big, 0, lin)
        # forward-fill empty windows with the previous offset
        mask = lin != big
        idx = np.where(mask, np.arange(n_intv), 0)
        np.maximum.accumulate(idx, out=idx)
        ioffs = np.where(mask[idx], filled[idx], 0)
        out += struct.pack("<i", n_intv)
        out += ioffs.astype("<u8").tobytes()
    with open(path, "wb") as fh:
        fh.write(bytes(out))


def _write_bai(path: str, n_ref: int,
               rec_marks: Sequence[Tuple[int, int, int, int, int]],
               w: _BlockTrackingBgzf) -> None:
    per_ref_bins: List[Dict[int, List[Tuple[int, int]]]] = \
        [dict() for _ in range(n_ref)]
    per_ref_lin: List[Dict[int, int]] = [dict() for _ in range(n_ref)]
    for tid, pos, end, u0, u1 in rec_marks:
        if tid < 0:
            continue
        v0, v1 = w.voffset(u0), w.voffset(u1)
        b = reg2bin(pos, end)
        chunks = per_ref_bins[tid].setdefault(b, [])
        if chunks and chunks[-1][1] == v0:
            chunks[-1] = (chunks[-1][0], v1)
        else:
            chunks.append((v0, v1))
        lin = per_ref_lin[tid]
        for k in range(pos >> 14, ((max(end - 1, pos)) >> 14) + 1):
            if k not in lin or v0 < lin[k]:
                lin[k] = v0

    out = bytearray(b"BAI\x01" + struct.pack("<i", n_ref))
    for tid in range(n_ref):
        bins = per_ref_bins[tid]
        out += struct.pack("<i", len(bins))
        for b in sorted(bins):
            chunks = bins[b]
            out += struct.pack("<Ii", b, len(chunks))
            for v0, v1 in chunks:
                out += struct.pack("<QQ", v0, v1)
        lin = per_ref_lin[tid]
        if lin:
            n_intv = max(lin) + 1
            ioff = []
            prev = 0
            for k in range(n_intv):
                prev = lin.get(k, prev)
                ioff.append(prev)
            out += struct.pack("<i", n_intv)
            out += b"".join(struct.pack("<Q", v) for v in ioff)
        else:
            out += struct.pack("<i", 0)
    with open(path, "wb") as fh:
        fh.write(bytes(out))
