"""CRAM 3.0 writer.

Produces spec-conforming CRAM from BAM-style records: one slice per
container, multi-reference slices (RI data series), absolute positions,
every data series in its own EXTERNAL block (gzip-compressed), read
names preserved, no quality scores. htslib — embedded in the reference
pandepth binary — accepts this output, which the parity tests use as an
interoperability oracle (there is no samtools/pysam in this
environment to generate CRAM fixtures otherwise).
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

from pandepth_jax.io.bam_writer import cigar_str_to_ops
from pandepth_jax.io.cram import (BLOCK_GZIP, BLOCK_RAW, CRAM_MAGIC,
                                  CT_COMPRESSION_HEADER, CT_CORE,
                                  CT_EXTERNAL, CT_FILE_HEADER,
                                  CT_SLICE_HEADER, block_write,
                                  itf8_write, ltf8_write)

# canonical 38-byte CRAM v3 EOF container
CRAM_EOF = bytes.fromhex(
    "0f000000ffffffff0fe0454f4600000000010005bdd94f0001000606010001"
    "000100ee63014b")

# external block content ids per data series
_SERIES = ["BF", "CF", "RI", "RL", "AP", "RG", "MF", "NS", "NP", "TS",
           "NF", "TL", "FN", "FC", "FP", "DL", "HC", "PD", "RS", "MQ",
           "BA"]
_CID = {s: i + 1 for i, s in enumerate(_SERIES)}
_CID["RN"] = len(_SERIES) + 1
_CID["IN"] = len(_SERIES) + 2
_CID["SC"] = len(_SERIES) + 3

CF_DETACHED = 2


def _enc_external(cid: int) -> bytes:
    params = itf8_write(cid)
    return itf8_write(1) + itf8_write(len(params)) + params


# core bit codecs: (kind, offset, param) -> spec encoding id
_CORE_IDS = {"golomb": 2, "subexp": 7, "golomb_rice": 8}
# series the writer emits in decode order directly on the record loop
# (feature payload series go through a per-record sub-stream whose
# core bits would land out of order, so they stay EXTERNAL)
_CORE_OK = {"BF", "CF", "RI", "RL", "AP", "RG", "MF", "NS", "NP", "TS",
            "TL", "FN", "MQ"}


def _enc_core(spec: Tuple[str, int, int]) -> bytes:
    kind, offset, param = spec
    params = itf8_write(offset) + itf8_write(param)
    return itf8_write(_CORE_IDS[kind]) + itf8_write(len(params)) + params


class _BitWriter:
    """MSB-first core bit stream (CRAM 3.0 spec §2.1)."""

    def __init__(self):
        self.out = bytearray()
        self.cur = 0
        self.nbits = 0

    def write_bits(self, v: int, n: int) -> None:
        for i in range(n - 1, -1, -1):
            self.cur = (self.cur << 1) | ((v >> i) & 1)
            self.nbits += 1
            if self.nbits == 8:
                self.out.append(self.cur)
                self.cur = 0
                self.nbits = 0

    def write_unary(self, q: int) -> None:
        for _ in range(q):
            self.write_bits(1, 1)
        self.write_bits(0, 1)

    def getvalue(self) -> bytes:
        if self.nbits:
            return bytes(self.out) + bytes([self.cur <<
                                            (8 - self.nbits)])
        return bytes(self.out)


def _core_put(bw: _BitWriter, spec: Tuple[str, int, int],
              v: int) -> None:
    """Encode one value with a core bit codec (the encoder twins of
    io/cram.py GolombCodec/SubexpCodec; htslib's decoder is the
    interop oracle)."""
    kind, offset, param = spec
    x = v + offset
    if x < 0:
        raise ValueError(f"{kind} cannot encode {v} at offset {offset}")
    if kind in ("golomb", "golomb_rice"):
        m = param
        q, r = divmod(x, m)
        bw.write_unary(q)
        if m > 1:
            b = max((m - 1).bit_length(), 1)
            t = (1 << b) - m
            if r < t:
                bw.write_bits(r, b - 1)
            else:
                bw.write_bits(r + t, b)
    else:  # subexp
        k = param
        if x < (1 << k):
            bw.write_unary(0)
            bw.write_bits(x, k)
        else:
            b = x.bit_length() - 1
            bw.write_unary(b - k + 1)
            bw.write_bits(x & ((1 << b) - 1), b)


def _enc_byte_array_stop(stop: int, cid: int) -> bytes:
    params = bytes([stop]) + itf8_write(cid)
    return itf8_write(5) + itf8_write(len(params)) + params


def _compression_header(core_codecs=None) -> bytes:
    # preservation map: RN=1, AP=0 (absolute), RR=0, SM, TD
    pmap = bytearray()
    entries = 0
    for key, val in ((b"RN", b"\x01"), (b"AP", b"\x00"),
                     (b"RR", b"\x00")):
        pmap += key + val
        entries += 1
    pmap += b"SM" + bytes(5)
    entries += 1
    td_blob = b"\x00"  # one empty tag class -> TL=0 means "no tags"
    pmap += b"TD" + itf8_write(len(td_blob)) + td_blob
    entries += 1
    pmap_body = itf8_write(entries) + bytes(pmap)

    emap = bytearray()
    n = 0
    core_codecs = core_codecs or {}
    for s in _SERIES:
        if s in core_codecs:
            emap += s.encode() + _enc_core(core_codecs[s])
        else:
            emap += s.encode() + _enc_external(_CID[s])
        n += 1
    emap += b"RN" + _enc_byte_array_stop(0x09, _CID["RN"])
    emap += b"IN" + _enc_byte_array_stop(0x00, _CID["IN"])
    emap += b"SC" + _enc_byte_array_stop(0x00, _CID["SC"])
    n += 3
    emap_body = itf8_write(n) + bytes(emap)

    tmap_body = itf8_write(0)

    out = itf8_write(len(pmap_body)) + pmap_body
    out += itf8_write(len(emap_body)) + emap_body
    out += itf8_write(len(tmap_body)) + tmap_body
    return bytes(out)


def _container(ref_id: int, start: int, span: int, n_rec: int,
               counter: int, n_bases: int, blocks: List[bytes],
               landmarks: List[int]) -> bytes:
    body = b"".join(blocks)
    hdr = itf8_write(ref_id) + itf8_write(start) + itf8_write(span) + \
        itf8_write(n_rec) + ltf8_write(counter) + ltf8_write(n_bases) + \
        itf8_write(len(blocks)) + itf8_write(len(landmarks))
    for lm in landmarks:
        hdr += itf8_write(lm)
    full = struct.pack("<i", len(body)) + hdr
    crc = zlib.crc32(full) & 0xFFFFFFFF
    return full + struct.pack("<I", crc) + body


class _Streams:
    def __init__(self, core_codecs=None):
        self.d: Dict[int, bytearray] = {cid: bytearray()
                                        for cid in _CID.values()}
        self.core_codecs = core_codecs or {}
        self.core = _BitWriter()

    def put_int(self, series: str, v: int) -> None:
        spec = self.core_codecs.get(series)
        if spec is not None:
            _core_put(self.core, spec, v)
        else:
            self.d[_CID[series]] += itf8_write(v)

    def put_bytes(self, series: str, b: bytes, stop: int) -> None:
        self.d[_CID[series]] += b + bytes([stop])

    def blocks(self) -> Tuple[List[bytes], List[int]]:
        blks = []
        cids = []
        for cid, data in self.d.items():
            if data:
                blks.append(block_write(BLOCK_GZIP, CT_EXTERNAL, cid,
                                        bytes(data)))
                cids.append(cid)
        return blks, cids


def _read_features(ops: Sequence[Tuple[int, int]], streams: _Streams
                   ) -> Tuple[int, int]:
    """Emit features for one read; returns (n_features, read_len)."""
    M, I, D, N, S, H, P, EQ, X = range(9)
    rp = 1  # 1-based next read base
    nfeat = 0
    last_fp = 0

    def emit(code: str, fp: int):
        nonlocal nfeat, last_fp
        streams.put_int("FC", ord(code))
        streams.put_int("FP", fp - last_fp)
        last_fp = fp
        nfeat += 1

    read_len = sum(ln for op, ln in ops if op in (M, I, S, EQ, X))
    for op, ln in ops:
        if op in (M, EQ, X):
            rp += ln
        elif op == I:
            emit("I", rp)
            streams.put_bytes("IN", b"A" * ln, 0x00)
            rp += ln
        elif op == S:
            emit("S", rp)
            streams.put_bytes("SC", b"A" * ln, 0x00)
            rp += ln
        elif op == D:
            emit("D", rp)
            streams.put_int("DL", ln)
        elif op == N:
            emit("N", rp)
            streams.put_int("RS", ln)
        elif op == H:
            emit("H", rp)
            streams.put_int("HC", ln)
        elif op == P:
            emit("P", rp)
            streams.put_int("PD", ln)
    return nfeat, read_len


def write_cram(path: str, names: Sequence[str], lengths: Sequence[int],
               records: Sequence[Tuple],
               header_text: Optional[str] = None,
               records_per_container: int = 10000,
               index: bool = False,
               core_codecs: Optional[Dict[str, Tuple[str, int, int]]]
               = None) -> None:
    """records: (tid, pos0, flag, mapq, cigar_str[, qname]) tuples.

    ``core_codecs`` routes chosen integer data series through the CORE
    bit stream instead of EXTERNAL blocks: a dict like
    ``{"MQ": ("subexp", 0, 2), "RL": ("golomb", 0, 37),
    "FN": ("golomb_rice", 0, 4)}`` (kind, offset, parameter). Only
    series emitted directly on the record loop are eligible
    (``_CORE_OK``) — feature payload series buffer per record and
    would interleave out of decode order. Used by the codec-coverage
    fixtures (io/cram.py GolombCodec/SubexpCodec).

    ``index=True`` also writes ``path + ".crai"`` (CRAM spec §12: gzip
    TSV of seq_id, 1-based start, span, container byte offset, slice
    byte offset inside the container, slice size — one line per
    reference contributing to each multi-ref slice), the same shape
    htslib's cram_index_build emits and sam_index_load consumes
    (the layer under the reference's indexed fetch,
    /root/reference/src/PanDepth.cpp:4120-4124)."""
    if core_codecs:
        bad = set(core_codecs) - _CORE_OK
        if bad:
            raise ValueError(f"series not core-codable: {sorted(bad)}")
    if header_text is None:
        header_text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
            f"@SQ\tSN:{n}\tLN:{ln}\n" for n, ln in zip(names, lengths))

    out = bytearray()
    out += CRAM_MAGIC + bytes([3, 0])
    fid = b"pandepth_jax_cram\x00\x00\x00"
    out += fid[:20]

    # file header container: the SAM text in one RAW block, int32 length
    text = header_text.encode()
    hdr_payload = struct.pack("<i", len(text)) + text
    hdr_block = block_write(BLOCK_RAW, CT_FILE_HEADER, 0, hdr_payload)
    out += _container(-1, 0, 0, 0, 0, 0, [hdr_block], [0])

    counter = 0
    crai_lines: List[str] = []
    for c0 in range(0, len(records), records_per_container):
        chunk = records[c0: c0 + records_per_container]
        container_off = len(out)
        streams = _Streams(core_codecs)
        n_bases = 0
        for ri, rec in enumerate(chunk):
            tid, pos, flag, mapq, cigar = rec[:5]
            qname = rec[5] if len(rec) > 5 else f"r{counter + ri}"
            ops = cigar_str_to_ops(cigar) if cigar and cigar != "*" \
                else []
            mapped = not (flag & 4)
            streams.put_int("BF", flag)
            streams.put_int("CF", CF_DETACHED)
            streams.put_int("RI", tid)
            if mapped and ops:
                read_len = sum(ln for op, ln in ops
                               if op in (0, 1, 4, 7, 8))
            else:
                read_len = 0
            streams.put_int("RL", read_len)
            streams.put_int("AP", pos + 1)
            streams.put_int("RG", -1)
            streams.put_bytes("RN", qname.encode(), 0x09)
            # detached mate fields
            mf = (1 if flag & 0x20 else 0) | (2 if flag & 0x8 else 0)
            streams.put_int("MF", mf)
            streams.put_int("NS", -1)
            streams.put_int("NP", 0)
            streams.put_int("TS", 0)
            streams.put_int("TL", 0)
            if mapped:
                feat_streams = _Streams()
                nfeat, _ = _read_features(ops, feat_streams)
                streams.put_int("FN", nfeat)
                for cid, data in feat_streams.d.items():
                    streams.d[cid] += data
                streams.put_int("MQ", mapq)
            n_bases += read_len
        ext_blocks, cids = streams.blocks()
        comp_block = block_write(BLOCK_GZIP, CT_COMPRESSION_HEADER, 0,
                                 _compression_header(core_codecs))
        core_block = block_write(BLOCK_RAW, CT_CORE, 0,
                                 streams.core.getvalue())
        slice_hdr = itf8_write(-2) + itf8_write(0) + itf8_write(0) + \
            itf8_write(len(chunk)) + ltf8_write(counter) + \
            itf8_write(1 + len(ext_blocks)) + \
            itf8_write(len(cids))
        for cid in cids:
            slice_hdr += itf8_write(cid)
        slice_hdr += itf8_write(-1)  # embedded ref block id
        slice_hdr += bytes(16)       # MD5 (RR=false)
        slice_block = block_write(BLOCK_RAW, CT_SLICE_HEADER, 0,
                                  bytes(slice_hdr))
        blocks = [comp_block, slice_block, core_block] + ext_blocks
        landmarks = [len(comp_block)]
        out += _container(-2, 0, 0, len(chunk), counter, n_bases,
                          blocks, landmarks)
        if index:
            slice_size = len(slice_block) + len(core_block) + \
                sum(len(b) for b in ext_blocks)
            spans: Dict[int, Tuple[int, int]] = {}
            for rec in chunk:
                tid, pos, flag, _mq, cigar = rec[:5]
                ops = cigar_str_to_ops(cigar) if cigar and \
                    cigar != "*" else []
                span = sum(ln for op, ln in ops
                           if op in (0, 2, 3, 7, 8)) if not (flag & 4) \
                    else 0
                s1, e1 = pos + 1, pos + 1 + max(span, 0)
                lo, hi = spans.get(tid, (s1, e1))
                spans[tid] = (min(lo, s1), max(hi, e1))
            for tid in sorted(spans):
                lo, hi = spans[tid]
                crai_lines.append(
                    f"{tid}\t{lo}\t{hi - lo}\t{container_off}\t"
                    f"{landmarks[0]}\t{slice_size}\n")
        counter += len(chunk)

    out += CRAM_EOF
    with open(path, "wb") as fh:
        fh.write(bytes(out))
    if index:
        import gzip

        with gzip.open(path + ".crai", "wt") as fh:
            fh.writelines(crai_lines)
