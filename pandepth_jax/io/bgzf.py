"""BGZF (blocked gzip) container support.

BGZF is the framing used by BAM/.bai/tabix: a concatenation of gzip
members, each at most 64 KiB of uncompressed payload, carrying a BSIZE
extra field so readers can hop block-to-block without inflating.
(Format spec: SAMv1, section 4.1; the reference consumes it through
htslib's libdeflate-backed BGZF layer, lib/libhts.a.)

This module is the pure-Python implementation; the C++ fast path
(``pandepth_jax.io.native``) supersedes it for throughput but both honor
the same interface so tests can cross-check them.
"""

from __future__ import annotations

import struct
import zlib
from typing import BinaryIO, Iterator, List, Tuple

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_HDR = struct.Struct("<4BI2BH")  # magic1 magic2 CM FLG MTIME XFL OS XLEN


class BgzfError(ValueError):
    pass


def _parse_block_header(buf: bytes, off: int) -> Tuple[int, int]:
    """Return (payload_offset, block_size) for the BGZF block at ``off``."""
    if len(buf) - off < 18:
        raise BgzfError("truncated BGZF block header")
    if buf[off] != 0x1F or buf[off + 1] != 0x8B:
        raise BgzfError("not a gzip member (bad magic)")
    flg = buf[off + 3]
    if not flg & 4:  # FEXTRA
        raise BgzfError("gzip member without BGZF extra field")
    xlen = struct.unpack_from("<H", buf, off + 10)[0]
    # scan extra subfields for BC
    p = off + 12
    end = p + xlen
    bsize = -1
    while p + 4 <= end:
        si1, si2, slen = buf[p], buf[p + 1], struct.unpack_from("<H", buf, p + 2)[0]
        if si1 == 0x42 and si2 == 0x43 and slen == 2:
            bsize = struct.unpack_from("<H", buf, p + 4)[0] + 1
        p += 4 + slen
    if bsize < 0:
        raise BgzfError("BGZF BC subfield missing")
    return end, bsize


def iter_block_ranges(data: bytes) -> Iterator[Tuple[int, int, int]]:
    """Yield (block_offset, compressed_size, payload_offset) per block."""
    off = 0
    n = len(data)
    while off < n:
        payload_off, bsize = _parse_block_header(data, off)
        yield off, bsize, payload_off
        off += bsize


def decompress_block(data: bytes, block_off: int, payload_off: int,
                     bsize: int) -> bytes:
    cdata = data[payload_off: block_off + bsize - 8]
    isize = struct.unpack_from("<I", data, block_off + bsize - 4)[0]
    out = zlib.decompress(cdata, wbits=-15)
    if len(out) != isize:
        raise BgzfError("BGZF ISIZE mismatch")
    return out


def decompress_all(data: bytes) -> bytes:
    """Inflate an entire in-memory BGZF byte string."""
    parts: List[bytes] = []
    for off, bsize, payload in iter_block_ranges(data):
        parts.append(decompress_block(data, off, payload, bsize))
    return b"".join(parts)


class BgzfReader:
    """Streaming BGZF reader over a file object (whole-file buffered).

    Also accepts plain (non-BGZF) gzip streams and uncompressed input so
    SAM/text callers can reuse it.
    """

    def __init__(self, path: str):
        with open(path, "rb") as fh:
            raw = fh.read()
        self.raw = raw
        if raw[:2] == b"\x1f\x8b":
            try:
                self.data = decompress_all(raw)
            except BgzfError:
                self.data = zlib.decompress(raw, wbits=31)
        else:
            self.data = raw
        self.pos = 0

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            out = self.data[self.pos:]
            self.pos = len(self.data)
            return out
        out = self.data[self.pos: self.pos + n]
        self.pos += len(out)
        return out

    def seek(self, pos: int) -> None:
        self.pos = pos


class BgzfWriter:
    """BGZF writer (used by the BAM/BAI writers and fixture generators)."""

    MAX_PAYLOAD = 0xFF00  # htslib convention: keep blocks < 64 KiB compressed

    def __init__(self, fh: BinaryIO, level: int = 6):
        self._fh = fh
        self._level = level
        self._buf = bytearray()

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= self.MAX_PAYLOAD:
            self._flush_block(bytes(self._buf[: self.MAX_PAYLOAD]))
            del self._buf[: self.MAX_PAYLOAD]

    def _flush_block(self, payload: bytes) -> None:
        co = zlib.compressobj(self._level, zlib.DEFLATED, -15)
        cdata = co.compress(payload) + co.flush()
        bsize = len(cdata) + 26  # 18 header + 8 trailer
        hdr = struct.pack(
            "<4BI2BH2BH H", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6, 0x42, 0x43, 2,
            bsize - 1,
        )
        trailer = struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF,
                              len(payload))
        self._fh.write(hdr + cdata + trailer)

    def close(self) -> None:
        if self._buf:
            self._flush_block(bytes(self._buf))
            self._buf.clear()
        self._fh.write(BGZF_EOF)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
