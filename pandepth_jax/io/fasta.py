"""FASTA reading (kseq-equivalent) and reference-base tables.

The reference streams the ``-r`` fasta with kseq (include/kseq.h) and
stores sequences keyed by tid via ``Chr2IntMap[name]`` — note that C++
``map::operator[]`` *inserts 0* for unknown names and ``RefBase.insert``
never overwrites, so a non-header contig appearing before the real
tid-0 contig shadows it (src/PanDepth.cpp:3513-3527). Replicated
faithfully in ``load_ref_bases``.
"""

from __future__ import annotations

import gzip
from typing import Dict, Iterator, Optional, Tuple


_KSEQ_SPACE = b" \t\n\v\f\r"


def _iter_lines(fh) -> Iterator[Tuple[bytes, bool]]:
    """(line_without_newline, had_newline) pairs; the '\\n' terminator
    is consumed. A final piece without a terminator is yielded with
    ``had_newline=False`` (nothing is yielded for a trailing '\\n')."""
    buf = b""
    while True:
        chunk = fh.read(1 << 20)
        if not chunk:
            break
        buf += chunk
        start = 0
        while True:
            nl = buf.find(b"\n", start)
            if nl < 0:
                break
            yield buf[start:nl], True
            start = nl + 1
        buf = buf[start:]
    if buf:
        yield buf, False


def iter_fasta(path: str) -> Iterator[Tuple[str, bytes]]:
    """Yield (name, sequence) pairs with EXACT kseq.h semantics (the
    reference's -r reader, include/kseq.h:185-224) — byte-parity on
    pathological files demands the full contract, established against
    the reference headers:

    - a record starts at any '>' or '@' byte (even mid-line in junk);
      name = bytes until the first isspace() (possibly empty), rest of
      that line is a discarded comment;
    - sequence lines: empty lines skipped; a line-initial '>'/'@'
      starts the next record; every line is appended VERBATIM (a
      mid-line '\\r' is a length-occupying base) except that ONE
      trailing '\\r' is dropped per line — and only when the
      cumulative sequence length exceeds 1 (kseq.h:138's l>1 guard:
      a lone leading '\\r' survives);
    - at EOF without a newline the trim needs the final line to have
      >= 2 chars (kseq's manual first-char append is not trimmed when
      ks_getuntil2 reads nothing);
    - a line-initial '+' switches to FASTQ quality reading: the '+'
      line is discarded, then raw lines (same '\\r' trim against the
      cumulative QUALITY length) accumulate until qual_len >= seq_len.
      qual_len == seq_len emits the record and scanning continues;
      anything else is kseq_read's -2, which makes the reference's
      read loop (src/PanDepth.cpp:3513) drop the record and stop
      reading the file entirely;
    - a '>' at end-of-file with nothing after it yields no record
      (ks_getuntil returns -1 on a zero-byte name read)."""
    opener = gzip.open if _is_gz(path) else open
    with opener(path, "rb") as fh:
        lines = _iter_lines(fh)
        name: Optional[str] = None
        seq = bytearray()
        state = "scan"          # scan | seq | qual
        qual_len = 0
        seq_pending: Optional[bytearray] = None

        def start_header(line: bytes, pos: int, had_nl: bool):
            """Parse a record start at line[pos-1]; returns the new
            (name, emitted_ok) — emitted_ok False only for the
            '>'-at-EOF no-record case."""
            rest = line[pos:]
            if not rest and not had_nl:
                return None  # '>' then EOF: ks_getuntil -1, no record
            end = len(rest)
            for i, ch in enumerate(rest):
                if ch in _KSEQ_SPACE:
                    end = i
                    break
            return rest[:end].decode()  # utf-8, like the BAM header names

        for line, had_nl in lines:
            while True:
                if state == "scan":
                    p1, p2 = line.find(b">"), line.find(b"@")
                    p = p1 if p2 < 0 else (p2 if p1 < 0 else min(p1, p2))
                    if p < 0:
                        break
                    if name is not None:
                        yield name, bytes(seq)
                    nm = start_header(line, p + 1, had_nl)
                    if nm is None:
                        name = None
                        break
                    name, seq, state = nm, bytearray(), "seq"
                    break
                if state == "seq":
                    if not line:
                        break
                    c0 = line[0]
                    if c0 in b">@":
                        yield name, bytes(seq)
                        nm = start_header(line, 1, had_nl)
                        if nm is None:
                            name, state = None, "scan"
                            break
                        name, seq = nm, bytearray()
                        break
                    if c0 == ord("+"):
                        if not had_nl:
                            return  # EOF while skipping the '+' line
                            # itself: kseq_read -2 before any quality
                            # logic — record dropped, file abandoned
                        state, qual_len = "qual", 0
                        seq_pending = seq
                        break
                    seq += line
                    if line[-1] == 13 and len(seq) > 1 and \
                            (had_nl or len(line) >= 2):
                        del seq[-1]
                    break
                if state == "qual":
                    qual_len += len(line)
                    if line and line[-1] == 13 and qual_len > 1:
                        qual_len -= 1
                    if qual_len >= len(seq_pending):
                        if qual_len != len(seq_pending):
                            return  # kseq_read -2: drop record, stop
                        yield name, bytes(seq_pending)
                        name, seq, state = None, bytearray(), "scan"
                        seq_pending = None
                    break
        if state == "qual":
            # EOF in quality: ks_getuntil2 returns -1 and the equality
            # check still runs — qual_len == seq_len (only possible as
            # 0 == 0, e.g. "+\n" then EOF) emits; anything else is the
            # -2 drop-and-stop
            if qual_len == len(seq_pending):
                yield name, bytes(seq_pending)
            return
        if name is not None:
            yield name, bytes(seq)


def _is_gz(path: str) -> bool:
    with open(path, "rb") as fh:
        return fh.read(2) == b"\x1f\x8b"


def iter_fasta_gc(path: str) -> Iterator[Tuple[str, PackedGC]]:
    """(name, PackedGC) per contig — native streaming scanner when the
    C++ library is available (one pass, no whole-contig byte buffers),
    Python iter_fasta otherwise."""
    try:
        import ctypes

        from pandepth_jax.io.native import load_library

        lib = load_library()  # None under PANDEPTH_NO_NATIVE=1
    except Exception:
        lib = None
    if lib is not None:
        import numpy as np

        err = ctypes.create_string_buffer(256)
        h = lib.pancov_fasta_gc_load(path.encode(), err, 256)
        if h:
            try:
                nbuf = ctypes.create_string_buffer(4096)
                for i in range(lib.pancov_fasta_gc_count(h)):
                    ln = lib.pancov_fasta_gc_name(h, i, nbuf, 4096)
                    if ln < 0:
                        raise ValueError("fasta contig name too long")
                    sz = lib.pancov_fasta_gc_packed_size(h, i)
                    packed = np.empty(sz, np.uint8)
                    if sz:
                        lib.pancov_fasta_gc_copy(h, i, packed)
                    # raw[:ln], not .value: kseq names may contain NUL
                    yield (nbuf.raw[:ln].decode(),
                           PackedGC.from_packed(
                               packed, lib.pancov_fasta_gc_len(h, i)))
            finally:
                lib.pancov_fasta_gc_free(h)
            return
    for name, seq in iter_fasta(path):
        yield name, PackedGC(seq)


def load_ref_bases(path: str, chr2tid: Dict[str, int]
                   ) -> Dict[int, PackedGC]:
    """tid -> packed G/C indicator, with the reference's insert-only /
    default-0 lookup quirks (src/PanDepth.cpp:3513-3527).

    Contigs are packed as they stream (PackedGC): the raw bytes of a
    3 Gb reference would alone exhaust this host's fast-backed RSS
    budget (~3.5 GB; see PackedGC)."""
    out: Dict[int, PackedGC] = {}
    lookup = dict(chr2tid)
    for name, gc in iter_fasta_gc(path):
        tid = lookup.setdefault(name, 0)
        if tid not in out:
            out[tid] = gc
    return out


class PackedGC:
    """1-bit-per-base G/C indicator for one contig (bitorder little).

    A 3 Gb reference held as raw bytes costs 3 GB of RSS; this host's
    VMM backs guest memory fast only up to ~3.5-4 GB of process RSS
    (beyond that every fresh page faults at ~100 us, measured), so the
    raw-bytes representation starved everything after the load. The
    indicator is 8x smaller (31 MB per 250 Mb contig) and GC range
    counts come from popcounts over it."""

    __slots__ = ("packed", "n")

    def __init__(self, seq: bytes):
        import numpy as np

        arr = np.frombuffer(seq, np.uint8)
        self.n = arr.shape[0]
        low = arr | 0x20                  # ASCII upper -> lower
        is_gc = (low == ord("g")) | (low == ord("c"))
        self.packed = np.packbits(is_gc, bitorder="little")

    def __len__(self) -> int:
        return self.n

    @classmethod
    def from_packed(cls, packed, n: int) -> "PackedGC":
        obj = object.__new__(cls)
        obj.packed = packed
        obj.n = int(n)
        return obj

    def count_ranges(self, starts, ends) -> "np.ndarray":
        """GC counts over 1-based inclusive [start, end] ranges (same
        clipping semantics as gc_count_ranges on raw bytes)."""
        import numpy as np

        n = self.n
        s = np.clip(np.asarray(starts, np.int64) - 1, 0, n)
        e = np.clip(np.asarray(ends, np.int64), 0, n)
        e = np.maximum(e, s)
        if s.shape[0] == 0:
            return np.zeros(0, np.int64)
        packed = self.packed
        nb = packed.shape[0]
        if nb == 0:
            return np.zeros(s.shape[0], np.int64)
        bitcnt = np.bitwise_count(packed)
        bs = (s + 7) >> 3                 # first full byte
        be = e >> 3                       # end of full bytes
        idx = np.empty(2 * s.shape[0], np.int64)
        idx[0::2] = bs
        idx[1::2] = np.maximum(be, bs)
        pad = np.zeros(nb + 1, np.uint8)
        pad[:nb] = bitcnt
        full = np.add.reduceat(pad, np.minimum(idx, nb),
                               dtype=np.int64)[0::2]
        full[be <= bs] = 0
        # head: bits [s, min(e, 8*bs)) of byte s>>3, only when s
        # isn't byte-aligned (aligned starts have no partial head)
        hb = s >> 3
        a = s & 7                         # int64: 1 << 8 must not wrap
        b = np.minimum(a + (e - s), 8)
        hmask = (((1 << b) - 1) ^ ((1 << a) - 1)).astype(np.uint8)
        head = np.bitwise_count(
            packed[np.minimum(hb, nb - 1)] & hmask).astype(np.int64)
        head[a == 0] = 0
        # tail: bits [8*be, e) of byte be, when e isn't aligned and
        # the tail byte isn't already covered by the head
        tmask = ((1 << (e & 7)) - 1).astype(np.uint8)
        tail = np.bitwise_count(
            packed[np.minimum(be, nb - 1)] & tmask).astype(np.int64)
        tail[((e & 7) == 0) | (be < bs)] = 0
        return full + head + tail


def gc_count_ranges(seq, starts, ends) -> "np.ndarray":
    """GC base counts over 1-based inclusive [start, end] ranges
    (counts G,g,C,c only — N and friends count 0 but still occupy
    length, src/PanDepth.cpp:947-949). ``seq`` is raw bytes or a
    :class:`PackedGC`.

    One ``np.add.reduceat`` pass over an int8 indicator instead of an
    int64 prefix sum: the prefix materialized 8 bytes/base (2 GB per
    250 Mb contig — measured minutes of page-fault stalls per contig
    on a 3 Gb reference on this host); the indicator is 1 byte/base
    and the reduction allocates nothing per-base."""
    import numpy as np

    if isinstance(seq, PackedGC):
        return seq.count_ranges(starts, ends)
    arr = np.frombuffer(seq, np.uint8)
    n = arr.shape[0]
    s = np.clip(np.asarray(starts, np.int64) - 1, 0, n)
    e = np.clip(np.asarray(ends, np.int64), 0, n)
    e = np.maximum(e, s)
    if s.shape[0] == 0:
        return np.zeros(0, np.int64)
    low = arr | 0x20                      # ASCII upper -> lower
    ind = np.zeros(n + 1, np.int8)        # +1: index n is addressable
    np.logical_or(low == ord("g"), low == ord("c"), out=ind[:n].view(bool))
    idx = np.empty(2 * s.shape[0], np.int64)
    idx[0::2] = s
    idx[1::2] = e
    # reduceat pairs: [s_i, e_i) sums at even slots (odd slots are the
    # gaps, ignored); an empty range yields data[s_i], zeroed below
    out = np.add.reduceat(ind, idx, dtype=np.int64)[0::2]
    out[e == s] = 0
    return out
