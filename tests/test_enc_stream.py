"""Compact event-window encoding (the ~2 B/event device-link format
produced by pancov_stream_take_enc and decoded on-device by
sweep.finalize_encoded). Differential: encoded path vs raw take32/64
path on identical inputs, covering both escape kinds and the stall
fallback."""

import numpy as np
import pytest

from pandepth_jax.device.engine import (CoverageEngine,
                                        decode_enc_host)
from pandepth_jax.device.layout import GenomeLayout
from pandepth_jax.io.bam import read_bam_header
from pandepth_jax.io.bam_writer import write_bam


def _native_stream(path, **kw):
    from pandepth_jax.io import native

    if native.load_library() is None:
        pytest.skip(f"native build failed: {native.build_error()}")
    return native.NativeBamStream(path, 1796, -1, **kw)


def _raw_pairs(path):
    r = _native_stream(path)
    ss, ee = [], []
    while True:
        n = r.wait()
        if n < 0:
            break
        s, e = r.take64(n)
        ss.append(s)
        ee.append(e)
    r.close()
    return np.concatenate(ss), np.concatenate(ee)


def _enc_pairs(path, cap, exc_cap):
    """Decode the encoded stream on the host; exercises partial
    windows, both escape kinds, and the stall fallback."""
    r = _native_stream(path)
    ss, ee = [], []
    stalled = 0
    while True:
        n = r.wait()
        if n < 0:
            break
        while True:
            win = r.take_enc(cap, exc_cap)
            if win is None:
                break
            if win == "stall":
                stalled += 1
                m = r.win_remaining()
                s32, e32 = r.take32(max(m, 1), 2**31 - 1)
                ss.append(s32[:m].astype(np.int64))
                ee.append(e32[:m].astype(np.int64))
                break
            n_enc, d8, l8, excd, excl, base = win
            s, e = decode_enc_host(d8, l8, excd, excl, base, n_enc)
            ss.append(s.astype(np.int64))
            ee.append(e.astype(np.int64))
    r.close()
    return np.concatenate(ss), np.concatenate(ee), stalled


def _mixed_bam(path):
    """Short reads (direct codes), >=255-long segments (len escape),
    multi-segment reads with big D jumps (delta escapes, including
    negative deltas at the next record), interleaved contigs."""
    rng = np.random.RandomState(11)
    names = ["c0", "c1"]
    lengths = [120_000, 90_000]
    recs = []
    for _ in range(600):
        tid = int(rng.randint(0, 2))
        pos = int(rng.randint(0, 50_000))
        kind = rng.randint(0, 4)
        if kind == 0:
            cig = f"{rng.randint(30, 200)}M"
        elif kind == 1:
            cig = f"{rng.randint(255, 2000)}M"      # len escape
        elif kind == 2:
            cig = f"120M{rng.randint(300, 30000)}D150M"  # delta escape
        else:
            cig = "40M10I40M5D60M"
        recs.append((tid, pos, 0, 60, cig))
    recs.sort(key=lambda t: (t[0], t[1]))
    write_bam(path, names, lengths, recs)


def test_enc_matches_raw(tmp_path):
    bam = str(tmp_path / "m.bam")
    _mixed_bam(bam)
    rs, re_ = _raw_pairs(bam)
    for cap, ce in [(1 << 15, 1 << 10), (509, 16), (64, 3)]:
        es, ee, _ = _enc_pairs(bam, cap, ce)
        assert np.array_equal(rs, es), (cap, ce)
        assert np.array_equal(re_, ee), (cap, ce)


def test_enc_tiny_exc_cap_partial_takes(tmp_path):
    """exc_cap=1 never stalls (every call encodes at least one pair —
    the first delta is 0 and the escape lists reset per call) but
    forces many partial takes; the reassembled stream must still be
    exact."""
    bam = str(tmp_path / "m.bam")
    _mixed_bam(bam)
    rs, re_ = _raw_pairs(bam)
    es, ee, stalled = _enc_pairs(bam, 1 << 15, 1)
    assert stalled == 0
    assert np.array_equal(rs, es)
    assert np.array_equal(re_, ee)


def test_enc_then_take32_drain(tmp_path):
    """A partial take_enc followed by take32 must hand over exactly
    the remaining pairs (the mid-window mixed-path contract)."""
    bam = str(tmp_path / "m.bam")
    _mixed_bam(bam)
    rs, re_ = _raw_pairs(bam)
    r = _native_stream(bam)
    ss, ee = [], []
    while True:
        n = r.wait()
        if n < 0:
            break
        win = r.take_enc(97, 1 << 10)  # at most 97 pairs
        if win is None:
            continue
        assert win != "stall"
        n_enc, d8, l8, excd, excl, base = win
        s, e = decode_enc_host(d8, l8, excd, excl, base, n_enc)
        ss.append(s.astype(np.int64))
        ee.append(e.astype(np.int64))
        m = r.win_remaining()
        s32, e32 = r.take32(max(m, 1), 2**31 - 1)
        ss.append(s32[:m].astype(np.int64))
        ee.append(e32[:m].astype(np.int64))
    r.close()
    assert np.array_equal(rs, np.concatenate(ss))
    assert np.array_equal(re_, np.concatenate(ee))


def test_engine_enc_equals_raw(tmp_path):
    bam = str(tmp_path / "m.bam")
    _mixed_bam(bam)
    hdr = read_bam_header(bam)
    lay = GenomeLayout(hdr.lengths)
    rs, re_ = _raw_pairs(bam)
    eng1 = CoverageEngine(lay)
    eng1.add_start_end(rs, re_)

    eng2 = CoverageEngine(lay)
    assert eng2.wants_encoded_windows
    r = _native_stream(bam)
    while True:
        n = r.wait()
        if n < 0:
            break
        while True:
            win = r.take_enc(eng2.enc_cap, eng2.enc_exc)
            if win is None:
                break
            assert win != "stall"
            eng2.add_encoded_window(*win)
    r.close()
    seg_tid = np.arange(len(hdr.lengths), dtype=np.int64)
    st1 = eng1.segment_stats(seg_tid, np.ones(2), hdr.lengths)
    st2 = eng2.segment_stats(seg_tid, np.ones(2), hdr.lengths)
    assert np.array_equal(st1.cover, st2.cover)
    assert np.array_equal(st1.depth_sum, st2.depth_sum)


def test_engine_enc_spill(tmp_path):
    """Exceeding the bounded window count folds encoded windows back
    into the raw staging with identical results."""
    bam = str(tmp_path / "m.bam")
    _mixed_bam(bam)
    hdr = read_bam_header(bam)
    lay = GenomeLayout(hdr.lengths)
    rs, re_ = _raw_pairs(bam)
    eng1 = CoverageEngine(lay)
    eng1.add_start_end(rs, re_)

    eng2 = CoverageEngine(lay)
    eng2._max_enc = 2   # force the spill path
    eng2.enc_cap = 256  # many small windows
    r = _native_stream(bam)
    while True:
        n = r.wait()
        if n < 0:
            break
        while True:
            win = r.take_enc(eng2.enc_cap, eng2.enc_exc)
            if win is None:
                break
            assert win != "stall"
            eng2.add_encoded_window(*win)
    r.close()
    assert len(eng2._enc) <= 2
    seg_tid = np.arange(len(hdr.lengths), dtype=np.int64)
    st1 = eng1.segment_stats(seg_tid, np.ones(2), hdr.lengths)
    st2 = eng2.segment_stats(seg_tid, np.ones(2), hdr.lengths)
    assert np.array_equal(st1.cover, st2.cover)
    assert np.array_equal(st1.depth_sum, st2.depth_sum)


def test_take_enc_acc_matches_raw(tmp_path):
    """The accumulating encoder (full buffers across window seams)
    must reproduce the raw pair stream exactly."""
    bam = str(tmp_path / "m.bam")
    _mixed_bam(bam)
    rs, re_ = _raw_pairs(bam)
    for cap, ce in [(1 << 15, 1 << 10), (701, 64), (64, 2)]:
        r = _native_stream(bam, window_bytes=1 << 20)
        ss, ee = [], []
        while True:
            win = r.take_enc_acc(cap, ce)
            if win is None:
                break
            n, d8, l8, excd, excl, base = win
            s, e = decode_enc_host(d8, l8, excd, excl, base, n)
            ss.append(s.astype(np.int64))
            ee.append(e.astype(np.int64))
        r.close()
        assert np.array_equal(rs, np.concatenate(ss)), (cap, ce)
        assert np.array_equal(re_, np.concatenate(ee)), (cap, ce)


@pytest.mark.parametrize("n_contigs,want_dtype", [
    (13, np.uint32),    # 3.25 Gb: uint32 tier (mod 2^32 exact)
    (18, np.int64),     # 4.5 Gb: past uint32, full int64
])
def test_enc_int64_genome(tmp_path, n_contigs, want_dtype):
    """Layouts past 2^31 positions take the same 2 B/event path with
    int64 escapes/bases; encoded == raw at 3 Gb (uint32 device tier)
    and past 4 Gb (int64 tier)."""
    bam = str(tmp_path / "g.bam")
    names = [f"c{i}" for i in range(n_contigs)]
    lengths = [250_000_000] * n_contigs
    rng = np.random.RandomState(3)
    recs = []
    for tid in range(n_contigs):
        ps = np.sort(rng.randint(0, 249_000_000, 80))
        recs += [(tid, int(p), 0, 60, "150M") for p in ps]
    write_bam(bam, names, lengths, recs)
    hdr = read_bam_header(bam)
    lay = GenomeLayout(hdr.lengths)
    assert lay.total >= (1 << 31)

    rs, re_ = _raw_pairs(bam)
    r = _native_stream(bam)
    ss, ee = [], []
    while True:
        win = r.take_enc_acc(512, 64)
        if win is None:
            break
        n, d8, l8, excd, excl, base = win
        s, e = decode_enc_host(d8, l8, excd, excl, base, n)
        ss.append(s)
        ee.append(e)
    r.close()
    assert np.array_equal(rs, np.concatenate(ss))
    assert np.array_equal(re_, np.concatenate(ee))

    eng1 = CoverageEngine(lay)
    assert eng1.pos_dtype is want_dtype and eng1.wants_encoded_windows
    eng1.add_start_end(rs, re_)
    eng2 = CoverageEngine(lay)
    r = _native_stream(bam)
    while True:
        win = r.take_enc_acc(eng2.enc_cap, eng2.enc_exc)
        if win is None:
            break
        eng2.add_encoded_window(*win)
    r.close()
    seg_tid = np.arange(n_contigs)
    st1 = eng1.segment_stats(seg_tid, np.ones(n_contigs), hdr.lengths)
    st2 = eng2.segment_stats(seg_tid, np.ones(n_contigs), hdr.lengths)
    assert np.array_equal(st1.cover, st2.cover)
    assert np.array_equal(st1.depth_sum, st2.depth_sum)
    assert st1.cover.sum() > 0


def test_feed_stream_upgrades_to_u16_on_sparse(tmp_path):
    """Sparse coverage (start gaps overflowing 8-bit zigzag) must
    upgrade the production feed to the 16-bit code tier after the
    first escape-saturated window — not grind through hundreds of
    short u8 windows. Regression: the tier check compared bound
    methods with `is` (always False), so the upgrade never fired."""
    from pandepth_jax.run import _feed_stream

    bam = str(tmp_path / "s.bam")
    # gaps ~400 : zigzag ~800 > 254, so nearly every u8 delta escapes
    n = 4000
    starts = np.cumsum(np.full(n, 400, np.int64)) + 100
    recs = [(0, int(p), 0, 60, "150M") for p in starts]
    write_bam(bam, ["c0"], [int(starts[-1]) + 1000], recs)
    hdr = read_bam_header(bam)
    lay = GenomeLayout(hdr.lengths)

    eng = CoverageEngine(lay)
    eng.enc_cap, eng.enc_exc = 512, 64
    r = _native_stream(bam)
    _feed_stream(eng, r)
    assert eng.n_reads_seen == n
    # the u8 group stalls once, everything after rides the u16 tier
    # (these uniform-length windows land in the CONST u16 group)
    assert eng._n_win8 + eng._n_winc8 <= 1
    assert eng._n_winc16 + eng._n_win16 >= 1
    for (dd, *_rest) in eng._encc16 + eng._pendc16:
        assert np.asarray(dd).dtype == np.uint16

    # and the stats match a raw-path engine bit for bit
    eng2 = CoverageEngine(lay)
    rs, re_ = _raw_pairs(bam)
    eng2.add_start_end(rs, re_)
    tid = np.zeros(1, np.int64)
    a = eng.segment_stats(tid, np.ones(1), hdr.lengths[:1])
    b = eng2.segment_stats(tid, np.ones(1), hdr.lengths[:1])
    assert np.array_equal(a.cover, b.cover)
    assert np.array_equal(a.depth_sum, b.depth_sum)


def _uniform_bam(path, n=3000, gap=40, read_len=150):
    """Fixed-read-length, whole-read-M records — the profile whose
    windows route to the CONST-LENGTH groups (one length plane never
    shipped)."""
    starts = np.cumsum(np.full(n, gap, np.int64)) + 100
    recs = [(0, int(p), 0, 60, f"{read_len}M") for p in starts]
    write_bam(path, ["c0"], [int(starts[-1]) + read_len + 1000], recs)


def test_engine_const_length_route(tmp_path):
    """Uniform-length windows must take the const groups (halved wire
    bytes) and answer identically to the raw-path engine."""
    bam = str(tmp_path / "u.bam")
    _uniform_bam(bam)
    hdr = read_bam_header(bam)
    lay = GenomeLayout(hdr.lengths)
    rs, re_ = _raw_pairs(bam)
    eng1 = CoverageEngine(lay)
    eng1.add_start_end(rs, re_)

    eng2 = CoverageEngine(lay)
    eng2.enc_cap, eng2.enc_exc = 512, 64
    r = _native_stream(bam)
    while True:
        win = r.take_enc_acc(eng2.enc_cap, eng2.enc_exc)
        if win is None:
            break
        eng2.add_encoded_window(*win)
    r.close()
    # every window routed const-u8; the mixed groups stayed empty
    assert eng2._n_winc8 > 0 and eng2._n_win8 == 0
    assert not eng2._enc and not eng2._pend8
    tid = np.zeros(1, np.int64)
    a = eng1.segment_stats(tid, np.ones(1), hdr.lengths[:1])
    b = eng2.segment_stats(tid, np.ones(1), hdr.lengths[:1])
    assert np.array_equal(a.cover, b.cover)
    assert np.array_equal(a.depth_sum, b.depth_sum)


def test_engine_const_length_u16_and_mixed_seam(tmp_path):
    """Sparse uniform reads ride const-u16; a single odd-length read
    makes only ITS window mixed while the rest stay const. Stats stay
    equal to the raw path in both shapes."""
    bam = str(tmp_path / "u16.bam")
    n = 2000
    starts = np.cumsum(np.full(n, 400, np.int64)) + 100
    recs = [(0, int(p), 0, 60, "150M") for p in starts]
    recs[n // 2] = (0, int(starts[n // 2]), 0, 60, "151M")  # one odd
    write_bam(bam, ["c0"], [int(starts[-1]) + 2000], recs)
    hdr = read_bam_header(bam)
    lay = GenomeLayout(hdr.lengths)
    rs, re_ = _raw_pairs(bam)
    eng1 = CoverageEngine(lay)
    eng1.add_start_end(rs, re_)

    from pandepth_jax.run import _feed_stream

    eng2 = CoverageEngine(lay)
    eng2.enc_cap, eng2.enc_exc = 512, 64
    r = _native_stream(bam)
    _feed_stream(eng2, r)
    assert eng2._n_winc16 > 0      # sparse tier, const windows
    assert eng2._n_win16 >= 1      # the odd read's window went mixed
    tid = np.zeros(1, np.int64)
    a = eng1.segment_stats(tid, np.ones(1), hdr.lengths[:1])
    b = eng2.segment_stats(tid, np.ones(1), hdr.lengths[:1])
    assert np.array_equal(a.cover, b.cover)
    assert np.array_equal(a.depth_sum, b.depth_sum)


def test_engine_const_spill(tmp_path):
    """The bounded-window spill must reconstruct const windows' length
    planes exactly."""
    bam = str(tmp_path / "us.bam")
    _uniform_bam(bam, n=4000)
    hdr = read_bam_header(bam)
    lay = GenomeLayout(hdr.lengths)
    rs, re_ = _raw_pairs(bam)
    eng1 = CoverageEngine(lay)
    eng1.add_start_end(rs, re_)

    eng2 = CoverageEngine(lay)
    eng2._max_enc = 2
    eng2.enc_cap, eng2.enc_exc = 256, 64
    r = _native_stream(bam)
    while True:
        win = r.take_enc_acc(eng2.enc_cap, eng2.enc_exc)
        if win is None:
            break
        eng2.add_encoded_window(*win)
    r.close()
    tid = np.zeros(1, np.int64)
    a = eng1.segment_stats(tid, np.ones(1), hdr.lengths[:1])
    b = eng2.segment_stats(tid, np.ones(1), hdr.lengths[:1])
    assert np.array_equal(a.cover, b.cover)
    assert np.array_equal(a.depth_sum, b.depth_sum)


def test_backend_aware_enc_default(tmp_path, monkeypatch):
    """With PANDEPTH_ENC unset the engine stages raw positions
    (hosteval.wants_encoded_windows; the padded code blocks cost more
    than they save on the CPU backend and on the H100). The full
    stream feed through the default-raw path must match the encoded
    path bit for bit."""
    from pandepth_jax.run import _feed_stream

    monkeypatch.delenv("PANDEPTH_ENC", raising=False)
    bam = str(tmp_path / "d.bam")
    _mixed_bam(bam)
    hdr = read_bam_header(bam)
    lay = GenomeLayout(hdr.lengths)

    eng = CoverageEngine(lay)
    assert eng._platform == "cpu" and not eng.wants_encoded_windows
    r = _native_stream(bam)
    _feed_stream(eng, r)
    assert not eng._has_enc          # the raw take32 path was used

    monkeypatch.setenv("PANDEPTH_ENC", "1")
    eng2 = CoverageEngine(lay)
    assert eng2.wants_encoded_windows
    r2 = _native_stream(bam)
    _feed_stream(eng2, r2)

    seg_tid = np.arange(len(hdr.lengths), dtype=np.int64)
    a = eng.segment_stats(seg_tid, np.ones(seg_tid.shape[0]),
                          hdr.lengths)
    b = eng2.segment_stats(seg_tid, np.ones(seg_tid.shape[0]),
                           hdr.lengths)
    assert np.array_equal(a.cover, b.cover)
    assert np.array_equal(a.depth_sum, b.depth_sum)
    assert eng.n_reads_seen == eng2.n_reads_seen
