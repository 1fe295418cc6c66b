"""Streaming bounded-memory loader (NativeBamStream): window-chunked
event parity with the one-shot loader, region-mode semantics across
window boundaries, and a flat-RSS guarantee (the reference streams
arbitrarily large inputs in bounded memory, src/PanDepth.cpp:676-723)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from tests.fixtures import make_bam

from pandepth_jax.io.native import (NativeBamLoad, NativeBamStream,
                                    load_library)

pytestmark = pytest.mark.skipif(load_library() is None,
                                reason="native library unavailable")


def _stream_events(path, flags=1796, mapq=-1, regions=None,
                   window=1 << 20):
    s = NativeBamStream(path, flags, mapq, regions=regions,
                        window_bytes=window)
    starts, ends = [], []
    n_wins = 0
    while True:
        n = s.wait()
        if n < 0:
            break
        a, b = s.take64(n)
        starts.append(a)
        ends.append(b)
        n_wins += 1
    recs = s.n_records
    s.close()
    return (np.concatenate(starts) if starts else np.zeros(0),
            np.concatenate(ends) if ends else np.zeros(0), recs,
            n_wins)


def _sorted_pairs(s, e):
    return np.sort(np.stack([s, e]), axis=1)


def test_stream_matches_oneshot(tmp_path):
    bam = str(tmp_path / "t.bam")
    make_bam(bam, n=20000, seed=42)
    ld = NativeBamLoad(bam, 1796, -1)
    s1, e1 = ld.events()
    n_rec = ld.n_records
    ld.close()
    s2, e2, recs, n_wins = _stream_events(bam, window=1 << 20)
    assert recs == n_rec
    np.testing.assert_array_equal(_sorted_pairs(s1, e1),
                                  _sorted_pairs(s2, e2))


def test_stream_many_tiny_windows(tmp_path):
    """Records must survive window boundaries (partial-record carry)."""
    bam = str(tmp_path / "t.bam")
    make_bam(bam, n=5000, seed=7)
    ld = NativeBamLoad(bam, 1796, -1)
    s1, e1 = ld.events()
    ld.close()
    # minimum window (1 MB) over a multi-MB file forces several windows
    s2, e2, _, n_wins = _stream_events(bam, window=1 << 20)
    np.testing.assert_array_equal(_sorted_pairs(s1, e1),
                                  _sorted_pairs(s2, e2))


def test_stream_region_cursor_across_windows(tmp_path):
    """Mode-2 cursor state (incl. the finishing-read quirk) must
    persist across stream windows."""
    bam = str(tmp_path / "t.bam")
    make_bam(bam, n=8000, seed=13)
    # merged spans on a subset of contigs (1-based closed)
    reg_off = np.array([0, 2, 3, 3], np.int64)
    reg_s = np.array([100, 2000, 50], np.int64)
    reg_e = np.array([900, 2600, 1500], np.int64)
    regions = (reg_off, reg_s, reg_e, 2)
    ld = NativeBamLoad(bam, 1796, -1, regions=regions)
    s1, e1 = ld.events()
    ld.close()
    s2, e2, _, _ = _stream_events(bam, regions=regions, window=1 << 20)
    np.testing.assert_array_equal(_sorted_pairs(s1, e1),
                                  _sorted_pairs(s2, e2))


def test_stream_truncated_fails_cleanly(tmp_path):
    bam = str(tmp_path / "t.bam")
    make_bam(bam, n=2000, seed=3)
    data = open(bam, "rb").read()
    bad = str(tmp_path / "bad.bam")
    with open(bad, "wb") as fh:
        fh.write(data[: len(data) * 2 // 3])
    with pytest.raises(ValueError):
        _stream_events(bad)


def test_stream_flat_rss(tmp_path):
    """Peak RSS of a streaming run must stay far below the file's
    decompressed size (the one-shot loader holds compressed +
    decompressed simultaneously)."""
    bam = str(tmp_path / "big.bam")
    import numpy as np

    from pandepth_jax.io.bam_writer import write_uniform_bam

    rng = np.random.RandomState(5)
    n = 600_000  # ~64 MB decompressed records
    lens = [8_000_000, 6_000_000]
    tid = rng.randint(0, 2, n).astype(np.int32)
    pos = np.sort(rng.randint(0, 5_000_000, n)).astype(np.int32)
    order = np.lexsort((pos, tid))
    write_uniform_bam(bam, ["c1", "c2"], lens, tid[order], pos[order],
                      np.zeros(n, np.uint16), np.full(n, 60, np.uint8),
                      make_index=False)
    dec_size = 8 + n * 110  # rough decompressed stream size
    script = f"""
import resource, sys
sys.path.insert(0, {os.path.dirname(os.path.dirname(os.path.abspath(__file__)))!r})
import numpy as np
from pandepth_jax.io.native import NativeBamStream
# the package import may pull jax (its init RSS varies run to run);
# the stream's own footprint is the delta over this baseline
base_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
s = NativeBamStream({bam!r}, 1796, -1, window_bytes=1 << 21)
tot = 0
while True:
    n = s.wait()
    if n < 0:
        break
    a, b = s.take64(n)
    tot += n
peak_kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
print(tot, s.n_records, base_kb, peak_kb)
"""
    r = subprocess.run([sys.executable, "-c", script],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-1500:]
    tot, recs, base_kb, peak_kb = map(int, r.stdout.split())
    assert recs == n
    assert tot > 0
    # windows are capped at 2 MB compressed / 8 MB decompressed; the
    # event arrays in flight add a few MB more. The whole-file loader
    # holds compressed + decompressed simultaneously (> dec_size).
    delta = (peak_kb - base_kb) * 1024
    assert delta < dec_size // 2, \
        f"stream RSS delta {delta} B not flat vs {dec_size} B stream"
