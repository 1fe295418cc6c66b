"""Ranged (index-driven) streaming: block skipping with bounded memory.

The streaming producer seeks between merged virtual-offset chunk
ranges and walks only target-overlapping compressed spans — the
reference's `sam_index_load` + `sam_itr_regarray` fetch
(/root/reference/src/PanDepth.cpp:4120-4124, :430-434) re-done on the
bounded-memory stream instead of a one-shot whole-file load. Events
must equal the one-shot ranged loader's bit for bit, sparse selections
must actually skip records, and the production CLI path must stay
byte-parity with the reference binary.
"""

import numpy as np
import pytest

from pandepth_jax.io.bam import read_bam_header
from pandepth_jax.io.bam_writer import write_bam
from pandepth_jax.io.bamindex import chunks_for_windows, load_index_for


def _native(cls_name):
    from pandepth_jax.io import native

    if native.load_library() is None:
        pytest.skip(f"native library unavailable: {native.build_error()}")
    return getattr(native, cls_name)


def _windows(n_tids, picks):
    """fetch_windows-shaped (reg_off, starts, ends, mode=1) regions."""
    cnt = np.zeros(n_tids, np.int64)
    for t, _, _ in picks:
        cnt[t] += 1
    order = sorted(range(len(picks)), key=lambda i: (picks[i][0],
                                                     picks[i][1]))
    starts = np.array([picks[i][1] for i in order], np.int64)
    ends = np.array([picks[i][2] for i in order], np.int64)
    return (np.concatenate([[0], np.cumsum(cnt)]), starts, ends, 1)


def _stream_events(cls, bam, fw, vr, **kw):
    r = cls(bam, 1796, -1, regions=fw, vranges=vr, **kw)
    es, ee = [], []
    while True:
        n = r.wait()
        if n < 0:
            break
        s, e = r.take32(max(n, 1), 2**31 - 1)
        es.append(s[:n].copy())
        ee.append(e[:n].copy())
    nrec = r.n_records
    r.close()
    return (np.sort(np.concatenate(es)) if es else np.zeros(0, np.int32),
            np.sort(np.concatenate(ee)) if ee else np.zeros(0, np.int32),
            nrec)


def _make_bam(path, n_tids=4, per_tid=3000, seed=5):
    rng = np.random.RandomState(seed)
    names = [f"c{i}" for i in range(n_tids)]
    lengths = [40_000_000] * n_tids
    recs = []
    for tid in range(n_tids):
        ps = np.sort(rng.randint(0, 39_000_000, per_tid))
        recs += [(tid, int(p), 0, 60, "100M") for p in ps]
    write_bam(str(path), names, lengths, recs)
    return str(path), names, lengths


@pytest.mark.parametrize("picks,label", [
    ([(0, 1_000_000, 1_050_000), (2, 20_000_000, 20_100_000)],
     "sparse"),
    ([(t, s, s + 400_000) for t in range(4)
      for s in range(0, 39_000_000, 500_000)], "dense"),
])
def test_ranged_stream_matches_oneshot(tmp_path, picks, label):
    NativeBamStream = _native("NativeBamStream")
    NativeBamLoad = _native("NativeBamLoad")
    # enough reads that block skipping is observable: ranges over-read
    # ~66 KB (one BGZF block) past each end, so the file must span many
    # blocks for a sparse selection to skip most records
    per_tid = 60_000 if label == "sparse" else 3_000
    bam, names, lengths = _make_bam(tmp_path / "r.bam",
                                    per_tid=per_tid)
    fw = _windows(len(names), picks)
    idx = load_index_for(bam)
    assert idx is not None
    vr = chunks_for_windows(idx, fw)
    assert vr.shape[0] > 0

    s1, e1, nrec = _stream_events(NativeBamStream, bam, fw, vr,
                                  window_bytes=1 << 20)
    lb = NativeBamLoad(bam, 1796, -1, regions=fw, vranges=vr)
    s2, e2, _ = lb.events32_padded(max(lb.n_events, 1), 2**31 - 1)
    s2 = np.sort(s2[: lb.n_events])
    e2 = np.sort(e2[: lb.n_events])
    lb.close()
    assert np.array_equal(s1, s2), label
    assert np.array_equal(e1, e2), label
    assert s1.size > 0
    if label == "sparse":
        # block skipping must hold: only a sliver of records walked
        assert nrec < per_tid * len(names) // 10, nrec


def test_ranged_stream_equals_full_stream_filter(tmp_path):
    """Skipped blocks contain no region-overlapping records: ranged
    events == full-stream mode-1-filtered events."""
    NativeBamStream = _native("NativeBamStream")
    bam, names, lengths = _make_bam(tmp_path / "f.bam", seed=9)
    picks = [(1, 5_000_000, 5_200_000), (3, 30_000_000, 30_050_000)]
    fw = _windows(len(names), picks)
    idx = load_index_for(bam)
    vr = chunks_for_windows(idx, fw)
    s1, e1, _ = _stream_events(NativeBamStream, bam, fw, vr,
                               window_bytes=1 << 20)
    s2, e2, _ = _stream_events(NativeBamStream, bam, fw, None)
    assert np.array_equal(s1, s2)
    assert np.array_equal(e1, e2)


def test_ranged_stream_window_smaller_than_range(tmp_path):
    """Ranges larger than the window stream across window boundaries
    (split-record carries inside a range)."""
    NativeBamStream = _native("NativeBamStream")
    bam, names, lengths = _make_bam(tmp_path / "w.bam", n_tids=1,
                                    per_tid=40000, seed=3)
    fw = _windows(1, [(0, 0, 40_000_000)])
    idx = load_index_for(bam)
    vr = chunks_for_windows(idx, fw)
    s1, e1, nrec = _stream_events(NativeBamStream, bam, fw, vr,
                                  window_bytes=1 << 20)
    assert nrec == 40000
    assert s1.size == 40000


def test_cli_gene_mode_uses_ranged_stream_parity(tmp_path, oracle_bin):
    """Production gene-mode CLI (indexed BAM) routes through the
    ranged stream and stays byte-parity with the reference binary."""
    import gzip
    import subprocess

    from tests.fixtures import make_bam, make_gff

    from pandepth_jax.cli import main as cli_main

    ref = oracle_bin
    bam = str(tmp_path / "t.bam")
    gff = str(tmp_path / "g.gff")
    make_bam(bam, n=600, seed=31)
    make_gff(gff, overhang=False)
    rc = cli_main(["pandepth", "-i", bam, "-g", gff, "-o",
                   str(tmp_path / "ours")])
    assert rc == 0
    subprocess.run([ref, "-i", bam, "-g", gff, "-o",
                    str(tmp_path / "ref")],
                   check=True, timeout=300,
                   stdout=subprocess.DEVNULL,
                   stderr=subprocess.DEVNULL)
    with gzip.open(tmp_path / "ours.gene.stat.gz") as fh:
        a = fh.read()
    with gzip.open(tmp_path / "ref.gene.stat.gz") as fh:
        b = fh.read()
    assert a == b
