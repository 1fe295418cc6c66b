"""Streaming-fold (bounded-memory deep coverage) tests.

``HostCoverageEngine.begin_streaming_fold`` folds staged events below
the coordinate frontier into running prefix integrals at the
registered query boundaries (flat-memory deep coverage).
These tests force tiny fold thresholds so a few hundred reads cross
many fold windows, and prove:

- equality with the plain (fold-less) host engine on random sorted
  feeds, including min_dep > 1 and wrap18;
- the sortedness verification raises on out-of-order feeds;
- CLI-level byte parity vs the reference binary with the fold forced
  hot (threshold 1 => a fold per staged window).
"""

import os
import subprocess

import numpy as np
import pytest

from pandepth_jax.device.host_engine import HostCoverageEngine
from pandepth_jax.device.layout import GenomeLayout


def _random_sorted_feed(rng, layout, n_reads, max_len=120):
    """Global clamped (starts, ends) in coordinate order, chunked."""
    n_tid = layout.lengths.shape[0]
    tid = np.sort(rng.randint(0, n_tid, n_reads))
    pos = np.empty(n_reads, np.int64)
    for t in range(n_tid):
        m = tid == t
        pos[m] = np.sort(rng.randint(0, layout.lengths[t], m.sum()))
    ln = rng.randint(1, max_len, n_reads)
    floor = layout.offsets[tid]
    limit = layout.limits[tid]
    s = np.clip(floor + pos, floor, limit)
    e = np.clip(floor + pos + ln, floor, limit)
    live = e > s
    return s[live], e[live]


def _queries(rng, layout, n_q):
    n_tid = layout.lengths.shape[0]
    tid = rng.randint(0, n_tid, n_q).astype(np.int64)
    a = rng.randint(1, layout.lengths[tid] + 50)
    b = a + rng.randint(0, 400, n_q)
    return tid, a, b


@pytest.mark.parametrize("min_dep,wrap18", [(1, False), (3, False),
                                            (1, True)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fold_equals_plain_engine(seed, min_dep, wrap18):
    rng = np.random.RandomState(seed)
    layout = GenomeLayout(np.array([5000, 3000, 800]))
    s, e = _random_sorted_feed(rng, layout, 4000)
    tid, qa, qb = _queries(rng, layout, 200)

    plain = HostCoverageEngine(layout, min_dep=min_dep, wrap18=wrap18)
    fold = HostCoverageEngine(layout, min_dep=min_dep, wrap18=wrap18)
    fold.begin_streaming_fold(tid, qa, qb, threshold_pairs=64)
    # feed in small coordinate-ordered chunks -> many folds
    for i in range(0, s.shape[0], 97):
        plain.add_start_end(s[i:i + 97], e[i:i + 97])
        fold.add_start_end(s[i:i + 97], e[i:i + 97])
    ref = plain.segment_stats(tid, qa, qb)
    got = fold.segment_stats(tid, qa, qb)
    np.testing.assert_array_equal(got.cover, ref.cover)
    np.testing.assert_array_equal(got.depth_sum, ref.depth_sum)


def test_fold_repeated_and_subset_queries():
    rng = np.random.RandomState(7)
    layout = GenomeLayout(np.array([4000, 1000]))
    s, e = _random_sorted_feed(rng, layout, 1500)
    tid, qa, qb = _queries(rng, layout, 50)
    fold = HostCoverageEngine(layout)
    fold.begin_streaming_fold(tid, qa, qb, threshold_pairs=32)
    fold.add_start_end(s, e)
    first = fold.segment_stats(tid, qa, qb)
    # a second call (and a subset, in different order) still answers
    again = fold.segment_stats(tid[::-1], qa[::-1], qb[::-1])
    np.testing.assert_array_equal(again.cover, first.cover[::-1])
    sub = fold.segment_stats(tid[:5], qa[:5], qb[:5])
    np.testing.assert_array_equal(sub.depth_sum, first.depth_sum[:5])


def test_fold_rejects_unsorted_feed():
    layout = GenomeLayout(np.array([10000]))
    eng = HostCoverageEngine(layout)
    eng.begin_streaming_fold(np.zeros(1, np.int64), np.asarray([1]),
                             np.asarray([10000]),
                             threshold_pairs=2)
    eng.add_start_end(np.asarray([5000, 5100]),
                      np.asarray([5050, 5200]))  # folds, cutoff 5100
    with pytest.raises(RuntimeError, match="not coordinate-sorted"):
        eng.add_start_end(np.asarray([100, 120, 130, 140]),
                          np.asarray([150, 160, 170, 180]))
        eng.segment_stats(np.zeros(1, np.int64), np.asarray([1]),
                          np.asarray([10000]))


def test_fold_rejects_unregistered_boundary():
    layout = GenomeLayout(np.array([10000]))
    eng = HostCoverageEngine(layout)
    eng.begin_streaming_fold(np.zeros(1, np.int64), np.asarray([1]),
                             np.asarray([5000]), threshold_pairs=1)
    eng.add_start_end(np.asarray([10]), np.asarray([50]))
    with pytest.raises(RuntimeError, match="not registered"):
        eng.segment_stats(np.zeros(1, np.int64), np.asarray([2]),
                          np.asarray([5000]))


@pytest.mark.parametrize("targets", ["chr", "gene", "bed", "win"])
def test_fold_cli_parity_vs_reference(tmp_path, targets, oracle_bin,
                                      monkeypatch):
    """CLI byte parity with the fold forced hot (a fold per window)."""
    from tests.fixtures import gunzip_bytes, make_bam, make_bed, \
        make_gff

    from pandepth_jax.cli import main as cli_main

    bam = str(tmp_path / "t.bam")
    make_bam(bam, n=900, seed=31)
    extra = []
    if targets == "gene":
        gff = str(tmp_path / "g.gff")
        make_gff(gff, overhang=False)
        extra = ["-g", gff]
    elif targets == "bed":
        bed = str(tmp_path / "b.bed")
        make_bed(bed)
        extra = ["-b", bed]
    elif targets == "win":
        extra = ["-w", "500"]
    monkeypatch.setenv("PANDEPTH_HOST_FINALIZE", "1")
    monkeypatch.setenv("PANDEPTH_STREAM_FOLD", "1")
    monkeypatch.setenv("PANDEPTH_FOLD_PAIRS", "1")
    ours = str(tmp_path / "ours")
    ref = str(tmp_path / "ref")
    assert cli_main(["pandepth", "-i", bam, "-o", ours] + extra) == 0
    subprocess.run([oracle_bin, "-i", bam, "-o", ref] + extra,
                   check=True, capture_output=True)
    import glob

    ref_files = sorted(glob.glob(ref + "*.gz"))
    assert ref_files
    for rf in ref_files:
        of = rf.replace(ref, ours, 1)
        assert gunzip_bytes(of) == gunzip_bytes(rf), rf
