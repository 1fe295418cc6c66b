"""BAI/CSI index parsing and the ranged (block-skipping) load path."""

import numpy as np

from pandepth_jax.io.bamindex import (BamIndex, chunks_for_windows,
                                      load_index_for, merge_ranges)

from tests.fixtures import CONTIGS, make_bam


def test_load_and_query(tmp_path):
    bam = str(tmp_path / "t.bam")
    recs = make_bam(bam, n=600, seed=21)
    idx = load_index_for(bam)
    assert idx is not None
    assert idx.n_ref == len(CONTIGS)
    # a region with reads must yield chunks; far-away region on ctgM
    ch = idx.query(0, 0, CONTIGS[0][1])
    assert ch.shape[0] >= 1
    assert (ch[:, 1] > ch[:, 0]).all()
    # over-fetch beyond the data is allowed (the read-overlap filter
    # rejects later); degenerate queries return nothing
    assert idx.query(0, 100, 100).shape[0] == 0
    assert idx.query(-1, 0, 100).shape[0] == 0
    assert idx.query(99, 0, 100).shape[0] == 0


def test_merge_ranges():
    r = np.array([[10, 20], [15, 30], [40, 50], [50, 60], [5, 8]])
    m = merge_ranges(r)
    assert m.tolist() == [[5, 8], [10, 30], [40, 60]]


def test_ranged_load_equals_full(tmp_path):
    import pytest

    native = pytest.importorskip("pandepth_jax.io.native")
    if native.load_library() is None:
        pytest.skip("native unavailable")
    from pandepth_jax.device.layout import GenomeLayout

    bam = str(tmp_path / "t.bam")
    make_bam(bam, n=800, seed=31)
    lengths = np.array([c[1] for c in CONTIGS])
    lay = GenomeLayout(lengths)

    # fetch windows over a sparse subset
    off = np.array([0, 1, 2, 2], np.int64)
    starts = np.array([1000, 500], np.int64)
    ends = np.array([2000, 1500], np.int64)
    windows = (off, starts, ends, 1)

    full = native.NativeBamLoad(bam, 1796, -1, regions=windows)
    fs, fe = full.events()
    full.close()

    idx = load_index_for(bam)
    vr = chunks_for_windows(idx, windows)
    assert vr.shape[0] >= 1
    ranged = native.NativeBamLoad(bam, 1796, -1, regions=windows,
                                  vranges=vr)
    rs, re_ = ranged.events()
    ranged.close()
    np.testing.assert_array_equal(np.sort(fs), np.sort(rs))
    np.testing.assert_array_equal(np.sort(fe), np.sort(re_))


def test_bulk_bin_chunks_equals_per_bin(tmp_path):
    """The vectorized u32-pair gather over the raw index bytes must
    reproduce the per-bin frombuffer materialization exactly (every
    bin, every contig), including mixed lazy/materialized entries."""
    from tests.fixtures import make_bam

    from pandepth_jax.io.bamindex import load_index_for

    bam = str(tmp_path / "b.bam")
    make_bam(bam, n=3000, seed=5)
    idx_a = load_index_for(bam)
    idx_b = load_index_for(bam)
    total_bins = 0
    for tid in range(idx_a.n_ref):
        bl = sorted(idx_a.bins[tid].keys())
        total_bins += len(bl)
        if not bl:
            continue
        # materialize ONE bin first so the bulk path sees a mix of
        # lazy tuples and eager ndarrays
        idx_a.bin_chunks(tid, bl[0])
        bulk = idx_a.bulk_bin_chunks(tid, bl)
        per = np.concatenate([idx_b.bin_chunks(tid, b) for b in bl])
        # rows must come out GROUPED IN bin_ids ORDER even with the
        # lazy/eager mix (the documented contract since r5)
        np.testing.assert_array_equal(bulk, per)
    assert total_bins > 0
