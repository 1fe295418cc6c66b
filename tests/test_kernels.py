"""Device kernel tests against numpy oracles (SURVEY.md §4.3)."""

import numpy as np
import pytest

from pandepth_jax.device.engine import CoverageEngine
from pandepth_jax.device.layout import GenomeLayout
from pandepth_jax.device.sweep import SEARCH_METHOD, WRAP18_MASK
from pandepth_jax.io.bam import ReadBatch
from pandepth_jax.io.bam_writer import cigar_str_to_ops

from tests.fixtures import CONTIGS, naive_depth, random_reads


def batch_from_recs(recs):
    tid, pos, flag, mapq, n_ops = [], [], [], [], []
    opc, opl, opr = [], [], []
    for r, (t, p, f, q, cig) in enumerate(recs):
        tid.append(t)
        pos.append(p)
        flag.append(f)
        mapq.append(q)
        ops = cigar_str_to_ops(cig) if cig != "*" else []
        n_ops.append(len(ops))
        for o, ln in ops:
            opc.append(o)
            opl.append(ln)
            opr.append(r)
    a = lambda x: np.asarray(x, np.int32)  # noqa: E731
    return ReadBatch(a(tid), a(pos), a(flag), a(mapq), a(n_ops), a(opc),
                     a(opl), a(opr))


def naive_seg_stats(depth, tid, s1, e1, min_dep):
    cover, dsum = [], []
    for t, s, e in zip(tid, s1, e1):
        d = depth[t][max(s - 1, 0): e]
        sel = d >= min_dep
        cover.append(int(sel.sum()))
        dsum.append(int(d[sel].sum()))
    return np.array(cover), np.array(dsum)


@pytest.mark.parametrize("min_dep,min_mapq,flags", [
    (1, -1, 1796), (2, -1, 1796), (1, 30, 1796), (3, 10, 0),
])
def test_segment_stats_vs_naive(min_dep, min_mapq, flags):
    recs = random_reads(n=600, seed=5)
    layout = GenomeLayout(np.array([c[1] for c in CONTIGS]))
    eng = CoverageEngine(layout, flags_mask=flags, min_mapq=min_mapq,
                         min_dep=min_dep)
    # split into several batches to exercise accumulation
    for i in range(0, len(recs), 211):
        eng.add_batch(batch_from_recs(recs[i: i + 211]))

    depth = naive_depth(CONTIGS, recs, flags, min_mapq)

    rng = np.random.RandomState(3)
    seg_tid = rng.randint(0, len(CONTIGS), 60).astype(np.int32)
    s1 = np.array([rng.randint(1, CONTIGS[t][1] + 40) for t in seg_tid])
    e1 = np.array([s + rng.randint(0, 900) for s in s1])

    st = eng.segment_stats(seg_tid, s1, e1)
    exp_cov, exp_sum = naive_seg_stats(depth, seg_tid, s1, e1, min_dep)
    np.testing.assert_array_equal(st.cover, exp_cov)
    np.testing.assert_array_equal(st.depth_sum, exp_sum)


def test_dense_depth_matches_naive():
    recs = random_reads(n=400, seed=9)
    layout = GenomeLayout(np.array([c[1] for c in CONTIGS]))
    eng = CoverageEngine(layout)
    eng.add_batch(batch_from_recs(recs))
    depth = naive_depth(CONTIGS, recs)
    for t, (_, ln) in enumerate(CONTIGS):
        np.testing.assert_array_equal(eng.dense_depth(t), depth[t][:ln])


def test_interval_events_and_wrap18():
    layout = GenomeLayout(np.array([100]))
    eng = CoverageEngine(layout, wrap18=True)
    n = WRAP18_MASK + 5  # enough overlapping intervals to wrap 18 bits
    tid = np.zeros(n, np.int32)
    s = np.full(n, 10, np.int64)
    e = np.full(n, 20, np.int64)
    eng.add_intervals(tid, s, e)
    d = eng.dense_depth(0)
    assert d[10] == (n & WRAP18_MASK)
    assert d[9] == 0 and d[20] == 0

    st = eng.segment_stats(np.array([0], np.int32), np.array([1]),
                           np.array([100]))
    assert st.cover[0] == 10
    assert st.depth_sum[0] == 10 * (n & WRAP18_MASK)


def test_empty_engine():
    layout = GenomeLayout(np.array([50, 60]))
    eng = CoverageEngine(layout)
    st = eng.segment_stats(np.array([0, 1], np.int32), np.array([1, 10]),
                           np.array([50, 20]))
    np.testing.assert_array_equal(st.cover, [0, 0])
    np.testing.assert_array_equal(st.depth_sum, [0, 0])
    assert (eng.dense_depth(0) == 0).all()


def test_overhanging_read_lands_in_slack():
    layout = GenomeLayout(np.array([100]))
    eng = CoverageEngine(layout)
    eng.add_batch(batch_from_recs([(0, 90, 0, 60, "50M")]))
    # bases 90..139 covered; segment beyond contig end must see slack
    st = eng.segment_stats(np.array([0], np.int32), np.array([95]),
                           np.array([130]))
    assert st.cover[0] == 36
    assert st.depth_sum[0] == 36


@pytest.mark.parametrize("min_dep,wrap18,win",
                         [(1, False, 100), (2, True, 7), (1, True, 149),
                          (3, False, 101)])
def test_window_stats_host_matches_generic(min_dep, wrap18, win):
    """The O(E+W) piece-scatter window eval must match the generic
    boundary eval on the mode-6 regular tiling: random reads, clipped
    final windows, dropped 1-base windows, min_dep>1, 18-bit wrap."""
    from pandepth_jax.targets.windows import small_window_tiling

    rng = np.random.RandomState(win * 7 + min_dep)
    # len % win == 1 on contig 1 -> dropped final 1-base window;
    # contig 2 shorter than one window
    lengths = np.array([5003, 4 * win + 1, max(win - 1, 2), 1],
                       np.int64)
    layout = GenomeLayout(lengths)
    eng = CoverageEngine(layout, min_dep=min_dep, wrap18=wrap18)
    recs = []
    for _ in range(600):
        tid = rng.randint(0, 3)
        pos = rng.randint(0, max(int(lengths[tid]) - 5, 1))
        recs.append((tid, pos, 0, 60, f"{rng.randint(1, 200)}M"))
    recs.sort(key=lambda r: (r[0], r[1]))
    eng.add_batch(batch_from_recs(recs))

    tids, tiles = [], []
    for tid in range(3):
        t = small_window_tiling(int(lengths[tid]), win)
        tiles.append(t)
        tids.append(np.full(t.shape[0], tid, np.int32))
    seg_tid = np.concatenate(tids)
    tiling = np.concatenate(tiles)

    fast = eng.window_stats_host(seg_tid, tiling[:, 0], tiling[:, 1],
                                 win)
    assert fast is not None
    ref = eng.segment_stats_sorted_host(seg_tid, tiling[:, 0],
                                        tiling[:, 1])
    np.testing.assert_array_equal(fast.cover, ref.cover)
    np.testing.assert_array_equal(fast.depth_sum, ref.depth_sum)
    dev = eng.segment_stats(seg_tid, np.asarray(tiling[:, 0]),
                            np.asarray(tiling[:, 1]))
    np.testing.assert_array_equal(fast.cover, dev.cover)
    np.testing.assert_array_equal(fast.depth_sum, dev.depth_sum)


def test_window_stats_host_grid_tail_past_slack():
    """Large -w clipped windows: the grid tail [L, K*w) can overrun
    the contig's 512-cell slack into the NEXT contig's range
    (K*w - L up to w-1); the over-count correction must clamp its
    integral to the contig limit or it subtracts the next contig's
    coverage (regression: cover went negative)."""
    from pandepth_jax.targets.windows import small_window_tiling

    win = 1000
    lengths = np.array([1400, 5000], np.int64)  # K*w - L = 600 > 512
    layout = GenomeLayout(lengths)
    eng = CoverageEngine(layout)
    recs = [(0, 0, 0, 60, "100M"),
            (1, 0, 0, 60, "150M"), (1, 100, 0, 60, "150M")]
    eng.add_batch(batch_from_recs(recs))
    tids, tiles = [], []
    for tid in range(2):
        t = small_window_tiling(int(lengths[tid]), win)
        tiles.append(t)
        tids.append(np.full(t.shape[0], tid, np.int32))
    seg_tid = np.concatenate(tids)
    tiling = np.concatenate(tiles)
    fast = eng.window_stats_host(seg_tid, tiling[:, 0], tiling[:, 1],
                                 win)
    assert fast is not None
    dev = eng.segment_stats(seg_tid, np.asarray(tiling[:, 0]),
                            np.asarray(tiling[:, 1]))
    np.testing.assert_array_equal(fast.cover, dev.cover)
    np.testing.assert_array_equal(fast.depth_sum, dev.depth_sum)
    assert (fast.cover >= 0).all()


def test_window_stats_host_rejects_irregular():
    layout = GenomeLayout(np.array([1000]))
    eng = CoverageEngine(layout)
    # wrong window size for the claimed tiling -> count check fails
    assert eng.window_stats_host(np.zeros(3, np.int32),
                                 np.array([1, 101, 201]),
                                 np.array([100, 200, 300]),
                                 50) is None


def test_window_stats_host_empty_piece_classes():
    """np.bincount returns int64 for EMPTY weights arrays; a batch
    with no single-window pieces (or none at all) must not poison the
    float64 accumulators (found by fuzzing, seed 10149)."""
    from pandepth_jax.targets.windows import small_window_tiling

    layout = GenomeLayout(np.array([1000], np.int64))
    eng = CoverageEngine(layout, wrap18=True)
    # every piece spans many 5bp windows -> the single-window class is
    # empty
    eng.add_batch(batch_from_recs([(0, 10, 0, 60, "200M")]))
    t = small_window_tiling(1000, 5)
    st = eng.window_stats_host(np.zeros(t.shape[0], np.int32),
                               t[:, 0], t[:, 1], 5)
    assert st is not None and st.cover.sum() == 200

    eng2 = CoverageEngine(layout, wrap18=True)  # no reads at all
    st2 = eng2.window_stats_host(np.zeros(t.shape[0], np.int32),
                                 t[:, 0], t[:, 1], 5)
    assert st2 is not None and st2.cover.sum() == 0


def test_window_stats_host_int64_genome():
    """>4 Gb layouts run the int64 position tier; the host window eval
    must stay exact there (global coords overflow int32/uint32)."""
    from pandepth_jax.targets.windows import small_window_tiling

    lengths = np.array([3_000_000_000, 2_000_000_000], np.int64)
    layout = GenomeLayout(lengths)
    assert layout.total > (1 << 32)
    eng = CoverageEngine(layout)
    eng.add_intervals(np.array([1, 1], np.int32),
                      np.array([1_999_999_000, 500], np.int64),
                      np.array([2_000_000_000, 700], np.int64))
    win = 100_000_000
    tids, tiles = [], []
    for tid in range(2):
        t = small_window_tiling(int(lengths[tid]), win)
        tiles.append(t)
        tids.append(np.full(t.shape[0], tid, np.int32))
    seg_tid = np.concatenate(tids)
    tiling = np.concatenate(tiles)
    fast = eng.window_stats_host(seg_tid, tiling[:, 0], tiling[:, 1],
                                 win)
    assert fast is not None
    ref = eng.segment_stats_sorted_host(seg_tid, tiling[:, 0],
                                        tiling[:, 1])
    np.testing.assert_array_equal(fast.cover, ref.cover)
    np.testing.assert_array_equal(fast.depth_sum, ref.depth_sum)
    assert fast.cover.sum() == 1_200


@pytest.mark.parametrize("n", [1, 256, 4096, 4097, 65_536, 168_000,
                               1 << 20])
def test_search_method(n):
    """The default search method is the binary search the H100 and the
    CPU timings chose at every batch size, and eval_pair and
    eval_boundaries both take it: answers equal the explicit method's
    at query counts on both sides of the old 4,096 threshold."""
    import jax.numpy as jnp

    from pandepth_jax.device.sweep import (eval_boundaries, eval_pair,
                                           sort_events)

    assert SEARCH_METHOD == "scan_unrolled"
    rng = np.random.RandomState(n % 1000)
    s = rng.randint(0, 500_000, 2000)
    pos = np.concatenate([s, s + rng.randint(1, 400, 2000)])
    delta = np.concatenate([np.ones(2000, np.int32),
                            -np.ones(2000, np.int32)])
    st = sort_events(jnp.asarray(pos, jnp.int64), jnp.asarray(delta))
    lo = jnp.asarray(np.sort(rng.randint(0, 500_000, n)), jnp.int64)
    hi = lo + 1_000
    md = jnp.int32(1)
    got = eval_pair(*st[:4], md, lo, hi)
    want = eval_pair(*st[:4], md, lo, hi, method="scan_unrolled")
    ref = eval_pair(*st[:4], md, lo, hi, method="sort")
    for a, b, c in zip(got, want, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(c))
    qc, qs = eval_boundaries(*st[:4], md, hi)
    pc, ps = eval_boundaries(*st[:4], md, lo)
    np.testing.assert_array_equal(np.asarray(qc - pc), np.asarray(got[0]))
    np.testing.assert_array_equal(np.asarray(qs - ps), np.asarray(got[1]))


@pytest.mark.parametrize("method", ["scan", "scan_unrolled", "sort",
                                    "compare_all", None])
@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.int64])
def test_eval_pair_methods_match_hosteval(method, dtype):
    """Every searchsorted method gives eval_pair the exact answers of
    the numpy twins (derive_integrals + host_q_eval), on each
    coordinate tier."""
    import jax.numpy as jnp

    from pandepth_jax.device import hosteval as he
    from pandepth_jax.device.sweep import eval_pair, sort_events

    rng = np.random.RandomState(3)
    base = 3_000_000_000 if dtype is np.uint32 else \
        5_000_000_000 if dtype is np.int64 else 0
    s = base + rng.randint(0, 200_000, 3000)
    e = s + rng.randint(1, 300, 3000)
    pos = np.concatenate([s, e]).astype(dtype)
    delta = np.concatenate([np.ones(3000, np.int32),
                            -np.ones(3000, np.int32)])
    st = sort_events(jnp.asarray(pos), jnp.asarray(delta), min_dep=2)
    order = np.argsort(pos, kind="stable")
    hpos = pos[order].astype(np.int64)
    sweep = he.derive_integrals(
        hpos, np.cumsum(delta[order]).astype(np.int32), 2)
    lo = np.sort(base + rng.randint(0, 200_000, 700)).astype(dtype)
    hi = (lo + rng.randint(0, 5_000, 700)).astype(dtype)
    got = eval_pair(st[0], st[1], st[2], st[3], jnp.int32(2),
                    jnp.asarray(lo), jnp.asarray(hi),
                    **({} if method is None else {"method": method}))
    q = [he.host_q_eval(sweep, 2, x.astype(np.int64),
                        np.searchsorted(hpos, x.astype(np.int64)))
         for x in (lo, hi)]
    np.testing.assert_array_equal(np.asarray(got[0]), q[1][0] - q[0][0])
    np.testing.assert_array_equal(np.asarray(got[1]), q[1][1] - q[0][1])


@pytest.mark.parametrize("env,want", [
    (None, False), ("0", False), ("1", True),
])
def test_feed_format_policy(monkeypatch, env, want):
    """Raw positions by default (faster on the H100 and the CPU);
    the encoded windows only when asked for."""
    from pandepth_jax.device.hosteval import wants_encoded_windows

    if env is None:
        monkeypatch.delenv("PANDEPTH_ENC", raising=False)
    else:
        monkeypatch.setenv("PANDEPTH_ENC", env)
    assert wants_encoded_windows() is want
