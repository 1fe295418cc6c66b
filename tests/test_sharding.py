"""Multi-device sharding tests on the 8-virtual-CPU mesh
(SURVEY.md §4.4): the sharded coverage step must equal the single-chip
engine bit-for-bit."""

import jax
import numpy as np
import pytest

from pandepth_jax.device.engine import CoverageEngine
from pandepth_jax.device.layout import GenomeLayout
from pandepth_jax.io.bam import ReadBatch
from pandepth_jax.sharding.mesh import make_mesh, sharded_coverage_step

import jax.numpy as jnp

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


def _problem(n_dev, seed=1):
    rng = np.random.RandomState(seed)
    lengths = np.array([7000, 4000, 900], np.int64)
    layout = GenomeLayout(lengths)
    n = 32 * n_dev
    tid = rng.randint(0, 3, n).astype(np.int32)
    pos = rng.randint(0, 3500, n).astype(np.int32)
    flag = np.where(rng.rand(n) < 0.15, 256, 0).astype(np.int32)
    mapq = rng.randint(0, 61, n).astype(np.int32)
    opr = np.repeat(np.arange(n, dtype=np.int32), 2)
    opc = np.tile(np.array([0, 2], np.int32), n)  # M then D
    opl = rng.randint(1, 99, 2 * n).astype(np.int32)

    seg_tid = np.array([0, 0, 1, 2, 2], np.int32)
    s1 = np.array([1, 3000, 500, 1, 800], np.int64)
    e1 = np.array([3500, 7000, 4000, 900, 1200], np.int64)
    return layout, (tid, pos, flag, mapq, opc, opl, opr), (seg_tid, s1, e1)


@pytest.mark.parametrize("n_dev,dp", [(8, 2), (8, 1), (4, 2), (2, 1)])
def test_sharded_equals_single_chip(n_dev, dp):
    layout, reads, segs = _problem(n_dev)
    tid, pos, flag, mapq, opc, opl, opr = reads
    seg_tid, s1, e1 = segs

    mesh = make_mesh(jax.devices()[:n_dev], dp=dp)
    per_read = tid.shape[0] // n_dev
    opr_local = (opr % per_read).astype(np.int32)

    step = sharded_coverage_step(mesh, flags_mask=1796, min_mapq=20,
                                 min_dep=2)
    bounds = jnp.asarray(layout.shard_bounds(n_dev))
    seg_lo = jnp.asarray(layout.offsets[seg_tid] + s1 - 1)
    seg_hi = jnp.asarray(np.minimum(layout.offsets[seg_tid] + e1,
                                    layout.limits[seg_tid]))
    cover, dsum = step(jnp.asarray(tid), jnp.asarray(pos),
                       jnp.asarray(flag), jnp.asarray(mapq),
                       jnp.asarray(opc), jnp.asarray(opl),
                       jnp.asarray(opr_local),
                       jnp.asarray(layout.offsets),
                       jnp.asarray(layout.limits),
                       bounds, seg_lo, seg_hi)

    eng = CoverageEngine(layout, flags_mask=1796, min_mapq=20, min_dep=2)
    eng.add_batch(ReadBatch(tid, pos, flag, mapq,
                            np.full(tid.shape[0], 2, np.int32),
                            opc, opl, opr))
    st = eng.segment_stats(seg_tid, s1, e1)
    np.testing.assert_array_equal(np.asarray(cover), st.cover)
    np.testing.assert_array_equal(np.asarray(dsum), st.depth_sum)


def test_sharded_step_hot_range_overflow_retry():
    """All events landing in ONE device's range must still be exact:
    the bucketed all_to_all detects per-pair capacity overflow and
    retries with a doubled capacity."""
    n_dev = 8
    rng = np.random.RandomState(9)
    lengths = np.array([8000, 8000], np.int64)
    layout = GenomeLayout(lengths)
    n = 32 * n_dev
    tid = np.zeros(n, np.int32)
    pos = rng.randint(0, 50, n).astype(np.int32)  # all in range 0
    flag = np.zeros(n, np.int32)
    mapq = np.full(n, 60, np.int32)
    opr = np.arange(n, dtype=np.int32)
    opc = np.zeros(n, np.int32)
    opl = rng.randint(5, 40, n).astype(np.int32)

    mesh = make_mesh(jax.devices()[:n_dev], dp=1)
    per_read = n // n_dev
    opr_local = (opr % per_read).astype(np.int32)
    step = sharded_coverage_step(mesh, flags_mask=1796, min_mapq=-1,
                                 min_dep=1)
    seg_tid = np.array([0, 1], np.int32)
    s1 = np.ones(2, np.int64)
    e1 = lengths.copy()
    cover, dsum = step(jnp.asarray(tid), jnp.asarray(pos),
                       jnp.asarray(flag), jnp.asarray(mapq),
                       jnp.asarray(opc), jnp.asarray(opl),
                       jnp.asarray(opr_local),
                       jnp.asarray(layout.offsets),
                       jnp.asarray(layout.limits),
                       jnp.asarray(layout.shard_bounds(n_dev)),
                       jnp.asarray(layout.offsets[seg_tid] + s1 - 1),
                       jnp.asarray(layout.offsets[seg_tid] + e1))

    eng = CoverageEngine(layout)
    eng.add_batch(ReadBatch(tid, pos, flag, mapq,
                            np.ones(n, np.int32), opc, opl, opr))
    st = eng.segment_stats(seg_tid, s1, e1)
    np.testing.assert_array_equal(np.asarray(cover), st.cover)
    np.testing.assert_array_equal(np.asarray(dsum), st.depth_sum)


def test_graft_dryrun():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn).lower(*args).compile()
    assert out is not None
    ge.dryrun_multichip(8)


def test_cli_uses_sharded_engine_by_default(monkeypatch):
    """With >1 device the production CLI path must construct the
    range-sharded engine (multi-device is the product's execution
    model, not a test harness)."""
    monkeypatch.delenv("PANDEPTH_SHARDED", raising=False)
    from pandepth_jax.run import make_engine
    from pandepth_jax.sharding.engine import ShardedCoverageEngine

    eng = make_engine(GenomeLayout(np.array([1000], np.int64)))
    assert isinstance(eng, ShardedCoverageEngine)
    assert eng.n_dev == len(jax.devices())
    monkeypatch.setenv("PANDEPTH_SHARDED", "0")
    eng = make_engine(GenomeLayout(np.array([1000], np.int64)))
    assert isinstance(eng, CoverageEngine)


def test_cli_sharded_vs_single_byte_parity(tmp_path, monkeypatch):
    """Full CLI outputs must be byte-identical between the sharded
    (default, 8 devices) and forced single-device engines."""
    import gzip
    import os

    from tests.fixtures import make_bam, make_gff
    from pandepth_jax.cli import main as cli_main

    tmp = str(tmp_path)
    bam = os.path.join(tmp, "t.bam")
    make_bam(bam, n=700, seed=21)
    gff = os.path.join(tmp, "g.gff")
    make_gff(gff, overhang=False)

    for args in (["-i", bam],
                 ["-i", bam, "-g", gff],
                 ["-i", bam, "-w", "100"],
                 ["-i", bam, "-a", "-q", "20"]):
        o_sh = os.path.join(tmp, "sh")
        o_si = os.path.join(tmp, "si")
        monkeypatch.setenv("PANDEPTH_SHARDED", "1")
        assert cli_main(["pandepth"] + args + ["-o", o_sh]) == 0
        monkeypatch.setenv("PANDEPTH_SHARDED", "0")
        assert cli_main(["pandepth"] + args + ["-o", o_si]) == 0
        for suf in (".chr.stat.gz", ".gene.stat.gz", ".win.stat.gz",
                    ".SiteDepth.gz"):
            a, b = o_sh + suf, o_si + suf
            assert os.path.exists(a) == os.path.exists(b), suf
            if os.path.exists(a):
                assert gzip.open(a).read() == gzip.open(b).read(), \
                    (args, suf)


def test_multihost_engine_cached_state_eval():
    """MultihostCoverageEngine must run the all_to_all exchange + sort
    ONCE per feed: the first segment_stats caches the sharded sweep
    state, later calls (and later chunks of a big batch) ride the
    eval-only program — answers identical to the single-chip engine
    every time. (Single-process here: process_count()==1 over the 8
    virtual devices; the collective path is the same program.)"""
    from pandepth_jax.sharding.multihost import MultihostCoverageEngine

    rng = np.random.RandomState(3)
    lengths = np.array([5000, 2600], np.int64)
    layout = GenomeLayout(lengths)
    n = 600
    tid = rng.randint(0, 2, n).astype(np.int32)
    pos = rng.randint(0, 2400, n).astype(np.int64)
    ln = rng.randint(1, 180, n).astype(np.int64)

    ref = CoverageEngine(layout)
    mh = MultihostCoverageEngine(layout)
    for eng in (ref, mh):
        eng.add_intervals(tid, pos, pos + ln)

    seg_tid = np.array([0, 0, 1, 1], np.int32)
    s1 = np.array([1, 2000, 1, 700], np.int64)
    e1 = np.array([2500, 5000, 2600, 901], np.int64)
    a = ref.segment_stats(seg_tid, s1, e1)
    b1 = mh.segment_stats(seg_tid, s1, e1)       # exchange + cache
    assert mh._state is not None
    state_id = id(mh._state)
    b2 = mh.segment_stats(seg_tid, s1, e1)       # cached eval only
    assert id(mh._state) == state_id             # no re-exchange
    np.testing.assert_array_equal(a.cover, b1.cover)
    np.testing.assert_array_equal(a.depth_sum, b1.depth_sum)
    np.testing.assert_array_equal(b1.cover, b2.cover)
    np.testing.assert_array_equal(b1.depth_sum, b2.depth_sum)

    # chunked batch: chunk 2 -> first chunk builds (already built),
    # second chunk must reuse the state
    b3 = mh.segment_stats(seg_tid, s1, e1, chunk=2)
    np.testing.assert_array_equal(a.cover, b3.cover)
    np.testing.assert_array_equal(a.depth_sum, b3.depth_sum)

    # a new feed invalidates and rebuilds
    mh.add_intervals(np.zeros(1, np.int32), np.array([10]),
                     np.array([400]))
    ref.add_intervals(np.zeros(1, np.int32), np.array([10]),
                      np.array([400]))
    a4 = ref.segment_stats(seg_tid, s1, e1)
    b4 = mh.segment_stats(seg_tid, s1, e1)
    np.testing.assert_array_equal(a4.cover, b4.cover)
    np.testing.assert_array_equal(a4.depth_sum, b4.depth_sum)
