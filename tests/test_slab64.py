"""int64-tier (> 4 Gb genome) slabbed native finalize tests.

``hosteval._finalize_events_slabbed`` keeps the native 32-bit radix
kernel for wheat-scale pangenome layouts by partitioning events into
2 Gb coordinate slabs and carry-chaining the integrals.
Proven here: equality with the numpy twin (and a brute oracle) across
slab boundaries, wrap18/min_dep variants, keep_state dense equality,
engagement through the HostCoverageEngine on an int64 layout, and
full-CLI byte parity vs the reference binary on a 6.6 Gb genome.
"""

import glob
import os
import subprocess

import numpy as np
import pytest

from tests.fixtures import gunzip_bytes

from pandepth_jax.device import hosteval as he
from pandepth_jax.device.host_engine import HostCoverageEngine
from pandepth_jax.device.layout import GenomeLayout


def _twin(chunks, xp, xd, sentinel, lo, hi, min_dep, wrap18,
          keep_state):
    """The pure-numpy fallback, forced (native + slab paths off)."""
    import unittest.mock as mock

    with mock.patch.object(he, "_finalize_events_slabbed",
                           lambda *a, **k: None):
        with mock.patch.dict(os.environ, {"PANDEPTH_NO_NATIVE": "1"}):
            # finalize_events tries native first; int64 chunks already
            # make it bail, so only the slab path needs forcing off
            return he.finalize_events(chunks, xp, xd, sentinel, lo,
                                      hi, min_dep, wrap18, keep_state)


@pytest.mark.parametrize("min_dep,wrap18", [(1, False), (2, False),
                                            (1, True)])
@pytest.mark.parametrize("seed", [0, 3])
def test_slabbed_matches_numpy_twin(seed, min_dep, wrap18):
    rng = np.random.RandomState(seed)
    total = 7_000_000_000  # > 4 Gb -> int64 tier, 4 slabs
    sentinel = np.iinfo(np.int64).max
    n = 4000
    s = rng.randint(0, total - 500, n)
    # cluster extra events right at the slab boundaries
    for b in (1 << 31, 2 << 31, 3 << 31):
        s[rng.randint(0, n, 40)] = b - rng.randint(0, 300, 40)
    e = np.minimum(s + rng.randint(1, 400, n), total)
    # pad some sentinel slots like real feeds
    pad = np.full(64, sentinel)
    chunks = [(np.concatenate([s[: n // 2], pad]),
               np.concatenate([e[: n // 2], pad])),
              (s[n // 2:], e[n // 2:])]
    xp = rng.randint(0, total, 200)
    xd = rng.choice([-2, -1, 1, 2], 200).astype(np.int32)
    # keep the running depth nonnegative-ish: extras as +k then -k
    xd[:100] = np.abs(xd[:100])
    xp[100:] = xp[:100] + rng.randint(1, 1000, 100)
    xd[100:] = -xd[:100]
    lo = np.sort(rng.randint(0, total - 1000, 300))
    hi = lo + rng.randint(0, 2000, 300)
    got = he._finalize_events_slabbed(chunks, xp, xd, sentinel, lo,
                                      hi, min_dep, wrap18, True)
    assert got is not None, "native library unavailable"
    want = _twin(chunks, xp, xd, sentinel, lo, hi, min_dep, wrap18,
                 True)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    # state equality as DENSE depth (breakpoint sets may differ by
    # benign zero-delta entries)
    for a, b in ((1 << 31) - 500, (1 << 31) + 500), \
            (3_000_000_000, 3_000_002_000):
        da = he.dense_from_state(got[2][0].astype(np.int64),
                                 got[2][1], a, b)
        db = he.dense_from_state(want[2][0].astype(np.int64),
                                 want[2][1], a, b)
        np.testing.assert_array_equal(da, db)


def test_slab_path_engages_on_int64_tier(monkeypatch):
    """The host engine on a > 4 Gb layout must reach the slabbed
    native path (not silently fall to the numpy twin)."""
    calls = []
    real = he._finalize_events_slabbed

    def spy(*a, **k):
        r = real(*a, **k)
        calls.append(r is not None)
        return r

    monkeypatch.setattr(he, "_finalize_events_slabbed", spy)
    lengths = np.full(4, 1_700_000_000, np.int64)  # 6.8 Gb
    eng = HostCoverageEngine(GenomeLayout(lengths))
    assert eng.pos_dtype is np.int64
    rng = np.random.RandomState(2)
    s = rng.randint(0, int(eng.layout.total) - 200, 5000)
    eng.add_start_end(s, s + 150)
    st = eng.segment_stats(np.arange(4), np.ones(4, np.int64),
                           np.full(4, 1_700_000_000, np.int64))
    assert calls == [True]
    assert int(st.cover.sum()) > 0


def test_fold_on_int64_tier_matches_plain():
    """The streaming fold composed with the slabbed >4 Gb finalize:
    forced-hot folds on an int64 layout must match the plain engine
    (also guards the final fold's carry-query clamp — an unclamped
    int64 sentinel once sent the slab path iterating 2^32 slabs)."""
    rng = np.random.RandomState(5)
    lengths = np.full(4, 1_700_000_000, np.int64)  # 6.8 Gb
    layout = GenomeLayout(lengths)
    n = 3000
    tid = np.sort(rng.randint(0, 4, n))
    pos = np.empty(n, np.int64)
    for t in range(4):
        m = tid == t
        pos[m] = np.sort(rng.randint(0, lengths[t] - 500, m.sum()))
    s = layout.offsets[tid] + pos
    e = s + rng.randint(1, 400, n)
    qt = np.repeat(np.arange(4), 10).astype(np.int64)
    qa = np.tile(np.arange(10) * 170_000_000 + 1, 4)
    qb = qa + 169_999_999
    plain = HostCoverageEngine(layout)
    plain.add_start_end(s, e)
    fold = HostCoverageEngine(layout)
    assert fold.pos_dtype is np.int64
    fold.begin_streaming_fold(qt, qa, qb, threshold_pairs=64)
    for i in range(0, n, 97):
        fold.add_start_end(s[i:i + 97], e[i:i + 97])
    a = plain.segment_stats(qt, qa, qb)
    b = fold.segment_stats(qt, qa, qb)
    assert fold._fold_engaged
    np.testing.assert_array_equal(a.cover, b.cover)
    np.testing.assert_array_equal(a.depth_sum, b.depth_sum)


def test_device_and_sharded_engines_int64_match_host():
    """The jax engines on a > 4 Gb layout (int64 positions, the wheat
    tier) must agree with the host engine — the device path is what a
    locally attached backend would elect there."""
    from pandepth_jax.device.engine import CoverageEngine
    from pandepth_jax.sharding.engine import ShardedCoverageEngine

    rng = np.random.RandomState(11)
    lengths = np.full(4, 1_700_000_000, np.int64)
    layout = GenomeLayout(lengths)
    n = 1500
    tid = np.sort(rng.randint(0, 4, n))
    pos = rng.randint(0, 1_700_000_000 - 500, n)
    s = layout.offsets[tid] + np.sort(pos)
    e = np.minimum(s + rng.randint(1, 400, n), layout.limits[tid])
    qt = np.repeat(np.arange(4), 6).astype(np.int64)
    qa = np.tile(np.arange(6) * 280_000_000 + 1, 4)
    qb = qa + 279_999_999
    host = HostCoverageEngine(layout)
    host.add_start_end(s, e)
    want = host.segment_stats(qt, qa, qb)
    for cls in (CoverageEngine, ShardedCoverageEngine):
        eng = cls(layout)
        assert eng.pos_dtype is np.int64, cls.__name__
        eng.add_start_end(s, e)
        got = eng.segment_stats(qt, qa, qb)
        np.testing.assert_array_equal(got.cover, want.cover,
                                      err_msg=cls.__name__)
        np.testing.assert_array_equal(got.depth_sum, want.depth_sum,
                                      err_msg=cls.__name__)


def test_cli_int64_genome_vs_reference(tmp_path, oracle_bin):
    """Full-CLI byte parity on a 6.6 Gb genome (int64 tier) vs the
    reference binary — the slabbed native path end-to-end."""
    from pandepth_jax.cli import parse_args
    from pandepth_jax.io.bam_writer import write_uniform_bam
    from pandepth_jax.run import run

    tmp = str(tmp_path)
    names = ["w1", "w2", "w3", "w4"]
    lengths = [1_650_000_000] * 4
    rng = np.random.RandomState(21)
    n = 6000
    tid = np.sort(rng.randint(0, 4, n)).astype(np.int32)
    pos = np.zeros(n, np.int32)
    for t in range(4):
        m = int((tid == t).sum())
        pos[tid == t] = np.sort(
            (rng.rand(m) * (lengths[t] - 200)).astype(np.int64)
        ).astype(np.int32)
    flag = np.where(rng.rand(n) < 0.08, 1024, 0).astype(np.uint16)
    mapq = rng.randint(0, 61, n).astype(np.uint8)
    bam = os.path.join(tmp, "w.bam")
    write_uniform_bam(bam, names, lengths, tid, pos, flag, mapq)

    ref_out = os.path.join(tmp, "ref")
    subprocess.run([oracle_bin, "-i", bam, "-o", ref_out],
                   check=True, capture_output=True)
    cfg = parse_args(["pandepth", "-i", bam, "-o",
                      os.path.join(tmp, "ours")])
    assert cfg is not None and run(cfg) == 0
    ref_tables = sorted(glob.glob(ref_out + "*.gz"))
    assert ref_tables
    for rt in ref_tables:
        suffix = os.path.basename(rt)[len("ref"):]
        ot = os.path.join(tmp, "ours" + suffix)
        assert gunzip_bytes(ot) == gunzip_bytes(rt), suffix
