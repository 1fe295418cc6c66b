"""HostCoverageEngine (device/host_engine.py): the jax-free host
finalize path — native kernel differential vs a numpy oracle, engine
equality vs the device CoverageEngine, CLI byte parity vs the
reference binary, and the election rules (run._want_host_finalize)."""

import gzip
import os
import subprocess
import sys

import numpy as np
import pytest

from pandepth_jax.device.host_engine import HostCoverageEngine
from pandepth_jax.device.layout import GenomeLayout

from tests.fixtures import CONTIGS, gunzip_bytes, make_bam, make_gff

SENT32 = 0xFFFFFFFF


def _oracle(pos, dlt, qlo, qhi, min_dep, wrap18, sentinel):
    """Plain-numpy sweep oracle (independent of hosteval)."""
    order = np.argsort(pos, kind="stable")
    p, d = pos[order].astype(np.int64), dlt[order]
    d = np.where(p == sentinel, 0, d)
    depth = np.cumsum(d)
    if wrap18:
        depth = depth & 0x3FFFF
    nxt = np.append(p[1:], np.iinfo(np.int64).max)
    plen = np.where(depth >= min_dep, nxt - p, 0)
    ccov = np.cumsum(plen)
    csum = np.cumsum(plen * depth)

    def q(x):
        r = np.searchsorted(p, x, side="left")
        i_f = np.clip(r - 2, 0, len(p) - 1)
        i_p = np.clip(r - 1, 0, len(p) - 1)
        fc = np.where(r >= 2, ccov[i_f], 0)
        fs = np.where(r >= 2, csum[i_f], 0)
        ind = (depth[i_p] >= min_dep).astype(np.int64)
        pl = np.where(r >= 1, (x - p[i_p]) * ind, 0)
        return fc + pl, fs + pl * depth[i_p]

    c1, s1 = q(qhi)
    c0, s0 = q(qlo)
    return c1 - c0, s1 - s0


@pytest.mark.parametrize("seed", range(6))
def test_native_kernel_vs_numpy_oracle(seed):
    from pandepth_jax.io.native import host_finalize, load_library

    if load_library() is None:
        pytest.skip("native library unavailable")
    rng = np.random.RandomState(seed)
    n = rng.randint(1, 8000)
    starts = rng.randint(0, 200000, n).astype(np.uint32)
    ends = starts + rng.randint(0, 400, n).astype(np.uint32)
    k = rng.randint(0, n)  # sentinel tail
    starts[n - k:] = SENT32
    ends[n - k:] = SENT32
    cuts = sorted(rng.randint(0, n + 1, rng.randint(0, 4)).tolist())
    bounds = [0] + cuts + [n]
    chunks = [(starts[a:b], ends[a:b])
              for a, b in zip(bounds[:-1], bounds[1:])]
    ne = rng.randint(0, 200)
    xp = rng.randint(0, 200000, ne).astype(np.uint32)
    xd = rng.randint(-2, 3, ne).astype(np.int32)
    nq = rng.randint(1, 500)
    qlo = rng.randint(0, 210000, nq).astype(np.int64)
    qhi = qlo + rng.randint(0, 9000, nq)
    md = int(rng.choice([1, 2, 5]))
    w18 = bool(rng.randint(0, 2))
    c, s, st = host_finalize(list(chunks), SENT32, xp, xd, qlo, qhi,
                             md, w18, keep_state=(seed % 2 == 0))
    pos = np.concatenate([starts, ends, xp]).astype(np.int64)
    dlt = np.concatenate([np.ones(n, np.int64), -np.ones(n, np.int64),
                          xd.astype(np.int64)])
    ec, es = _oracle(pos, dlt, qlo, qhi, md, w18, SENT32)
    np.testing.assert_array_equal(c, ec)
    np.testing.assert_array_equal(s, es)
    if st is not None:
        assert np.all(np.diff(st[0]) >= 0)
        assert st[0].shape[0] == int(np.sum(pos != SENT32))


def _random_feed(eng, rng, n=3000):
    lay = eng.layout
    tid = rng.randint(0, lay.n_targets, n).astype(np.int32)
    start = rng.randint(0, 4000, n).astype(np.int64)
    end = start + rng.randint(0, 500, n)
    eng.add_intervals(tid, start, end)


def test_equality_vs_device_engine():
    """Same feeds, same queries: HostCoverageEngine must equal the
    (CPU-backend) device CoverageEngine exactly — segment stats,
    dense depth, grid and sorted host evals."""
    from pandepth_jax.device.engine import CoverageEngine

    lengths = np.array([c[1] for c in CONTIGS], np.int64)
    for wrap18, min_dep in ((False, 1), (False, 3), (True, 1)):
        rng1 = np.random.RandomState(9)
        rng2 = np.random.RandomState(9)
        h = HostCoverageEngine(GenomeLayout(lengths), min_dep=min_dep,
                               wrap18=wrap18)
        d = CoverageEngine(GenomeLayout(lengths), min_dep=min_dep,
                           wrap18=wrap18)
        _random_feed(h, rng1)
        _random_feed(d, rng2)
        rng = np.random.RandomState(3)
        seg_tid = rng.randint(0, len(lengths), 200).astype(np.int32)
        s1 = rng.randint(1, 5000, 200).astype(np.int64)
        e1 = s1 + rng.randint(0, 1000, 200)
        a = h.segment_stats(seg_tid, s1, e1)
        b = d.segment_stats(seg_tid, s1, e1)
        np.testing.assert_array_equal(a.cover, b.cover)
        np.testing.assert_array_equal(a.depth_sum, b.depth_sum)
        for tid in range(len(lengths)):
            np.testing.assert_array_equal(h.dense_depth(tid),
                                          d.dense_depth(tid))
        # regular grid (window_stats_host) + sorted host eval
        from pandepth_jax.targets.windows import small_window_tiling

        parts = []
        for tid in range(len(lengths)):
            t = small_window_tiling(int(lengths[tid]), 150)
            parts.append((np.full(t.shape[0], tid, np.int32),
                          t[:, 0], t[:, 1]))
        gt = np.concatenate([p[0] for p in parts])
        gs = np.concatenate([p[1] for p in parts])
        ge = np.concatenate([p[2] for p in parts])
        wa = h.window_stats_host(gt, gs, ge, 150)
        wb = d.window_stats_host(gt, gs, ge, 150)
        assert wa is not None and wb is not None
        np.testing.assert_array_equal(wa.cover, wb.cover)
        np.testing.assert_array_equal(wa.depth_sum, wb.depth_sum)
        sa = h.segment_stats_sorted_host(gt, gs, ge)
        np.testing.assert_array_equal(sa.cover, wa.cover)


def test_add_batch_and_events_paths():
    """ReadBatch and raw-event feeds must agree between engines."""
    from pandepth_jax.device.engine import CoverageEngine
    from pandepth_jax.io.bam import BamReader

    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        bam = os.path.join(tmp, "t.bam")
        make_bam(bam, n=500, seed=31)
        lengths = np.array([c[1] for c in CONTIGS], np.int64)
        h = HostCoverageEngine(GenomeLayout(lengths))
        d = CoverageEngine(GenomeLayout(lengths))
        for b in BamReader(bam).batches():
            h.add_batch(b)
        for b in BamReader(bam).batches():
            d.add_batch(b)
        ev_pos = np.array([10, 50, 50, 9000], np.int64)
        ev_dlt = np.array([2, -1, -1, 1], np.int32)
        h.add_events(ev_pos, ev_dlt)
        d.add_events(ev_pos, ev_dlt)
        seg_tid = np.arange(len(lengths), dtype=np.int32)
        a = h.segment_stats(seg_tid, np.ones(len(lengths), np.int64),
                            lengths)
        b2 = d.segment_stats(seg_tid, np.ones(len(lengths), np.int64),
                             lengths)
        np.testing.assert_array_equal(a.cover, b2.cover)
        np.testing.assert_array_equal(a.depth_sum, b2.depth_sum)
        assert h.n_reads_seen == d.n_reads_seen


def test_cli_parity_forced_host(tmp_path, oracle_bin):
    """PANDEPTH_HOST_FINALIZE=1 end-to-end vs the reference binary
    (chr, gene+GC, -a, small windows, filters)."""
    bam = str(tmp_path / "t.bam")
    fa = str(tmp_path / "ref.fa")
    gff = str(tmp_path / "g.gff")
    make_bam(bam, n=500, seed=41)
    from tests.fixtures import make_fasta

    make_fasta(fa)
    make_gff(gff, overhang=False)
    from pandepth_jax.cli import main as cli_main

    cases = ([], ["-g", gff, "-c", "-r", fa], ["-a"], ["-w", "100"],
             ["-q", "30", "-x", "260", "-d", "2"])
    os.environ["PANDEPTH_HOST_FINALIZE"] = "1"
    try:
        for extra in cases:
            rc = cli_main(["pandepth", "-i", bam,
                           "-o", str(tmp_path / "ours")] + extra)
            assert rc == 0
            subprocess.run([oracle_bin, "-i", bam,
                            "-o", str(tmp_path / "ref")] + extra,
                           check=True, capture_output=True)
            import glob

            ref_files = sorted(glob.glob(str(tmp_path / "ref*.gz")))
            assert ref_files
            for rf in ref_files:
                of = os.path.join(os.path.dirname(rf),
                                  os.path.basename(rf).replace(
                                      "ref", "ours", 1))
                assert gunzip_bytes(of) == gunzip_bytes(rf), \
                    (extra, os.path.basename(rf))
                os.remove(rf)
    finally:
        os.environ.pop("PANDEPTH_HOST_FINALIZE", None)


def test_int64_tier_falls_back_correctly():
    """>4 Gb padded genomes ride int64 positions; the native kernel is
    u32-only and must be REFUSED (viewing int64 as u32 silently split
    positions into bogus events — review finding r3), with the numpy
    sweep producing correct stats."""
    from pandepth_jax.io.native import host_finalize, load_library

    lengths = np.array([3_000_000_000, 2_000_000_000], np.int64)
    eng = HostCoverageEngine(GenomeLayout(lengths))
    assert eng.pos_dtype is np.int64
    eng.add_intervals(np.array([1], np.int32),
                      np.array([1_500_000_000], np.int64),
                      np.array([1_500_000_100], np.int64))
    st = eng.segment_stats(np.array([0, 1], np.int32),
                           np.ones(2, np.int64), lengths)
    assert st.cover.tolist() == [0, 100]
    assert st.depth_sum.tolist() == [0, 100]
    if load_library() is not None:
        s = np.array([1_500_000_000], np.int64)
        e = np.array([1_500_000_100], np.int64)
        assert host_finalize([(s, e)], np.iinfo(np.int64).max, None,
                             None, np.zeros(1, np.int64),
                             np.ones(1, np.int64), 1, False,
                             False) is None


def test_empty_event_set(tmp_path, oracle_bin):
    """Every read filtered (-q 255) still produces parity tables —
    the numpy host evals must handle a zero-event sweep (found by the
    host-engine fuzz burst: seed 20532, CRAM + -w 7 + -q 255)."""
    from pandepth_jax.cli import main as cli_main

    bam = str(tmp_path / "t.bam")
    make_bam(bam, n=100, seed=55)
    os.environ["PANDEPTH_HOST_FINALIZE"] = "1"
    try:
        for extra in (["-q", "255"], ["-q", "255", "-w", "7"],
                      ["-q", "255", "-a"]):
            rc = cli_main(["pandepth", "-i", bam,
                           "-o", str(tmp_path / "ours")] + extra)
            assert rc == 0
            subprocess.run([oracle_bin, "-i", bam,
                            "-o", str(tmp_path / "ref")] + extra,
                           check=True, capture_output=True)
            import glob

            for rf in sorted(glob.glob(str(tmp_path / "ref*.gz"))):
                of = os.path.join(os.path.dirname(rf),
                                  os.path.basename(rf).replace(
                                      "ref", "ours", 1))
                assert gunzip_bytes(of) == gunzip_bytes(rf), \
                    (extra, os.path.basename(rf))
                os.remove(rf)
    finally:
        os.environ.pop("PANDEPTH_HOST_FINALIZE", None)


def test_election_rules(monkeypatch):
    from pandepth_jax.run import _want_host_finalize

    monkeypatch.setenv("PANDEPTH_HOST_FINALIZE", "1")
    assert _want_host_finalize() is True
    monkeypatch.setenv("PANDEPTH_HOST_FINALIZE", "0")
    assert _want_host_finalize() is False
    monkeypatch.delenv("PANDEPTH_HOST_FINALIZE")
    # unset: the device engines, whatever the platform
    for plat in ("cpu", "cuda", ""):
        monkeypatch.setenv("JAX_PLATFORMS", plat)
        assert _want_host_finalize() is False
    # a forced host engine never applies to sharded/multihost contexts
    monkeypatch.setenv("PANDEPTH_HOST_FINALIZE", "1")
    monkeypatch.setenv("PANDEPTH_SHARDED", "1")
    assert _want_host_finalize() is False
    monkeypatch.delenv("PANDEPTH_SHARDED")
    monkeypatch.setenv("PANDEPTH_MULTIHOST", "1")
    assert _want_host_finalize() is False
    monkeypatch.delenv("PANDEPTH_MULTIHOST")
    # inside the resident daemon the same env rule holds
    import pandepth_jax.serve as serve

    monkeypatch.setattr(serve, "IN_PROCESS_DAEMON", True)
    assert _want_host_finalize() is True
    monkeypatch.delenv("PANDEPTH_HOST_FINALIZE")
    assert _want_host_finalize() is False


def test_int64_tier_elects_host_engine(monkeypatch):
    """A >4 Gb layout (int64 coordinate tier, past the native radix
    kernel's 32-bit width) must STILL elect the host engine when it is
    forced: the slabbed native kernel inside
    hosteval.finalize_events answers across the 2^32 boundary."""
    from pandepth_jax.io.native import load_library

    if load_library() is None:
        pytest.skip("native library unavailable")
    monkeypatch.setenv("PANDEPTH_HOST_FINALIZE", "1")
    from pandepth_jax.run import make_engine

    lay = GenomeLayout(np.array([2_500_000_000, 2_400_000_000]))
    assert lay.total > (1 << 32)
    eng = make_engine(lay)
    assert isinstance(eng, HostCoverageEngine)
    assert not eng.pos_bits32  # int64 tier -> slabbed native sweep
    # and it answers correctly across the 2^32 boundary
    s = np.array([100, 2_499_999_900, 4_000_000_000], np.int64)
    eng.add_start_end(s, s + 150)
    st = eng.segment_stats(np.array([0, 0, 1]),
                           np.array([1, 2_499_999_000, 1]),
                           np.array([10_000, 2_500_000_000,
                                     2_400_000_000]))
    np.testing.assert_array_equal(st.cover, [150, 100, 150])
    np.testing.assert_array_equal(st.depth_sum, st.cover)


@pytest.mark.parametrize("env,line", [
    ({"PANDEPTH_HOST_FINALIZE": "1"},
     "INFO: engine=HostCoverageEngine device=host"),
    ({"PANDEPTH_SHARDED": "0"},
     "INFO: engine=CoverageEngine device=cpu:cpu x8"),
    ({}, "INFO: engine=ShardedCoverageEngine device=cpu:cpu x8"),
])
def test_verbose_engine_line(monkeypatch, capsys, env, line):
    """-v names the elected engine and the device it runs on (the
    suite's CPU backend has 8 virtual devices)."""
    from pandepth_jax.run import make_engine
    from pandepth_jax.utils import log

    for k in ("PANDEPTH_HOST_FINALIZE", "PANDEPTH_SHARDED"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(log, "_VERBOSE", True)
    make_engine(GenomeLayout(np.array([10_000])))
    assert line in capsys.readouterr().err.splitlines()
