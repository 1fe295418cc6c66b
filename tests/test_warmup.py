"""Finalize-program warm-up: shape prediction, the signature sidecar
gate, and the native stream's progress estimate.

The warm-up itself only matters on an accelerator backend (the suite
runs on CPU where the engine disarms it), so these tests drive the
planning/prediction pieces directly with synthetic counters."""

import json
import os

import numpy as np
import pytest

from pandepth_jax.device.engine import (CoverageEngine,
                                        _load_warm_sigs,
                                        _record_warm_sig)
from pandepth_jax.device.layout import GenomeLayout

from tests.fixtures import make_bam


@pytest.fixture
def sig_sidecar(tmp_path, monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    return tmp_path / "jc" / "finalize_signatures.json"


def _armed_engine():
    eng = CoverageEngine(GenomeLayout(np.array([1_000_000])))
    # the suite runs on the CPU backend where plan_finalize_warmup
    # correctly disarms; force the accelerator-side planning path
    eng._platform = "gpu"
    eng.plan_finalize_warmup(100_000, want_state=False)
    assert eng._warm_plan == (131072, False)
    return eng


def test_sidecar_roundtrip(sig_sidecar):
    sig = ("gpu", 1, 2, 512, "scan_unrolled", False, 1, False,
           "uint32", 1 << 19, 1 << 13, 8)
    assert sig not in _load_warm_sigs()
    _record_warm_sig(sig)
    assert sig in _load_warm_sigs()
    _record_warm_sig(sig)  # idempotent
    with open(sig_sidecar) as fh:
        assert len(json.load(fh)) == 1


def test_unknown_signature_never_warms(sig_sidecar, monkeypatch):
    eng = _armed_engine()
    fired = []
    monkeypatch.setattr(CoverageEngine, "_warm_finalize",
                        lambda self, *a: fired.append(a))
    eng._n_win8, eng._n_pairs_enc = 2, 2 * eng.enc_cap
    eng._last_enc_group = "8"    # as add_encoded_window would set
    eng.maybe_warm_finalize(0.5, 2 * eng.enc_cap)
    assert fired == []               # sidecar empty: must not compile
    assert eng._warm_shapes == (1, 0, 0, 0)  # one attempt, then latched


def test_known_signature_warms_once(sig_sidecar, monkeypatch):
    eng = _armed_engine()
    fired = []
    monkeypatch.setattr(CoverageEngine, "_warm_finalize",
                        lambda self, *a: fired.append(a))
    # 2 of an estimated 4 windows seen at frac 0.5 -> 4 u8 windows
    # -> 1 block -> k8p=1, k16p=0
    eng._n_win8, eng._n_pairs_enc = 2, 2 * eng.enc_cap
    eng._last_enc_group = "8"
    _record_warm_sig(eng._finalize_sig(1, 0, 0, 0))
    eng.maybe_warm_finalize(0.5, 2 * eng.enc_cap)
    eng.maybe_warm_finalize(0.6, 3 * eng.enc_cap)  # latched: no re-fire
    eng._warm_thread_obj.join(5)
    assert fired == [(1, 0, 0, 0)]


def test_tier_upgrade_predicts_u16(sig_sidecar, monkeypatch):
    eng = _armed_engine()
    fired = []
    monkeypatch.setattr(CoverageEngine, "_warm_finalize",
                        lambda self, *a: fired.append(a))
    # one short u8 window then a full u16 window packed (3*cap pairs
    # consumed) while the PRODUCER has already emitted 6*cap pairs at
    # 25% progress: est_total = 24*cap pairs -> 21*cap unpacked -> 21
    # more windows at the upgraded u16 tier -> 22 u16 windows -> 3
    # blocks of 8 -> k16p padded to 4
    eng._n_win8, eng._n_win16 = 1, 1
    eng._last_enc_group = "16"
    eng._n_pairs_enc = 3 * eng.enc_cap
    _record_warm_sig(eng._finalize_sig(1, 4, 0, 0))
    eng.maybe_warm_finalize(0.25, 6 * eng.enc_cap)
    eng._warm_thread_obj.join(5)
    assert fired == [(1, 4, 0, 0)]


def _enc_window(eng, n, dtype, base):
    """One valid compact-encoded window: n unit-length events at
    base+1, base+2, ... (zigzag delta +1 = code 2), zero-padded to
    enc_cap (zero codes decode to depth-neutral zero-length events)."""
    dd = np.zeros(eng.enc_cap, dtype)
    ll = np.zeros(eng.enc_cap, dtype)
    dd[:n] = 2
    ll[:n] = 1
    exc = np.zeros(eng.enc_exc, np.int64)
    return n, dd, ll, exc, exc.copy(), base


def test_predictor_matches_real_finalize(sig_sidecar, monkeypatch):
    """End-to-end predictor accuracy on a real two-tier encoded feed:
    the signature predicted mid-stream must equal the signature the
    real finalize actually compiles and records.
    Drives the very same add_encoded_window / segment_stats calls
    run._EncPuller issues, with exact progress numbers so a correct
    predictor has no slack."""
    monkeypatch.setenv("PANDEPTH_ENC_CAP", "4096")
    monkeypatch.setenv("PANDEPTH_ENC_EXC", "64")
    monkeypatch.setenv("PANDEPTH_ENC_BLOCK", "8")
    eng = CoverageEngine(GenomeLayout(np.array([1_000_000])))
    eng._platform = "gpu"  # CPU suite: force accelerator planning
    n_segments = 10
    eng.plan_finalize_warmup(n_segments, want_state=False)
    cap = eng.enc_cap

    # the real feed: 2 full u8 windows, then the tier upgrades and 6
    # full u16 windows follow — 8*cap pairs total
    feed = [(cap, np.uint8), (cap, np.uint8)] + \
        [(cap, np.uint16)] * 6
    for i, (n, dt) in enumerate(feed[:4]):
        eng.add_encoded_window(*_enc_window(eng, n, dt, i * 3 * cap))
    # mid-feed snapshot: producer at 50%, having emitted half the
    # pairs; consumer fully caught up (4*cap packed)
    eng.maybe_warm_finalize(0.5, 4 * cap)
    assert eng._warm_shapes is not None
    predicted = eng._finalize_sig(*eng._warm_shapes)
    for i, (n, dt) in enumerate(feed[4:], start=4):
        eng.add_encoded_window(*_enc_window(eng, n, dt, i * 3 * cap))

    seg_start = np.arange(n_segments, dtype=np.int64) * 3 * cap + 1
    st = eng.segment_stats(np.zeros(n_segments, np.int64), seg_start,
                           seg_start + cap - 1, keep_state=False)
    # the real finalize recorded its compiled signature; the predictor
    # must have produced exactly that tuple
    assert predicted in _load_warm_sigs(), \
        (predicted, sorted(_load_warm_sigs()))
    # and the engine's answers are right: each queried span holds cap
    # unit events at consecutive positions starting one past seg_start
    assert (np.asarray(st.cover)[: 8] >= cap - 1).all()
    assert (np.asarray(st.depth_sum) >= np.asarray(st.cover)).all()


def _drain_progress(s):
    prev_frac, prev_pairs = 0.0, 0
    while True:
        n = s.wait()
        if n < 0:
            break
        frac, pairs = s.progress()
        assert 0.0 <= frac <= 1.0
        assert frac >= prev_frac and pairs >= prev_pairs
        prev_frac, prev_pairs = frac, pairs
        if n > 0:
            s.take64(n)
        else:
            s.take64(0)
    s.close()
    return prev_frac, prev_pairs


def test_stream_progress_monotone(tmp_path):
    from pandepth_jax.io.native import NativeBamStream, load_library

    if load_library() is None:
        pytest.skip("native library unavailable")
    bam = str(tmp_path / "p.bam")
    make_bam(bam, n=4000, seed=11)
    frac, pairs = _drain_progress(NativeBamStream(bam, 1796, -1))
    assert frac == 1.0
    assert pairs > 0


def test_ranged_stream_progress_converges(tmp_path):
    """Many-range walks discard over-read tails at every range switch;
    those bytes are budgeted in comp_total and must still be settled
    into comp_consumed or frac undershoots and the warm-up window
    (frac >= 0.25) opens late or never (advisor r2)."""
    from pandepth_jax.io.bamindex import (chunks_for_windows,
                                          load_index_for)
    from pandepth_jax.io.native import NativeBamStream, load_library

    if load_library() is None:
        pytest.skip("native library unavailable")
    bam = str(tmp_path / "rp.bam")
    rng = np.random.RandomState(3)
    ps = np.sort(rng.randint(0, 39_000_000, 60_000))
    from tests.fixtures import write_bam

    write_bam(bam, ["c0"], [40_000_000],
              [(0, int(p), 0, 60, "100M") for p in ps])
    # many sparse ranges -> many range switches, each with an
    # over-read discarded tail
    picks = [(0, s, s + 50_000) for s in range(0, 39_000_000,
                                               2_000_000)]
    cnt = np.array([len(picks)], np.int64)
    fw = (np.concatenate([[0], np.cumsum(cnt)]),
          np.array([p[1] for p in picks], np.int64),
          np.array([p[2] for p in picks], np.int64), 1)
    idx = load_index_for(bam)
    assert idx is not None
    vr = chunks_for_windows(idx, fw)
    assert vr.shape[0] > 2  # genuinely multi-range
    frac, pairs = _drain_progress(
        NativeBamStream(bam, 1796, -1, regions=fw, vranges=vr,
                        window_bytes=1 << 18))
    assert frac >= 0.999, frac
    assert pairs > 0


def test_real_dispatch_waits_for_warmup(sig_sidecar, monkeypatch):
    """A warm-up thread still inside a device call when the process
    exits aborts its teardown: segment_stats joins every warm-up
    thread before its own dispatch."""
    import threading

    eng = _armed_engine()
    release = threading.Event()
    done = []

    def slow_warm(self, *a):
        release.wait(5)
        done.append(a)

    monkeypatch.setattr(CoverageEngine, "_warm_finalize", slow_warm)
    eng._n_win8, eng._n_pairs_enc = 2, 2 * eng.enc_cap
    eng._last_enc_group = "8"
    _record_warm_sig(eng._finalize_sig(1, 0, 0, 0))
    eng.maybe_warm_finalize(0.5, 2 * eng.enc_cap)
    t = eng._warm_thread_obj
    assert t.is_alive()
    threading.Timer(0.2, release.set).start()
    eng.segment_stats(np.zeros(1, np.int64), np.ones(1, np.int64),
                      np.full(1, 10, np.int64))
    assert not t.is_alive() and done == [(1, 0, 0, 0)]


def test_raw_feed_never_arms_warmup(sig_sidecar, monkeypatch):
    """The warmed program is the encoded finalize: an engine fed raw
    positions arms no warm-up."""
    monkeypatch.setenv("PANDEPTH_ENC", "0")
    eng = CoverageEngine(GenomeLayout(np.array([1_000_000])))
    eng._platform = "gpu"
    eng.plan_finalize_warmup(100_000, want_state=False)
    assert eng._warm_plan is None
