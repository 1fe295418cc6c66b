"""Pre-engine window stash (run._EncPuller + _feed_stream stash args):
windows pulled before the engine exists — to overlap decode with the
background jax init (boot.py) — must produce identical statistics,
both through the encoded device path and the host-decode fallback for
engines without encoded-window support (the sharded engine)."""

import os

import numpy as np
import pytest

from pandepth_jax.config import RunConfig
from pandepth_jax.device.engine import CoverageEngine
from pandepth_jax.device.layout import GenomeLayout
from pandepth_jax.io.bam import read_bam_header
from pandepth_jax.run import _EncPuller, _enc_caps, _feed_stream

from fixtures import CONTIGS, make_bam

pytestmark = pytest.mark.skipif(
    os.environ.get("PANDEPTH_NO_NATIVE") == "1",
    reason="needs the native stream loader")


def _native_stream(path):
    from pandepth_jax.io.native import NativeBamStream, load_library
    if load_library() is None:
        pytest.skip("libpancov_io unavailable")
    return NativeBamStream(path, 1796, -1)


def _whole_contig_stats(engine, lengths):
    tids = np.arange(len(lengths), dtype=np.int64)
    starts = np.zeros(len(lengths), np.int64)
    return engine.segment_stats(tids, starts,
                                np.asarray(lengths, np.int64))


def _expected(bam, lengths):
    eng = CoverageEngine(GenomeLayout(np.asarray(lengths, np.int64)))
    _feed_stream(eng, _native_stream(bam))
    st = _whole_contig_stats(eng, lengths)
    return st.cover.copy(), st.depth_sum.copy(), eng.n_reads_seen


@pytest.mark.parametrize("n_stash", [2, 10_000])
def test_stash_then_stream_parity(tmp_path, monkeypatch, n_stash):
    """Stash a few windows (or the whole file, n_stash large) before
    the engine exists; totals must match a plain feed."""
    monkeypatch.setenv("PANDEPTH_ENC_CAP", "1024")
    monkeypatch.setenv("PANDEPTH_ENC_EXC", "128")
    bam = str(tmp_path / "t.bam")
    make_bam(bam, n=3000, seed=31)
    lengths = [c[1] for c in CONTIGS]
    want_cover, want_dsum, want_reads = _expected(bam, lengths)

    r = _native_stream(bam)
    puller = _EncPuller(r, *_enc_caps())
    stash = []
    while len(stash) < n_stash and not puller.eof:
        win = puller.next()
        if win is not None:
            stash.append(win)
    assert stash, "fixture produced no encoded windows"
    eng = CoverageEngine(GenomeLayout(np.asarray(lengths, np.int64)))
    _feed_stream(eng, r, puller=puller, stash=stash)
    st = _whole_contig_stats(eng, lengths)
    assert np.array_equal(st.cover, want_cover)
    assert np.array_equal(st.depth_sum, want_dsum)
    assert eng.n_reads_seen == want_reads


def test_stash_host_decode_into_sharded_engine(tmp_path, monkeypatch):
    """An engine without encoded-window support receives host-decoded
    events for both the stash and the remaining stream."""
    monkeypatch.setenv("PANDEPTH_ENC_CAP", "1024")
    monkeypatch.setenv("PANDEPTH_ENC_EXC", "128")
    from pandepth_jax.sharding.engine import ShardedCoverageEngine

    bam = str(tmp_path / "t.bam")
    make_bam(bam, n=2500, seed=32)
    lengths = [c[1] for c in CONTIGS]
    want_cover, want_dsum, want_reads = _expected(bam, lengths)

    r = _native_stream(bam)
    puller = _EncPuller(r, *_enc_caps())
    stash = []
    while len(stash) < 3 and not puller.eof:
        win = puller.next()
        if win is not None:
            stash.append(win)
    eng = ShardedCoverageEngine(GenomeLayout(np.asarray(lengths,
                                                        np.int64)))
    assert not getattr(eng, "wants_encoded_windows", False)
    _feed_stream(eng, r, puller=puller, stash=stash)
    st = _whole_contig_stats(eng, lengths)
    assert np.array_equal(st.cover, want_cover)
    assert np.array_equal(st.depth_sum, want_dsum)
    assert eng.n_reads_seen == want_reads


def test_cli_prepull_engages(tmp_path, monkeypatch):
    """End-to-end: with boot started and deliberately not ready, the
    CLI stashes windows pre-engine and the table is unchanged."""
    import gzip

    from pandepth_jax import boot
    from pandepth_jax.cli import main as cli_main

    bam = str(tmp_path / "t.bam")
    make_bam(bam, n=1500, seed=33)
    rc = cli_main(["pandepth", "-i", bam, "-o",
                   str(tmp_path / "plain")])
    assert rc == 0

    # simulate "init still running": started but not ready for the
    # first few polls
    polls = {"n": 0}
    monkeypatch.setattr(boot, "init_started", lambda: True)

    def fake_ready():
        polls["n"] += 1
        return polls["n"] > 3

    monkeypatch.setattr(boot, "is_ready", fake_ready)
    monkeypatch.setenv("PANDEPTH_ENC_CAP", "1024")
    monkeypatch.setenv("PANDEPTH_ENC_EXC", "128")
    rc = cli_main(["pandepth", "-i", bam, "-o",
                   str(tmp_path / "stashed")])
    assert rc == 0
    assert polls["n"] > 1  # the pre-pull loop actually polled
    with gzip.open(str(tmp_path / "plain.chr.stat.gz")) as fh:
        a = fh.read()
    with gzip.open(str(tmp_path / "stashed.chr.stat.gz")) as fh:
        b = fh.read()
    assert a == b
