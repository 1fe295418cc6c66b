"""uint32 device-position tier (2-4 Gb genomes).

Global positions mod 2^32 are exact below 4 Gb, so the engine rides
uint32 coordinates there: half the int64 sort width and the same
truncating-int32 native stores as the int32 tier (reinterpreted via
.view). These tests pin the tier selection, check bit-exactness against
a numpy int64 oracle right at the 2^31 sign boundary (where truncated
bit patterns turn "negative" as int32), and run the full CLI
differentially against the reference binary on a >2^31 genome through
our own .csi index (reference low-mem windowed path,
/root/reference/src/PanDepth.cpp:618-801).
"""

import glob
import os
import subprocess

import numpy as np
import pytest

from pandepth_jax.device.engine import CoverageEngine, pos_dtype_for
from pandepth_jax.device.layout import GenomeLayout
from tests.fixtures import gunzip_bytes


def test_tier_boundaries():
    assert pos_dtype_for(1000) is np.int32
    assert pos_dtype_for((1 << 31) - 3) is np.int32
    assert pos_dtype_for((1 << 31) - 2) is np.uint32
    assert pos_dtype_for(3_000_000_000) is np.uint32
    assert pos_dtype_for((1 << 32) - 3) is np.uint32
    assert pos_dtype_for((1 << 32) - 2) is np.int64
    assert pos_dtype_for(17_000_000_000) is np.int64


def _oracle_stats(starts, ends, seg_lo, seg_hi, min_dep=1):
    """int64 numpy event-sweep oracle: cover/dsum per [lo, hi)."""
    pos = np.concatenate([starts, ends]).astype(np.int64)
    delta = np.concatenate([np.ones_like(starts),
                            -np.ones_like(ends)]).astype(np.int64)
    order = np.argsort(pos, kind="stable")
    pos, delta = pos[order], delta[order]
    depth = np.cumsum(delta)
    cover = np.zeros(seg_lo.shape[0], np.int64)
    dsum = np.zeros(seg_lo.shape[0], np.int64)
    for i, (lo, hi) in enumerate(zip(seg_lo, seg_hi)):
        bounds = np.unique(np.concatenate([[lo], pos[(pos > lo)
                                                     & (pos < hi)],
                                           [hi]]))
        for a, b in zip(bounds[:-1], bounds[1:]):
            j = np.searchsorted(pos, a, side="right") - 1
            d = depth[j] if j >= 0 else 0
            if d >= min_dep:
                cover[i] += b - a
                dsum[i] += (b - a) * d
    return cover, dsum


def test_engine_matches_oracle_across_sign_boundary():
    """Segments and events straddling 2^31 (and dense overlaps near
    it) under the uint32 tier; every feed path."""
    lengths = np.array([1_900_000_000, 1_500_000_000], np.int64)
    lay = GenomeLayout(lengths)
    eng = CoverageEngine(lay)
    assert eng.pos_dtype is np.uint32

    rng = np.random.RandomState(5)
    b31 = 1 << 31
    # global event intervals: below / straddling / above the sign
    # boundary, plus a deep pileup right on it
    gs = np.concatenate([
        rng.randint(0, 1_800_000_000, 300),
        rng.randint(b31 - 400, b31 + 400, 200),
        rng.randint(b31, 3_350_000_000, 300),
        np.full(64, b31 - 75),
    ]).astype(np.int64)
    ge = gs + rng.randint(1, 300, gs.shape[0])
    ge = np.minimum(ge, int(lay.total) - 1)

    half = gs.shape[0] // 2
    eng.add_start_end(gs[:half], ge[:half])
    pos = np.concatenate([gs[half:], ge[half:]])
    delta = np.concatenate([np.ones(gs.shape[0] - half, np.int32),
                            -np.ones(gs.shape[0] - half, np.int32)])
    eng.add_events(pos, delta)

    seg_lo = np.array([0, b31 - 1000, b31, b31 - 75,
                       1_900_000_000, 3_000_000_000], np.int64)
    seg_hi = np.array([1_000_000, b31 + 1000, b31 + 1, b31 - 74,
                       1_900_500_000, 3_399_999_000], np.int64)
    # segment_stats takes (tid, 1-based start, end); craft per-contig
    off = lay.offsets
    tid = (seg_lo >= off[1]).astype(np.int64)
    st = eng.segment_stats(tid, seg_lo - off[tid] + 1,
                           seg_hi - off[tid])
    want_cov, want_sum = _oracle_stats(gs, ge, seg_lo, seg_hi)
    np.testing.assert_array_equal(st.cover, want_cov)
    np.testing.assert_array_equal(st.depth_sum, want_sum)

    # dense depth around the boundary agrees with the oracle too
    d = eng.dense_depth(0, b31 - 200, b31 + 200)
    want = np.zeros(400, np.int64)
    for s, e in zip(gs, ge):
        a = max(int(s), b31 - 200)
        b = min(int(e), b31 + 200)
        if b > a:
            want[a - (b31 - 200): b - (b31 - 200)] += 1
    np.testing.assert_array_equal(d, want)


def test_sharded_engine_uint32_matches_single():
    from pandepth_jax.sharding.engine import ShardedCoverageEngine

    lengths = np.array([1_900_000_000, 1_500_000_000], np.int64)
    lay = GenomeLayout(lengths)
    rng = np.random.RandomState(9)
    gs = rng.randint(0, 3_350_000_000, 500).astype(np.int64)
    ge = gs + rng.randint(1, 500, 500)
    ge = np.minimum(ge, int(lay.total) - 1)

    single = CoverageEngine(lay)
    single.add_start_end(gs, ge)
    sharded = ShardedCoverageEngine(lay)
    assert sharded.pos_dtype is np.uint32
    sharded.add_start_end(gs, ge)

    tid = np.array([0, 0, 1, 1], np.int64)
    s1 = np.array([1, 1_800_000_000, 1, 1_200_000_000], np.int64)
    e1 = np.array([1_900_000_000, 1_900_000_000,
                   1_500_000_000, 1_500_000_000], np.int64)
    a = single.segment_stats(tid, s1, e1)
    b = sharded.segment_stats(tid, s1, e1)
    np.testing.assert_array_equal(a.cover, b.cover)
    np.testing.assert_array_equal(a.depth_sum, b.depth_sum)


@pytest.mark.parametrize("mode_args", [
    [],                          # chr mode
    ["-w", "100000000"],         # mode-5 windows
])
def test_cli_big_genome_vs_reference(tmp_path, oracle_bin, mode_args):
    """Full-CLI byte parity on a 2.3 Gb genome (uint32 tier) through
    the .csi-indexed path, ours vs the reference binary."""
    from pandepth_jax.io.bam_writer import write_uniform_bam

    tmp = str(tmp_path)
    names = ["cA", "cB"]
    lengths = [1_200_000_000, 1_100_000_000]
    rng = np.random.RandomState(17)
    n = 4000
    tid = np.sort(rng.randint(0, 2, n)).astype(np.int32)
    pos = np.zeros(n, np.int32)
    for t in (0, 1):
        m = int((tid == t).sum())
        pos[tid == t] = np.sort(
            (rng.rand(m) * (lengths[t] - 200)).astype(np.int64)
        ).astype(np.int32)
    flag = np.where(rng.rand(n) < 0.08, 1024, 0).astype(np.uint16)
    mapq = rng.randint(0, 61, n).astype(np.uint8)
    bam = os.path.join(tmp, "big.bam")
    write_uniform_bam(bam, names, lengths, tid, pos, flag, mapq)
    assert os.path.exists(bam + ".csi")

    ref_out = os.path.join(tmp, "ref")
    subprocess.run([oracle_bin, "-i", bam, "-o", ref_out] + mode_args,
                   check=True, capture_output=True)
    ours_out = os.path.join(tmp, "ours")
    from pandepth_jax.run import run
    from pandepth_jax.cli import parse_args

    cfg = parse_args(["pandepth", "-i", bam, "-o", ours_out]
                     + mode_args)
    assert cfg is not None
    assert run(cfg) == 0
    ref_tables = sorted(glob.glob(ref_out + "*.gz"))
    assert ref_tables
    for rt in ref_tables:
        suffix = os.path.basename(rt)[len("ref"):]
        ot = os.path.join(tmp, "ours" + suffix)
        assert os.path.exists(ot), suffix
        assert gunzip_bytes(ot) == gunzip_bytes(rt), suffix
