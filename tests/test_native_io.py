"""libpancov_io (C++ decoder) vs the pure-Python BAM reader: identical
headers and columnar batches on every fixture."""

import numpy as np
import pytest

from pandepth_jax.io.bam import BamReader

from tests.fixtures import make_bam


@pytest.fixture(scope="module")
def native():
    native_mod = pytest.importorskip("pandepth_jax.io.native")
    if native_mod.load_library() is None:
        pytest.skip(f"native build failed: {native_mod.build_error()}")
    return native_mod


def test_native_matches_python(tmp_path, native):
    bam = str(tmp_path / "t.bam")
    make_bam(bam, n=700, seed=33)
    py = BamReader(bam)
    nt = native.NativeBamReader(bam)
    assert nt.header.names == py.header.names
    assert (nt.header.lengths == py.header.lengths).all()
    assert nt.header.text == py.header.text

    for bp, bn in zip(py.batches(max_reads=123),
                      nt.batches(max_reads=123)):
        for f in ("tid", "pos", "flag", "mapq", "n_ops", "op_code",
                  "op_len", "op_read"):
            np.testing.assert_array_equal(getattr(bp, f),
                                          getattr(bn, f), err_msg=f)
    nt.close()


def test_native_events_match_device_extraction(tmp_path, native):
    from pandepth_jax.device.engine import CoverageEngine
    from pandepth_jax.device.layout import GenomeLayout
    from tests.fixtures import CONTIGS

    bam = str(tmp_path / "t.bam")
    make_bam(bam, n=400, seed=44)
    lengths = np.array([c[1] for c in CONTIGS])
    for flags, q in ((1796, -1), (256, 30), (0, 1)):
        eng_py = CoverageEngine(GenomeLayout(lengths), flags_mask=flags,
                                min_mapq=q)
        for b in BamReader(bam).batches():
            eng_py.add_batch(b)
        eng_nt = CoverageEngine(GenomeLayout(lengths), flags_mask=flags,
                                min_mapq=q)
        nt = native.NativeBamReader(bam)
        for s, e in nt.event_batches(eng_nt.layout.offsets,
                                     eng_nt.layout.limits, flags, q):
            eng_nt.add_start_end(s, e)
        nt.close()
        seg_tid = np.array([0, 1, 2], np.int32)
        s1 = np.array([1, 1, 1])
        e1 = np.array([c[1] for c in CONTIGS])
        a = eng_py.segment_stats(seg_tid, s1, e1)
        b2 = eng_nt.segment_stats(seg_tid, s1, e1)
        np.testing.assert_array_equal(a.cover, b2.cover)
        np.testing.assert_array_equal(a.depth_sum, b2.depth_sum)


def test_native_load_pipeline_matches(tmp_path, native):
    """The one-shot pipelined load must produce the same events as the
    two-phase reader path."""
    from pandepth_jax.device.layout import GenomeLayout
    from tests.fixtures import CONTIGS

    bam = str(tmp_path / "t.bam")
    make_bam(bam, n=500, seed=55)
    lengths = np.array([c[1] for c in CONTIGS])
    lay = GenomeLayout(lengths)
    for flags, q in ((1796, -1), (260, 30)):
        ld = native.NativeBamLoad(bam, flags, q)
        assert ld.header.names == [c[0] for c in CONTIGS]
        s1, e1 = ld.events()
        ld.close()
        nt = native.NativeBamReader(bam)
        s2 = np.concatenate([s for s, _ in nt.event_batches(
            lay.offsets, lay.limits, flags, q)])
        e2 = np.concatenate([e for _, e in nt.event_batches(
            lay.offsets, lay.limits, flags, q)])
        nt.close()
        np.testing.assert_array_equal(np.sort(s1), np.sort(s2))
        np.testing.assert_array_equal(np.sort(e1), np.sort(e2))

    # external layout (multi-file quirk Q5): shrunken contig space
    lay2 = GenomeLayout(lengths[:2])
    ld = native.NativeBamLoad(bam, 1796, -1,
                              ext_offsets=lay2.offsets,
                              ext_limits=lay2.limits)
    s3, e3 = ld.events()
    ld.close()
    assert (s3 < lay2.total).all()


def test_native_empty_and_errors(tmp_path, native):
    bam = str(tmp_path / "e.bam")
    make_bam(bam, n=0)
    nt = native.NativeBamReader(bam)
    assert nt.n_records == 0
    assert list(nt.batches()) == []
    nt.close()

    with pytest.raises(ValueError):
        native.NativeBamReader(str(tmp_path / "missing.bam"))

    bad = str(tmp_path / "bad.bam")
    with open(bad, "wb") as fh:
        fh.write(b"this is not a bam file at all")
    with pytest.raises(ValueError):
        native.NativeBamReader(bad)
