"""Native table/site writers must emit byte-identical decompressed
content to the Python paths."""

import gzip
import os

import numpy as np
import pytest

from pandepth_jax.stats.tables import write_tables
from pandepth_jax.targets.windows import synthesize_default_targets


def _gunzip(p):
    with gzip.open(p, "rb") as fh:
        return fh.read()


def test_win_big_native_matches_python(tmp_path, monkeypatch):
    native = pytest.importorskip("pandepth_jax.io.native")
    if native.load_library() is None:
        pytest.skip("native unavailable")

    lengths = np.array([9_000_123, 1_500_001])
    mode, t = synthesize_default_targets(["cA", "cB"], lengths, 150)
    assert t.n_genes > 50_000
    rng = np.random.RandomState(0)
    cover = rng.randint(0, 151, t.n_genes).astype(np.int64)
    dsum = (cover * rng.randint(1, 40, t.n_genes)).astype(np.int64)

    p_native = str(tmp_path / "n.win.stat.gz")
    write_tables(p_native, mode, False, ["cA", "cB"], t, cover, dsum)

    # force the Python formatter
    import pandepth_jax.io.native as nat

    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setattr(nat, "_build_error", "forced off")
    p_py = str(tmp_path / "p.win.stat.gz")
    write_tables(p_py, mode, False, ["cA", "cB"], t, cover, dsum)

    assert _gunzip(p_native) == _gunzip(p_py)


def test_win_big_native_gc_matches(tmp_path, monkeypatch):
    native = pytest.importorskip("pandepth_jax.io.native")
    if native.load_library() is None:
        pytest.skip("native unavailable")

    lengths = np.array([8_000_000])
    seq = bytes((np.random.RandomState(1).randint(0, 256, 8_000_000) %
                 4 + ord("A")).astype(np.uint8))
    mode, t = synthesize_default_targets(["c"], lengths, 200,
                                         ref_bases={0: seq})
    rng = np.random.RandomState(2)
    cover = rng.randint(0, 201, t.n_genes).astype(np.int64)
    dsum = cover * 3

    p_native = str(tmp_path / "n.win.stat.gz")
    write_tables(p_native, mode, True, ["c"], t, cover, dsum)

    import pandepth_jax.io.native as nat

    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setattr(nat, "_build_error", "forced off")
    p_py = str(tmp_path / "p.win.stat.gz")
    write_tables(p_py, mode, True, ["c"], t, cover, dsum)

    assert _gunzip(p_native) == _gunzip(p_py)


def test_id_rows_native_matches_python(tmp_path, monkeypatch):
    """Gene/bed ID tables >50k rows route through pancov_id_rows_write;
    bytes must match the Python row loop (incl. GC column and the
    (tid, start, id-bytes) row order with duplicate starts)."""
    native = pytest.importorskip("pandepth_jax.io.native")
    if native.load_library() is None:
        pytest.skip("native unavailable")

    from pandepth_jax.config import MODE_BED4
    from pandepth_jax.targets.model import TargetSet

    n = 60_000
    rng = np.random.RandomState(3)
    tid = np.sort(rng.randint(0, 3, n)).astype(np.int32)
    start = rng.randint(1, 5_000_000, n).astype(np.int64)
    start[1000:1010] = start[1000]  # duplicate starts: id byte order
    length = rng.randint(1, 900, n).astype(np.int64)
    end = start + length - 1
    ids = [f"r{i % 7}_{i}" for i in range(n)]
    gcc = rng.randint(0, 200, n).astype(np.int64)
    t = TargetSet(mode=MODE_BED4, gene_tid=tid, gene_id=ids,
                  gene_start=start, gene_end=end, gene_length=length,
                  gene_gc=gcc, seg_gene=np.arange(n, dtype=np.int32),
                  seg_start=start, seg_end=end)
    cover = rng.randint(0, 900, n).astype(np.int64)
    dsum = (cover * rng.randint(1, 30, n)).astype(np.int64)

    for gc in (False, True):
        p_native = str(tmp_path / f"n{gc}.bed.stat.gz")
        write_tables(p_native, MODE_BED4, gc, ["cA", "cB", "cC"], t,
                     cover, dsum)
        import pandepth_jax.io.native as nat

        monkeypatch.setattr(nat, "_lib", None)
        monkeypatch.setattr(nat, "_build_error", "forced off")
        p_py = str(tmp_path / f"p{gc}.bed.stat.gz")
        write_tables(p_py, MODE_BED4, gc, ["cA", "cB", "cC"], t,
                     cover, dsum)
        monkeypatch.undo()
        assert _gunzip(p_native) == _gunzip(p_py)


def test_member_jobs_error_cleans_parts(tmp_path):
    """A failing job mid-pipeline must raise AND leave no .m<N> part
    files behind (the drain removes parts as it copies; the cleanup
    covers in-flight ones)."""
    import glob

    from pandepth_jax.stats.tables import _run_member_jobs

    out = str(tmp_path / "t.gz")
    open(out, "wb").close()

    def good(p):
        with open(p, "wb") as fh:
            fh.write(b"x")
        return 0

    def bad(p):
        open(p, "wb").close()
        return 7

    with pytest.raises(OSError):
        _run_member_jobs(out, [good, good, bad, good, good],
                         workers=2)
    assert glob.glob(out + ".m*") == []
    # success path still appends in submission order
    def mk(i):
        def j(p):
            with open(p, "wb") as fh:
                fh.write(str(i).encode())
            return 0
        return j

    _run_member_jobs(out, [mk(i) for i in range(7)], workers=3)
    with open(out, "rb") as fh:
        assert fh.read().endswith(b"0123456")
    assert glob.glob(out + ".m*") == []


def test_fixed2_formatter_adversarial(tmp_path):
    """put_fixed2 (the integer fast path replacing snprintf %.2f in
    the row writers) must stay byte-identical to correctly-rounded
    %.2f on adversarial ratios: power-of-two window lengths make
    cov*100/L land EXACTLY on .005 ties (e.g. 1/32 -> 3.125 ->
    round-half-even '3.12'), the band the fast path must delegate to
    snprintf."""
    native = pytest.importorskip("pandepth_jax.io.native")
    lib = native.load_library()
    if lib is None:
        pytest.skip("native unavailable")
    rng = np.random.RandomState(7)
    rows = []
    for L in (8, 16, 32, 64, 128, 256, 512, 100, 200, 150, 1000, 3):
        for _ in range(200):
            cov = int(rng.randint(0, L + 1))
            dsum = int(rng.randint(0, 64 * L))
            rows.append((L, cov, dsum))
        # exact-tie constructions: cents frac = .5
        for k in range(1, min(L, 40), 2):
            rows.append((L, k, k))
    n = len(rows)
    Ls = np.array([r[0] for r in rows], np.int64)
    cov = np.array([r[1] for r in rows], np.int64)
    dsum = np.array([r[2] for r in rows], np.int64)
    start = np.arange(1, n + 1, dtype=np.int64)
    end = start + Ls - 1
    gcc = (cov // 2).astype(np.int64)
    p = str(tmp_path / "adv.gz")
    rc = lib.pancov_win_rows_write(p.encode(), 0, b"c", start, end,
                                   Ls, cov, dsum, gcc, n, 1)
    assert rc == 0
    got = _gunzip(p).decode().splitlines()
    for i, line in enumerate(got):
        L, c, d, g = int(Ls[i]), int(cov[i]), int(dsum[i]), int(gcc[i])
        want = (f"c\t{start[i]}\t{end[i]}\t{L}\t{c}\t{d}"
                f"\t{g * 100.0 / L:.2f}\t{c * 100.0 / L:.2f}"
                f"\t{d / L:.2f}")
        assert line == want, (i, line, want)


def test_site_depth_writer_members(tmp_path):
    """New-format checks for the libdeflate member sink: the
    incremental position counter must survive digit-count growth, a
    zero-row fresh file must still be a valid (empty) gzip, and
    multi-member output must read back as one stream."""
    native = pytest.importorskip("pandepth_jax.io.native")
    lib = native.load_library()
    if lib is None:
        pytest.skip("native unavailable")

    p = str(tmp_path / "s.SiteDepth.gz")
    # digit growth across 9->10 and 999999999->1000000000
    d = np.array([5, 0, 3], np.int32)
    assert lib.pancov_site_depth_write(p.encode(), b"c", 8, d, 3, 0) == 0
    assert lib.pancov_site_depth_write(
        p.encode(), b"c", 999_999_998, d, 3, 1) == 0
    got = _gunzip(p).decode()
    assert got == ("c\t8\t5\nc\t9\t0\nc\t10\t3\n"
                   "c\t999999998\t5\nc\t999999999\t0\n"
                   "c\t1000000000\t3\n")

    # zero rows, fresh file: one empty member, zcat-valid
    assert lib.pancov_site_depth_write(
        p.encode(), b"c", 0, d, 0, 0) == 0
    assert _gunzip(p) == b""

    # >4MB of text crosses the member boundary inside one call
    big = (np.arange(700_000) % 100).astype(np.int32)
    assert lib.pancov_site_depth_write(
        p.encode(), b"chr1", 0, big, len(big), 0) == 0
    lines = _gunzip(p).decode().splitlines()
    assert len(lines) == 700_000
    assert lines[0] == "chr1\t0\t0"
    assert lines[-1] == f"chr1\t699999\t{699_999 % 100}"
