"""CSI index writing/reading for contigs beyond BAI's 2^29 limit."""

import os

import numpy as np
import pytest

from pandepth_jax.io.bam_writer import write_uniform_bam
from pandepth_jax.io.bamindex import load_index_for


def _big_bam(tmp, n=30_000, clen=700_000_000, seed=5):
    rng = np.random.RandomState(seed)
    tid = np.zeros(n, np.int32)
    pos = np.sort((rng.rand(n) * (clen - 200)).astype(np.int32))
    flag = np.zeros(n, np.uint16)
    mapq = np.full(n, 60, np.uint8)
    bam = os.path.join(tmp, "big.bam")
    write_uniform_bam(bam, ["bigchr"], [clen], tid, pos, flag, mapq)
    return bam, pos


def test_csi_written_and_parsed(tmp_path):
    tmp = str(tmp_path)
    bam, pos = _big_bam(tmp)
    assert os.path.exists(bam + ".csi")
    assert not os.path.exists(bam + ".bai")
    idx = load_index_for(bam)
    assert idx is not None and idx.min_shift == 14 and idx.depth == 6
    # query a deep region: chunks must exist and the ranged load must
    # agree with the full walk
    native = pytest.importorskip("pandepth_jax.io.native")
    if native.load_library() is None:
        pytest.skip("native unavailable")
    from pandepth_jax.io.bamindex import chunks_for_windows

    lo, hi = 600_000_000, 600_500_000
    windows = (np.array([0, 1], np.int64), np.array([lo], np.int64),
               np.array([hi], np.int64), 1)
    vr = chunks_for_windows(idx, windows)
    n_expected = int(((pos + 150 > lo) & (pos < hi)).sum())
    full = native.NativeBamLoad(bam, 1796, -1, regions=windows)
    fs, fe = full.events()
    full.close()
    assert fs.shape[0] == n_expected
    ranged = native.NativeBamLoad(bam, 1796, -1, regions=windows,
                                  vranges=vr)
    rs, re_ = ranged.events()
    ranged.close()
    np.testing.assert_array_equal(np.sort(fs), np.sort(rs))
    np.testing.assert_array_equal(np.sort(fe), np.sort(re_))


def test_reference_accepts_csi(tmp_path, oracle_bin):
    # htslib must load our .csi and use the indexed path (observable:
    # the -a dump restricted to region-fetched reads)
    import glob
    import subprocess

    from tests.fixtures import gunzip_bytes

    from pandepth_jax.cli import main as cli_main

    tmp = str(tmp_path)
    bam, pos = _big_bam(tmp, n=5000)
    bed = os.path.join(tmp, "r.bed")
    with open(bed, "w") as fh:
        fh.write("bigchr\t600000000\t600500000\tr1\n")
    r = subprocess.run([oracle_bin, "-i", bam, "-b", bed, "-o",
                        os.path.join(tmp, "ref")], capture_output=True,
                       text=True)
    assert r.returncode == 0
    assert "No Index mode" not in (r.stdout + r.stderr)
    rc = cli_main(["pandepth", "-i", bam, "-b", bed, "-o",
                   os.path.join(tmp, "ours")])
    assert rc == 0
    for rf in sorted(glob.glob(os.path.join(tmp, "ref*.gz"))):
        of = os.path.join(tmp,
                          os.path.basename(rf).replace("ref", "ours", 1))
        assert gunzip_bytes(rf) == gunzip_bytes(of)
