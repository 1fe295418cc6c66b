"""Long-CIGAR records (>2^16-1 ops, the CG:B,I convention).

BAM caps n_cigar at 65,535; writers store an `l_qseq S, ref_span N`
placeholder in the CIGAR field and the real ops in a CG:B,I aux tag.
htslib 1.11 — the decode layer under the reference's sam_read1
(src/PanDepth.cpp:4604) — rewrites the record on read (sam.c
bam_tag2cigar), so the reference counts the REAL CIGAR. Both our
decoders must do the same or long-read depth silently diverges.
"""

import os
import subprocess

import numpy as np
import pytest

from tests.fixtures import gunzip_bytes

from pandepth_jax.cli import main as cli_main
from pandepth_jax.io.bam import BamReader
from pandepth_jax.io.bam_writer import write_bam

CONTIGS = [("chr1", 200_000), ("chr2", 100_000)]


def _long_cigar(n_pairs: int) -> str:
    # alternating 1M1D: n_pairs*2 ops, spans 2*n_pairs ref bases,
    # covers every other base — a shape only the real CIGAR produces
    # (the kSsN placeholder would add no depth at all)
    return "1M1D" * n_pairs


def _mixed_bam(path: str) -> None:
    # every read fits inside its contig: overhanging reads are
    # documented reference UB (heap overflow past the +500 slack)
    recs = [
        (0, 100, 0, 60, "150M"),
        (0, 5_000, 0, 60, _long_cigar(40_000)),    # 80,000 ops
        (0, 90_000, 0, 60, "40M10D40M"),
        (1, 1_000, 0, 60, _long_cigar(33_000)),    # 66,000 ops
        (1, 40_000, 0, 60, "200M"),
        # first op S == l_qseq but NO CG tag: htslib keeps the
        # placeholder (adds no depth); so must we
        (1, 45_000, 0, 60, "120S"),
    ]
    names = [c[0] for c in CONTIGS]
    lengths = [c[1] for c in CONTIGS]
    write_bam(path, names, lengths, recs, make_index=True)


def _compare(tmp, oracle, extra, bam):
    ref_out = os.path.join(tmp, "ref")
    our_out = os.path.join(tmp, "ours")
    subprocess.run([oracle, "-i", bam, "-o", ref_out] + extra,
                   check=True, capture_output=True)
    rc = cli_main(["pandepth", "-i", bam, "-o", our_out] + extra)
    assert rc == 0
    import glob
    ref_files = sorted(glob.glob(os.path.join(tmp, "ref*.gz")))
    assert ref_files
    for rf in ref_files:
        of = rf.replace("ref", "ours", 1)
        assert gunzip_bytes(of) == gunzip_bytes(rf), os.path.basename(rf)


@pytest.mark.parametrize("extra", [[], ["-a"], ["-s", "-a"],
                                   ["-w", "5000"]])
def test_long_cigar_parity(tmp_path, oracle_bin, extra):
    tmp = str(tmp_path)
    bam = os.path.join(tmp, "t.bam")
    _mixed_bam(bam)
    _compare(tmp, oracle_bin, extra, bam)


def test_python_decoder_resolves_cg(tmp_path):
    bam = str(tmp_path / "t.bam")
    _mixed_bam(bam)
    batches = list(BamReader(bam).batches())
    n_ops = np.concatenate([b.n_ops for b in batches])
    assert list(n_ops) == [1, 80_000, 3, 66_000, 1, 1]
    # the placeholder-without-CG record keeps its stored CIGAR
    last = batches[-1]
    assert last.op_code[-1] == 4 and last.op_len[-1] == 120


def test_native_decoder_matches_python(tmp_path):
    native = pytest.importorskip("pandepth_jax.io.native")
    if native.load_library() is None:
        pytest.skip(f"native build failed: {native.build_error()}")
    bam = str(tmp_path / "t.bam")
    _mixed_bam(bam)
    py = BamReader(bam)
    nt = native.NativeBamReader(bam)
    for bp, bn in zip(py.batches(), nt.batches()):
        for f in ("tid", "pos", "flag", "mapq", "n_ops", "op_code",
                  "op_len", "op_read"):
            np.testing.assert_array_equal(getattr(bp, f),
                                          getattr(bn, f), err_msg=f)
    nt.close()
