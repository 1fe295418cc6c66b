"""CRAM subsystem tests: rANS codec roundtrips, writer->reader
roundtrip, and interop parity with the reference binary's htslib."""

import os
import subprocess

import numpy as np
import pytest

from pandepth_jax.io.bam_writer import cigar_str_to_ops
from pandepth_jax.io.cram import CramReader
from pandepth_jax.io.cram_writer import write_cram
from pandepth_jax.io.rans4x8 import rans_decode, rans_encode

from tests.fixtures import CONTIGS, gunzip_bytes, make_fasta, make_gff, \
    random_reads

from pandepth_jax.cli import main as cli_main


@pytest.mark.parametrize("order", [0, 1])
def test_rans_roundtrip(order):
    rng = np.random.RandomState(1)
    cases = [
        b"hello world " * 50,
        bytes(rng.randint(0, 256, 4096, dtype=np.uint8)),
        bytes(rng.choice([65, 67, 71, 84], 9999).astype(np.uint8)),
        b"Q" * 1234,
        b"ABCD",
    ]
    for c in cases:
        assert rans_decode(rans_encode(c, order=order), len(c)) == c


def _cram_recs(n=400, seed=66):
    recs = random_reads(n=n, seed=seed)
    # CRAM features canonicalize =/X to M (identical depth semantics)
    return [(t, p, f, q, c.replace("=", "M").replace("X", "M"))
            for t, p, f, q, c in recs]


def test_cram_roundtrip_cigars(tmp_path):
    recs = [
        (0, 10, 0, 60, "50M"),
        (0, 30, 16, 30, "10S30M5I20M3D10M"),
        (1, 5, 0, 0, "20M100N30M"),
        (1, 50, 1024, 60, "5H40M5S"),
        (0, 99, 4, 0, "*"),
        (2, 0, 0, 10, "30M2D1I2P30M"),
    ]
    path = str(tmp_path / "t.cram")
    write_cram(path, ["c1", "c2", "c3"], [1000, 2000, 500], recs)
    r = CramReader(path)
    assert r.header.names == ["c1", "c2", "c3"]
    b = next(r.batches())
    ofs = 0
    for i, (t, p, f, q, c) in enumerate(recs):
        assert b.tid[i] == t and b.pos[i] == p
        assert b.flag[i] == f and b.mapq[i] == q
        got = [(int(b.op_code[j]), int(b.op_len[j]))
               for j in range(ofs, ofs + b.n_ops[i])]
        exp = cigar_str_to_ops(c) if c != "*" else []
        assert got == exp, (i, got, exp)
        ofs += b.n_ops[i]


def test_cram_multi_container_batches(tmp_path):
    recs = _cram_recs(n=500)
    path = str(tmp_path / "m.cram")
    write_cram(path, [c[0] for c in CONTIGS], [c[1] for c in CONTIGS],
               recs, records_per_container=123)
    r = CramReader(path)
    total = sum(b.n_reads for b in r.batches(max_reads=77))
    assert total == len(recs)


def _write_fixture_cram(tmp, n=400, seed=66):
    recs = _cram_recs(n=n, seed=seed)
    path = os.path.join(tmp, "t.cram")
    write_cram(path, [c[0] for c in CONTIGS], [c[1] for c in CONTIGS],
               recs)
    return path


def _both(tmp, oracle, cram, extra):
    import glob

    subprocess.run([oracle, "-i", cram, "-o", os.path.join(tmp, "ref")]
                   + extra, check=True, capture_output=True)
    rc = cli_main(["pandepth", "-i", cram, "-o",
                   os.path.join(tmp, "ours")] + extra)
    assert rc == 0
    ref_files = sorted(glob.glob(os.path.join(tmp, "ref*.gz")))
    assert ref_files
    for rf in ref_files:
        of = rf.replace("ref", "ours", 1)
        assert gunzip_bytes(of) == gunzip_bytes(rf), os.path.basename(rf)


def test_vectorized_events_match_record_loop(tmp_path):
    """decode_slice_events must produce the same depth as CIGAR-walking
    the record-loop batches."""
    import numpy as np

    from pandepth_jax.device.engine import CoverageEngine
    from pandepth_jax.device.layout import GenomeLayout

    recs = _cram_recs(n=600, seed=77)
    path = str(tmp_path / "v.cram")
    write_cram(path, [c[0] for c in CONTIGS], [c[1] for c in CONTIGS],
               recs, records_per_container=97)
    lengths = np.array([c[1] for c in CONTIGS])

    r1 = CramReader(path)
    eng_a = CoverageEngine(GenomeLayout(lengths))
    n_runs = 0
    for tid, flag, mapq, s0, e0, _n, _rlo, _rhi in \
            r1.interval_batches():
        keep = (flag & 1796) == 0
        eng_a.add_intervals(tid[keep], s0[keep], e0[keep])
        n_runs += int(keep.sum())
    assert n_runs > 0

    r2 = CramReader(path)
    eng_b = CoverageEngine(GenomeLayout(lengths))
    for b in r2.batches():
        eng_b.add_batch(b)

    seg_tid = np.arange(len(CONTIGS), dtype=np.int32)
    s1 = np.ones(len(CONTIGS), np.int64)
    e1 = lengths
    a = eng_a.segment_stats(seg_tid, s1, e1)
    b2 = eng_b.segment_stats(seg_tid, s1, e1)
    np.testing.assert_array_equal(a.cover, b2.cover)
    np.testing.assert_array_equal(a.depth_sum, b2.depth_sum)


def test_cram_parity_chr(tmp_path, oracle_bin):
    tmp = str(tmp_path)
    _both(tmp, oracle_bin, _write_fixture_cram(tmp), [])


def test_cram_parity_gene_gc(tmp_path, oracle_bin):
    tmp = str(tmp_path)
    cram = _write_fixture_cram(tmp)
    fa = os.path.join(tmp, "ref.fa")
    gff = os.path.join(tmp, "t.gff")
    make_fasta(fa)
    make_gff(gff, overhang=False)
    _both(tmp, oracle_bin, cram, ["-g", gff, "-c", "-r", fa])


def test_cram_parity_filters_and_windows(tmp_path, oracle_bin):
    tmp = str(tmp_path)
    cram = _write_fixture_cram(tmp, seed=67)
    _both(tmp, oracle_bin, cram, ["-w", "250", "-q", "30", "-x", "260"])


def test_crai_block_skipping(tmp_path, oracle_bin):
    """Sparse-BED indexed CRAM run: only target-overlapping containers
    are inflated, output byte-identical to the reference binary (whose
    htslib loads OUR .crai via sam_index_load) and to our own full
    decode."""
    import glob

    # many containers over a long contig; targets hit only the start
    names, lengths = ["big"], [400_000]
    rng = np.random.RandomState(5)
    recs = sorted(
        ((0, int(p), 0, 60, "100M") for p in
         rng.randint(0, 399_800, 4000)), key=lambda r: r[1])
    cram = str(tmp_path / "s.cram")
    write_cram(cram, names, lengths, recs, records_per_container=200,
               index=True)
    assert os.path.exists(cram + ".crai")
    bed = str(tmp_path / "t.bed")
    with open(bed, "w") as fh:
        fh.write("big\t1000\t9000\nbig\t15000\t17000\n")

    subprocess.run([oracle_bin, "-i", cram, "-b", bed, "-o",
                    str(tmp_path / "ref")], check=True,
                   capture_output=True)
    rc = cli_main(["pandepth", "-i", cram, "-b", bed, "-o",
                   str(tmp_path / "ours")])
    assert rc == 0
    for rf in sorted(glob.glob(str(tmp_path / "ref*.gz"))):
        of = rf.replace("ref", "ours", 1)
        assert gunzip_bytes(of) == gunzip_bytes(rf), \
            os.path.basename(rf)

    # sparseness: the run must decode only a fraction of containers
    from pandepth_jax.io.cram import (CramReader, crai_select_offsets,
                                      load_crai)
    from pandepth_jax.targets.model import TargetSet
    from pandepth_jax.targets.parse import parse_targets

    targets = parse_targets(bed, 3, {"big": 0})
    regs = (*targets.fetch_windows(np.asarray(lengths, np.int64)), 1)
    crai = load_crai(cram + ".crai")
    assert crai is not None
    offs = crai_select_offsets(crai, regs)
    full = CramReader(cram)
    for _ in full.interval_batches():
        pass
    sparse = CramReader(cram)
    for _ in sparse.interval_batches(offsets=offs):
        pass
    assert sparse.bytes_decoded < full.bytes_decoded / 4


def test_crai_offsets_equals_full_decode(tmp_path):
    """Offset-restricted decode + read-span window filter == full
    decode + same filter, for every window pattern."""
    from pandepth_jax.io.cram import (CramReader, crai_select_offsets,
                                      load_crai)

    recs = _cram_recs(n=800, seed=9)
    recs.sort(key=lambda r: (r[0], r[1]))
    cram = str(tmp_path / "w.cram")
    write_cram(cram, [c[0] for c in CONTIGS],
               [c[1] for c in CONTIGS], recs,
               records_per_container=67, index=True)
    crai = load_crai(cram + ".crai")
    assert crai is not None

    off = np.array([0, 2, 3, 3], np.int64)
    ws = np.array([100, 2800, 500], np.int64)
    we = np.array([900, 4800, 1500], np.int64)
    regs = (off, ws, we, 1)
    offs = crai_select_offsets(crai, regs)

    def run_events(offsets):
        r = CramReader(cram)
        out = []
        for (tid, flag, mapq, s0, e0, _n, rlo,
             rhi) in r.interval_batches(offsets=offsets):
            keep = (flag & 1796) == 0
            from pandepth_jax.run import _intervals_in_windows

            keep &= _intervals_in_windows(tid, rlo, rhi, regs)
            out.append((tid[keep], s0[keep], e0[keep]))
        return [np.concatenate([o[i] for o in out]) for i in range(3)]

    a = run_events(None)
    b = run_events(offs)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)


_B2C_SRC = r"""
#include <stdio.h>
#include "hts.h"
#include "sam.h"
#include "cram.h"
int main(int argc, char** argv) {
  samFile* in = sam_open(argv[1], "r");
  if (!in) return 1;
  sam_hdr_t* hdr = sam_hdr_read(in);
  samFile* out = sam_open(argv[2], "wc");
  if (!out) return 1;
  hts_set_opt(out, CRAM_OPT_NO_REF, 1);
  if (sam_hdr_write(out, hdr) < 0) return 1;
  bam1_t* b = bam_init1();
  while (sam_read1(in, hdr, b) >= 0)
    if (sam_write1(out, hdr, b) < 0) return 1;
  sam_close(out);
  sam_close(in);
  return 0;
}
"""


def _bam2cram_bin():
    """BAM->CRAM converter linked against the reference's bundled
    htslib — produces REAL htslib CRAM (huffman/rANS/core encodings)
    to drive our reader the direction the oracle can't."""
    import subprocess as sp

    path = "/tmp/refbin/bam2cram"
    if os.path.exists(path):
        return path
    os.makedirs("/tmp/refbin", exist_ok=True)
    src = "/tmp/refbin/bam2cram.c"
    with open(src, "w") as fh:
        fh.write(_B2C_SRC)
    r = sp.run(["g++", "-O2", "-o", path, src,
                "-I/root/reference/include", "-L/root/reference/lib",
                "-lhts", "-ldeflate", "-lz", "-lpthread"],
               capture_output=True, text=True)
    if r.returncode != 0:
        pytest.skip(f"bam2cram build failed: {r.stderr[-500:]}")
    return path


def test_htslib_written_cram_decodes(tmp_path):
    """Reader compatibility with real-world htslib CRAM output
    (reference-free mode): every record's placement + CIGAR must match
    the BAM it came from."""
    from tests.fixtures import make_bam

    from pandepth_jax.device.engine import CoverageEngine
    from pandepth_jax.device.layout import GenomeLayout
    from pandepth_jax.io.bam import BamReader

    bam = str(tmp_path / "h.bam")
    make_bam(bam, n=900, seed=43)
    cram = str(tmp_path / "h.cram")
    subprocess.run([_bam2cram_bin(), bam, cram], check=True,
                   capture_output=True)

    rb = BamReader(bam)
    rc = CramReader(cram)
    assert rc.header.names == rb.header.names
    lengths = rb.header.lengths
    eng_b = CoverageEngine(GenomeLayout(lengths))
    for b in rb.batches():
        eng_b.add_batch(b)
    eng_c = CoverageEngine(GenomeLayout(lengths))
    n_c = 0
    for b in rc.batches():
        eng_c.add_batch(b)
        n_c += b.n_reads
    assert n_c == 900
    seg_tid = np.arange(len(lengths), dtype=np.int32)
    s1 = np.ones(len(lengths), np.int64)
    sa = eng_b.segment_stats(seg_tid, s1, lengths)
    sb = eng_c.segment_stats(seg_tid, s1, lengths)
    np.testing.assert_array_equal(sa.cover, sb.cover)
    np.testing.assert_array_equal(sa.depth_sum, sb.depth_sum)


def test_htslib_written_cram_cli_parity(tmp_path, oracle_bin):
    """Full-CLI parity on an htslib-written CRAM: ours vs the
    reference binary reading the same file."""
    from tests.fixtures import make_bam

    bam = str(tmp_path / "h.bam")
    make_bam(bam, n=700, seed=44)
    cram = str(tmp_path / "h.cram")
    subprocess.run([_bam2cram_bin(), bam, cram], check=True,
                   capture_output=True)
    _both(str(tmp_path), oracle_bin, cram, [])
    _both(str(tmp_path), oracle_bin, cram, ["-w", "300"])
