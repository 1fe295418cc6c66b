"""Native GFF/GTF tokenizer + vectorized accumulator vs the pure
Python parser: identical TargetSets on tricky annotations."""

import gzip
import os

import numpy as np
import pytest

from pandepth_jax.config import (MODE_BED3, MODE_BED4, MODE_GFF,
                                 MODE_GTF)
from pandepth_jax.targets.parse import (_parse_bed3, _parse_bed4,
                                        _parse_gff, _parse_gtf,
                                        _try_native_targets,
                                        parse_targets)
from pandepth_jax.targets.model import GeneAccumulator

pytestmark = pytest.mark.skipif(
    os.environ.get("PANDEPTH_NO_NATIVE") == "1",
    reason="needs libpancov_io")

CHR2TID = {"chr1": 0, "chr2": 1, "weird.name": 2}

GFF_LINES = [
    "##gff-version 3",
    "# comment",
    "",
    "chr1\tsrc\tCDS\t100\t200\t.\t+\t0\tID=a;Parent=geneA",
    "chr1\tsrc\tCDS\t150\t400\t.\t+\t0\tID=b;Parent=geneA",
    "chr1\tsrc\texon\t1\t2\t.\t+\t0\tID=x;Parent=geneA",
    "chr2\tsrc\tCDS\t50\t80\t.\t-\t0\tID=geneB",          # no Parent
    "chr2\tsrc\tCDS\t10\t20\t.\t-\t0\tParent=p=q;ID=z",   # Parent first? no: first attr wins then Parent override
    "chr2 src CDS 30 40 . - 0 ID=sp;Parent=geneB",        # space-separated
    "chrNOPE\tsrc\tCDS\t1\t9\t.\t+\t0\tID=nope",          # unknown chrom
    "chr1\tsrc\tCDS\t500\t600\t.\t+\t0\t,;,",             # empty attrs
    "chr1\tsrc\tCDS\t700\t800\t.\t+\t0\tnoequals",        # id = token
    "weird.name\tsrc\tCDS\t5\t6\t.\t+\t0\tID=w1;Parent=w=2",
    "short\tline",
]

GTF_LINES = [
    "# gtf",
    'chr1\tsrc\tCDS\t100\t200\t.\t+\t0\tgene_id "g1"; transcript_id "t1";',
    'chr1\tsrc\tCDS\t300\t350\t.\t+\t0\tgene_id "g1"; transcript_id "t2";',
    'chr2\tsrc\tCDS\t10\t40\t.\t-\t0\tgene_id "g2"; transcript_id "t3";',
    'chrX\tsrc\tCDS\t1\t5\t.\t+\t0\tgene_id "gX"; transcript_id "t";',
    'chr1\tsrc\texon\t1\t2\t.\t+\t0\tgene_id "g1"; transcript_id "t";',
    "tooshort\tsrc\tCDS\t1\t2",
]


def _write(path, lines, gz=False):
    data = ("\n".join(lines) + "\n").encode()
    if gz:
        with gzip.open(path, "wb") as fh:
            fh.write(data)
    else:
        with open(path, "wb") as fh:
            fh.write(data)


def _assert_equal_sets(a, b):
    assert a.gene_id == b.gene_id
    for f in ("gene_tid", "gene_start", "gene_end", "gene_length",
              "gene_gc", "seg_gene", "seg_start", "seg_end"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("gz", [False, True])
def test_gff_native_matches_python(tmp_path, gz, capfd):
    path = str(tmp_path / ("t.gff" + (".gz" if gz else "")))
    _write(path, GFF_LINES, gz)
    acc_n = GeneAccumulator(MODE_GFF)
    assert _try_native_targets(path, "CDS", MODE_GFF, CHR2TID, acc_n)
    acc_p = GeneAccumulator(MODE_GFF)
    _parse_gff(path, "CDS", CHR2TID, acc_p)
    _assert_equal_sets(acc_n.build(), acc_p.build())
    err = capfd.readouterr().err
    assert err.count("Warning: This region may be incorrect.") == 2


def test_gtf_native_matches_python(tmp_path):
    path = str(tmp_path / "t.gtf")
    _write(path, GTF_LINES)
    acc_n = GeneAccumulator(MODE_GTF)
    assert _try_native_targets(path, "CDS", MODE_GTF, CHR2TID, acc_n)
    acc_p = GeneAccumulator(MODE_GTF)
    _parse_gtf(path, "CDS", CHR2TID, acc_p)
    _assert_equal_sets(acc_n.build(), acc_p.build())


def test_gff_gc_first_segment_quirk(tmp_path):
    """add_bulk must replicate the first-segment-only GC count."""
    path = str(tmp_path / "t.gff")
    _write(path, GFF_LINES)
    ref = {0: b"ACGT" * 300, 1: b"GGCC" * 100, 2: b"ATAT" * 10}
    acc_n = GeneAccumulator(MODE_GFF, ref)
    assert _try_native_targets(path, "CDS", MODE_GFF, CHR2TID, acc_n)
    acc_p = GeneAccumulator(MODE_GFF, ref)
    _parse_gff(path, "CDS", CHR2TID, acc_p)
    _assert_equal_sets(acc_n.build(), acc_p.build())


def test_parse_targets_dispatches_native(tmp_path, monkeypatch):
    path = str(tmp_path / "t.gff")
    _write(path, GFF_LINES)
    ts_native = parse_targets(path, MODE_GFF, CHR2TID)
    monkeypatch.setenv("PANDEPTH_NO_NATIVE", "1")
    ts_python = parse_targets(path, MODE_GFF, CHR2TID)
    _assert_equal_sets(ts_native, ts_python)


BED3_LINES = [
    "# header",
    "chr1\t100\t200",
    "chr1\t150\t400",
    "chr2\t50",              # short row: inherits end_s "400"
    "chr2",                  # inherits start_s "50" and end_s "400"
    "chr1\t500\t300",        # start > end: warn + drop
    "chrNOPE\t1\t9",         # unknown chrom: warn + drop
    "chr2\t7x\t9y",          # atoi prefixes: 7..9
    "weird.name\t5\t6",
    "   ",                   # whitespace-only row
]

BED4_LINES = [
    "chr1\t100\t200\tr1",
    "chr1\t300\t400",        # short: inherits id "r1" (merges)
    "chr2\t10\t20\tr2",
    "chr2\tzz\t20\tr3",      # non-int start -> 0
    "chr2\t30\tzz\tr4",      # non-int end -> 0: start > end, drop
    "chrNOPE\t1\t2\tr5",
    "weird.name\t1",         # start 1, end 0 -> drop (warn)
]


@pytest.mark.parametrize("mode,lines,pyfn", [
    (MODE_BED3, BED3_LINES, _parse_bed3),
    (MODE_BED4, BED4_LINES, _parse_bed4),
])
def test_bed_native_matches_python(tmp_path, mode, lines, pyfn, capfd):
    path = str(tmp_path / "t.bed")
    _write(path, lines)
    acc_n = GeneAccumulator(mode)
    assert _try_native_targets(path, "CDS", mode, CHR2TID, acc_n)
    n_warn = capfd.readouterr().err.count("Warning")
    acc_p = GeneAccumulator(mode)
    pyfn(path, CHR2TID, acc_p)
    assert capfd.readouterr().err.count("Warning") == n_warn
    _assert_equal_sets(acc_n.build(), acc_p.build())


def test_random_fuzz_bed(tmp_path):
    rng = np.random.RandomState(11)
    names = list(CHR2TID)
    for mode, pyfn in ((MODE_BED3, _parse_bed3),
                       (MODE_BED4, _parse_bed4)):
        lines = []
        for _ in range(300):
            c = names[rng.randint(0, 3)] if rng.rand() < 0.9 else "cZ"
            s = int(rng.randint(0, 1000))
            e = s + int(rng.randint(-50, 500))
            row = [c, str(s), str(e), f"id{rng.randint(0, 30)}"]
            ncols = rng.choice([1, 2, 3, 4, 4, 4])
            lines.append("\t".join(row[:ncols]))
        path = str(tmp_path / f"f{mode}.bed")
        _write(path, lines)
        acc_n = GeneAccumulator(mode)
        assert _try_native_targets(path, "CDS", mode, CHR2TID, acc_n)
        acc_p = GeneAccumulator(mode)
        pyfn(path, CHR2TID, acc_p)
        _assert_equal_sets(acc_n.build(), acc_p.build())


def test_random_fuzz_gff(tmp_path):
    rng = np.random.RandomState(9)
    names = list(CHR2TID)
    lines = []
    for _ in range(400):
        c = names[rng.randint(0, 3)] if rng.rand() < 0.9 else "chrZ"
        s = int(rng.randint(1, 10_000))
        e = s + int(rng.randint(0, 500))
        gid = f"g{rng.randint(0, 40)}"
        attr = rng.choice([
            f"ID={gid}.c;Parent={gid}",
            f"ID={gid}",
            f"Parent={gid}",
            f"{gid}",
            f"ID={gid};note=a=b;Parent={gid}x",
        ])
        feat = "CDS" if rng.rand() < 0.8 else "exon"
        sep = "\t" if rng.rand() < 0.9 else " "
        lines.append(sep.join(
            [c, "src", feat, str(s), str(e), ".", "+", "0", attr]))
    path = str(tmp_path / "f.gff")
    _write(path, lines)
    acc_n = GeneAccumulator(MODE_GFF)
    assert _try_native_targets(path, "CDS", MODE_GFF, CHR2TID, acc_n)
    acc_p = GeneAccumulator(MODE_GFF)
    _parse_gff(path, "CDS", CHR2TID, acc_p)
    _assert_equal_sets(acc_n.build(), acc_p.build())


def test_native_targets_from_fifo(tmp_path):
    """Unseekable inputs (process substitution: `-b <(...)`) must
    stream instead of ftell+resize — a FIFO's ftell is -1 and the old
    path died on vector::resize((size_t)-1)."""
    import threading

    path = str(tmp_path / "t.gff")
    _write(path, GFF_LINES)
    fifo = str(tmp_path / "t.fifo.gff")
    os.mkfifo(fifo)

    def feed():
        with open(path, "rb") as src, open(fifo, "wb") as dst:
            dst.write(src.read())

    t = threading.Thread(target=feed)
    t.start()
    try:
        acc_n = GeneAccumulator(MODE_GFF)
        assert _try_native_targets(fifo, "CDS", MODE_GFF, CHR2TID,
                                   acc_n)
    finally:
        t.join()
    acc_p = GeneAccumulator(MODE_GFF)
    _parse_gff(path, "CDS", CHR2TID, acc_p)
    _assert_equal_sets(acc_n.build(), acc_p.build())
