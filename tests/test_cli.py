"""CLI surface tests (flag parsing semantics of bamCov_help01)."""

import os

from pandepth_jax.cli import parse_args
from pandepth_jax.config import MODE_BED3, MODE_BED4, MODE_GFF
from pandepth_jax.stats.tables import output_prefix


def test_basic_flags(tmp_path):
    cfg = parse_args(["p", "-i", "x.bam", "-o", "out", "-q", "30",
                      "-d", "2", "-x", "260", "-t", "8"])
    assert cfg.inputs == ["x.bam"]
    assert cfg.min_mapq == 30
    assert cfg.min_depth == 2
    assert cfg.flags == 260
    assert cfg.threads == 8


def test_double_dash_equivalent():
    cfg = parse_args(["p", "--i", "x.bam", "--o", "out"])
    assert cfg.inputs == ["x.bam"]


def test_list_expansion(tmp_path):
    lst = os.path.join(str(tmp_path), "in.list")
    with open(lst, "w") as fh:
        fh.write("a.bam\nb.bam\n\n")
    cfg = parse_args(["p", "-i", lst, "-o", "out"])
    assert cfg.inputs == ["a.bam", "b.bam"]


def test_bed_detection(tmp_path):
    bed = os.path.join(str(tmp_path), "r.bed")
    with open(bed, "w") as fh:
        fh.write("chr1\t1\t10\tid1\n")
    cfg = parse_args(["p", "-i", "x.bam", "-o", "out", "-b", bed])
    assert cfg.mode == MODE_BED4
    with open(bed, "w") as fh:
        fh.write("chr1\t1\t10\n")
    cfg = parse_args(["p", "-i", "x.bam", "-o", "out", "-b", bed])
    assert cfg.mode == MODE_BED3


def test_gff_detection(tmp_path):
    gff = os.path.join(str(tmp_path), "g.gff")
    with open(gff, "w") as fh:
        fh.write("chr1\ts\tCDS\t1\t9\t.\t+\t0\tID=c;Parent=m\n")
    cfg = parse_args(["p", "-i", "x.bam", "-o", "out", "-g", gff])
    assert cfg.mode == MODE_GFF
    assert cfg.target_file == gff


def test_window_clamp_and_min_depth_clamp(capsys):
    cfg = parse_args(["p", "-i", "x", "-o", "o", "-w", "0", "-d", "-3"])
    assert cfg.win_size == 1
    assert cfg.min_depth == 1


def test_missing_args():
    assert parse_args(["p", "-i", "x.bam"]) is None
    assert parse_args(["p"]) is None
    assert parse_args(["p", "-i"]) is None
    assert parse_args(["p", "bad"]) is None


def test_hidden_s_flag():
    cfg = parse_args(["p", "-i", "x", "-o", "o", "-s"])
    assert cfg.use_index is False


def test_output_prefix_naming():
    # reference strips .gz then a .stat/.bed extension
    assert output_prefix("out") == "out"
    assert output_prefix("out.gz") == "out"
    assert output_prefix("out.stat") == "out"
    assert output_prefix("out.stat.gz") == "out"
    assert output_prefix("out.bed.gz") == "out"
    assert output_prefix("out.txt") == "out.txt"
