"""Golden-file parity against the reference pandepth binary
(SURVEY.md §4.1): run both tools on the same synthetic inputs and
byte-compare every decompressed output table."""

import glob
import os
import subprocess
import sys

import pytest

from tests.fixtures import (CONTIGS, gunzip_bytes, make_bam, make_bed,
                            make_fasta, make_gff, make_gtf)

from pandepth_jax.cli import main as cli_main


def run_ours(workdir, args):
    rc = cli_main(["pandepth"] + list(args))
    assert rc == 0


def compare_outputs(tmp, ref_prefix, our_prefix):
    ref_files = sorted(glob.glob(os.path.join(tmp, ref_prefix + "*.gz")))
    assert ref_files, "oracle produced no output"
    for rf in ref_files:
        of = rf.replace(ref_prefix, our_prefix, 1)
        assert os.path.exists(of), f"missing output {of}"
        assert gunzip_bytes(of) == gunzip_bytes(rf), \
            f"table mismatch: {os.path.basename(rf)}"


def _setup(tmp, n=800, seed=11):
    bam = os.path.join(tmp, "t.bam")
    make_bam(bam, n=n, seed=seed)
    return bam


def _both(tmp, oracle, extra, n=800, seed=11, bam=None):
    bam = bam or _setup(tmp, n, seed)
    ref_out = os.path.join(tmp, "ref")
    our_out = os.path.join(tmp, "ours")
    subprocess.run([oracle, "-i", bam, "-o", ref_out] + extra,
                   check=True, capture_output=True)
    run_ours(tmp, ["-i", bam, "-o", our_out] + extra)
    compare_outputs(tmp, "ref", "ours")


def test_chr_mode(tmp_path, oracle_bin):
    _both(str(tmp_path), oracle_bin, [])


def test_chr_mode_no_index(tmp_path, oracle_bin):
    tmp = str(tmp_path)
    bam = os.path.join(tmp, "t.bam")
    make_bam(bam, n=500, seed=2, make_index=False)
    _both(tmp, oracle_bin, [], bam=bam)


def test_window_mode_big(tmp_path, oracle_bin):
    _both(str(tmp_path), oracle_bin, ["-w", "500"])


def test_window_mode_small(tmp_path, oracle_bin):
    _both(str(tmp_path), oracle_bin, ["-w", "100"])


def test_window_mode_tiny(tmp_path, oracle_bin):
    _both(str(tmp_path), oracle_bin, ["-w", "7"])


def test_window_mode_small_multichunk_writer(tmp_path, oracle_bin,
                                             monkeypatch):
    """Force write_win6_streaming's multi-gzip-member chunking (many
    chunks per contig) — the suite's fixtures are far below the
    production 1M-row chunk size, so the chunk-boundary and
    part-ordering logic would otherwise ship untested."""
    monkeypatch.setenv("PANDEPTH_WIN6_CHUNK_ROWS", "7")
    _both(str(tmp_path), oracle_bin, ["-w", "25"])


def test_gff_mode(tmp_path, oracle_bin):
    tmp = str(tmp_path)
    gff = os.path.join(tmp, "t.gff")
    make_gff(gff)
    _both(tmp, oracle_bin, ["-g", gff])


def test_gff_gz_exon_feature(tmp_path, oracle_bin):
    tmp = str(tmp_path)
    gff = os.path.join(tmp, "t.gff.gz")
    make_gff(gff, feature="exon", gz=True)
    _both(tmp, oracle_bin, ["-g", gff, "-f", "exon"])


def test_gtf_mode(tmp_path, oracle_bin):
    tmp = str(tmp_path)
    gtf = os.path.join(tmp, "t.gtf")
    make_gtf(gtf)
    _both(tmp, oracle_bin, ["-g", gtf])


def test_bed3_mode(tmp_path, oracle_bin):
    tmp = str(tmp_path)
    bed = os.path.join(tmp, "t.bed")
    make_bed(bed)
    _both(tmp, oracle_bin, ["-b", bed])


def test_bed4_mode(tmp_path, oracle_bin):
    tmp = str(tmp_path)
    bed = os.path.join(tmp, "t4.bed")
    make_bed(bed, four_col=True)
    _both(tmp, oracle_bin, ["-b", bed])


def test_mapq_and_flag_filters(tmp_path, oracle_bin):
    _both(str(tmp_path), oracle_bin, ["-q", "30", "-x", "260"])


def test_min_depth(tmp_path, oracle_bin):
    _both(str(tmp_path), oracle_bin, ["-d", "3"])


def test_site_output(tmp_path, oracle_bin):
    _both(str(tmp_path), oracle_bin, ["-a"], n=300, seed=4)


def test_site_output_bed_indexed(tmp_path, oracle_bin):
    # with an index, the reference fetches only reads overlapping the
    # merged BED regions (+-1), which shows in the -a site dump
    tmp = str(tmp_path)
    bed = os.path.join(tmp, "t.bed")
    make_bed(bed)
    _both(tmp, oracle_bin, ["-b", bed, "-a"], n=400, seed=8)


def test_site_output_gff_indexed(tmp_path, oracle_bin):
    tmp = str(tmp_path)
    gff = os.path.join(tmp, "t.gff")
    make_gff(gff)
    _both(tmp, oracle_bin, ["-g", gff, "-a"], n=400, seed=9)


def test_site_output_bed_no_index(tmp_path, oracle_bin):
    # -s disables the index: the streaming path sees every read
    tmp = str(tmp_path)
    bed = os.path.join(tmp, "t.bed")
    make_bed(bed)
    _both(tmp, oracle_bin, ["-b", bed, "-a", "-s"], n=400, seed=8)


def test_site_output_bed_unsorted_no_index(tmp_path, oracle_bin):
    # unsorted + no index: the reference streams every read unfiltered
    from tests.fixtures import CONTIGS, random_reads
    from pandepth_jax.io.bam_writer import write_bam

    tmp = str(tmp_path)
    bam = os.path.join(tmp, "u.bam")
    recs = random_reads(n=300, seed=12)
    names = [c[0] for c in CONTIGS]
    lengths = [c[1] for c in CONTIGS]
    hdr = "@HD\tVN:1.6\tSO:unsorted\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in zip(names, lengths))
    write_bam(bam, names, lengths, recs, header_text=hdr,
              make_index=False)
    bed = os.path.join(tmp, "t.bed")
    make_bed(bed)
    _both(tmp, oracle_bin, ["-b", bed, "-a"], bam=bam)


def test_gc_mode_chr(tmp_path, oracle_bin):
    tmp = str(tmp_path)
    fa = os.path.join(tmp, "ref.fa")
    make_fasta(fa)
    _both(tmp, oracle_bin, ["-c", "-r", fa])


def test_gc_mode_gene(tmp_path, oracle_bin):
    tmp = str(tmp_path)
    fa = os.path.join(tmp, "ref.fa")
    gff = os.path.join(tmp, "t.gff")
    make_fasta(fa)
    # overhanging segments make the reference read GC out of bounds (UB)
    make_gff(gff, overhang=False)
    _both(tmp, oracle_bin, ["-g", gff, "-c", "-r", fa])


def test_gc_mode_windows(tmp_path, oracle_bin):
    tmp = str(tmp_path)
    fa = os.path.join(tmp, "ref.fa")
    make_fasta(fa)
    _both(tmp, oracle_bin, ["-w", "200", "-c", "-r", fa])


def test_gc_mode_small_windows_documented_divergence(tmp_path, oracle_bin):
    # The reference's mode-6 GC column reads freed memory (quirk Q4 —
    # nondeterministic garbage), so we compute *real* GC and compare
    # every other column byte-for-byte.
    tmp = str(tmp_path)
    fa = os.path.join(tmp, "ref.fa")
    make_fasta(fa)
    bam = _setup(tmp)
    ref_out = os.path.join(tmp, "ref")
    our_out = os.path.join(tmp, "ours")
    args = ["-w", "50", "-c", "-r", fa]
    subprocess.run([oracle_bin, "-i", bam, "-o", ref_out] + args,
                   check=True, capture_output=True)
    run_ours(tmp, ["-i", bam, "-o", our_out] + args)
    from tests.fixtures import drop_gc_column

    ref = drop_gc_column(gunzip_bytes(os.path.join(tmp,
                                                   "ref.win.stat.gz")))
    ours = drop_gc_column(gunzip_bytes(os.path.join(tmp,
                                                    "ours.win.stat.gz")))
    assert ref == ours


def test_multi_file_mixed_formats(tmp_path, oracle_bin):
    # one .list mixing BAM + SAM + CRAM (htslib sniffs per file)
    from tests.fixtures import CONTIGS, random_reads
    from pandepth_jax.io.bam_writer import cigar_str_to_ops
    from pandepth_jax.io.cram_writer import write_cram

    tmp = str(tmp_path)
    bam = os.path.join(tmp, "a.bam")
    make_bam(bam, n=200, seed=41, end_slack=90)
    sam = os.path.join(tmp, "b.sam")
    recs_s = random_reads(n=200, seed=42, end_slack=90)
    lines = ["@HD\tVN:1.6\tSO:coordinate"] + [
        f"@SQ\tSN:{n}\tLN:{l}" for n, l in CONTIGS]
    for i, (t, p, f, q, c) in enumerate(recs_s):
        sl = sum(l for op, l in cigar_str_to_ops(c)
                 if op in (0, 1, 4, 7, 8)) if c != "*" else 0
        seq = "A" * sl if sl else "*"
        lines.append(f"r{i}\t{f}\t{CONTIGS[t][0]}\t{p + 1}\t{q}\t{c}"
                     f"\t*\t0\t0\t{seq}\t*")
    with open(sam, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    cram = os.path.join(tmp, "c.cram")
    recs_c = [(t, p, f, q, c.replace("=", "M").replace("X", "M"))
              for t, p, f, q, c in random_reads(n=200, seed=43,
                                                end_slack=90)]
    write_cram(cram, [x[0] for x in CONTIGS], [x[1] for x in CONTIGS],
               recs_c)
    lst = os.path.join(tmp, "mix.list")
    with open(lst, "w") as fh:
        fh.write(f"{bam}\n{sam}\n{cram}\n")
    subprocess.run([oracle_bin, "-i", lst, "-o",
                    os.path.join(tmp, "ref")], check=True,
                   capture_output=True)
    run_ours(tmp, ["-i", lst, "-o", os.path.join(tmp, "ours")])
    compare_outputs(tmp, "ref", "ours")


def test_multi_file_list(tmp_path, oracle_bin):
    tmp = str(tmp_path)
    bam1 = os.path.join(tmp, "a.bam")
    bam2 = os.path.join(tmp, "b.bam")
    # the reference's multi-file arrays only have +100 slack cells and
    # heap-overflow past that, so keep read overhang under it
    make_bam(bam1, n=300, seed=21, end_slack=90)
    make_bam(bam2, n=300, seed=22, end_slack=90)
    lst = os.path.join(tmp, "in.list")
    with open(lst, "w") as fh:
        fh.write(bam1 + "\n" + bam2 + "\n")
    ref_out = os.path.join(tmp, "ref")
    our_out = os.path.join(tmp, "ours")
    subprocess.run([oracle_bin, "-i", lst, "-o", ref_out], check=True,
                   capture_output=True)
    run_ours(tmp, ["-i", lst, "-o", our_out])
    compare_outputs(tmp, "ref", "ours")


@pytest.mark.parametrize("win", [0, 1000, 100])
def test_one_base_final_window_drop(tmp_path, oracle_bin, win):
    """A contig with (len - 1) % bin == 0 loses its final 1-base
    window in the reference's synthesis loop (the End+2 check,
    src/PanDepth.cpp:4000-4044) — in every mode that tiles contigs
    (chr uses 10 Mb bins, so only w-mode boundaries are practical to
    hit here) and in both single- and multi-file engines. Found by
    differential fuzzing (seed 3035)."""
    tmp = str(tmp_path)
    contigs = [("cA", 5001), ("cB", 4000), ("cC", 2001)]
    bam = os.path.join(tmp, "b.bam")
    # end_slack: >100 bp contig overhang is documented reference UB in
    # multi-file mode (heap writes land in the NEXT contig's array)
    make_bam(bam, contigs=contigs, n=600, seed=35, end_slack=60)
    extra = ["-w", str(win)] if win else []
    _both(tmp, oracle_bin, extra, bam=bam)

    # multi-file engine: same drop through the .list path
    bam2 = os.path.join(tmp, "b2.bam")
    make_bam(bam2, contigs=contigs, n=400, seed=36, end_slack=60)
    lst = os.path.join(tmp, "in.list")
    with open(lst, "w") as fh:
        fh.write(bam + "\n" + bam2 + "\n")
    ref_out = os.path.join(tmp, "refL")
    our_out = os.path.join(tmp, "oursL")
    subprocess.run([oracle_bin, "-i", lst, "-o", ref_out] + extra,
                   check=True, capture_output=True)
    run_ours(tmp, ["-i", lst, "-o", our_out] + extra)
    compare_outputs(tmp, "refL", "oursL")


def test_chr_mode_10mb_boundary_contig(tmp_path, oracle_bin):
    """Chr mode tiles with 10 Mb bins, so a 10,000,001-length contig
    hits the same 1-base final-window drop: the reference prints
    Length 10000000 for it (the last base never gets a region)."""
    tmp = str(tmp_path)
    contigs = [("big", 10_000_001), ("cB", 4000)]
    bam = os.path.join(tmp, "c.bam")
    make_bam(bam, contigs=contigs, n=300, seed=40, end_slack=60)
    _both(tmp, oracle_bin, [], bam=bam)
    ref = gunzip_bytes(os.path.join(tmp, "ref.chr.stat.gz"))
    assert b"big\t10000000\t" in ref  # the quirk itself, pinned
