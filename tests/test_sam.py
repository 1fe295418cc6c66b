"""SAM text input parity (plain and gzipped)."""

import gzip
import os
import subprocess

from tests.fixtures import CONTIGS, gunzip_bytes, random_reads

from pandepth_jax.cli import main as cli_main
from pandepth_jax.io.bam_writer import cigar_str_to_ops


def make_sam(path: str, contigs=CONTIGS, n=300, seed=17,
             gz: bool = False) -> None:
    recs = random_reads(contigs, n, seed)
    lines = ["@HD\tVN:1.6\tSO:coordinate"]
    for name, ln in contigs:
        lines.append(f"@SQ\tSN:{name}\tLN:{ln}")
    for i, (tid, pos, flag, mapq, cigar) in enumerate(recs):
        seq_len = sum(l for op, l in cigar_str_to_ops(cigar)
                      if op in (0, 1, 4, 7, 8)) if cigar != "*" else 0
        seq = "A" * seq_len if seq_len else "*"
        lines.append(
            f"r{i}\t{flag}\t{contigs[tid][0]}\t{pos + 1}\t{mapq}\t"
            f"{cigar}\t*\t0\t0\t{seq}\t*")
    data = ("\n".join(lines) + "\n").encode()
    if gz:
        with gzip.open(path, "wb") as fh:
            fh.write(data)
    else:
        with open(path, "wb") as fh:
            fh.write(data)


def _both(tmp, oracle, sam, extra):
    import glob

    subprocess.run([oracle, "-i", sam, "-o", os.path.join(tmp, "ref")]
                   + extra, check=True, capture_output=True)
    rc = cli_main(["pandepth", "-i", sam, "-o",
                   os.path.join(tmp, "ours")] + extra)
    assert rc == 0
    ref_files = sorted(glob.glob(os.path.join(tmp, "ref*.gz")))
    assert ref_files
    for rf in ref_files:
        of = rf.replace("ref", "ours", 1)
        assert gunzip_bytes(of) == gunzip_bytes(rf), os.path.basename(rf)


def test_sam_chr_mode(tmp_path, oracle_bin):
    tmp = str(tmp_path)
    sam = os.path.join(tmp, "t.sam")
    make_sam(sam)
    _both(tmp, oracle_bin, sam, [])


def test_sam_gz_with_filters(tmp_path, oracle_bin):
    tmp = str(tmp_path)
    sam = os.path.join(tmp, "t.sam.gz")
    make_sam(sam, gz=True, seed=18)
    _both(tmp, oracle_bin, sam, ["-q", "10", "-d", "2"])
