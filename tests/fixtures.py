"""Synthetic genome / alignment / target fixtures.

The reference repo ships no test data (SURVEY.md §4), so every parity
test generates its own tiny FASTA + BAM (+ targets) with our writers and
runs both implementations on them.
"""

from __future__ import annotations

import gzip
import os
import random
import subprocess
from typing import List, Optional, Sequence, Tuple

import numpy as np

from pandepth_jax.io.bam_writer import cigar_str_to_ops, ref_span, write_bam

CONTIGS = [("chr1", 5000), ("chr2", 3200), ("ctgM", 700)]


def make_fasta(path: str, contigs=CONTIGS, seed: int = 7,
               line_len: int = 60) -> None:
    rng = random.Random(seed)
    with open(path, "w") as fh:
        for name, ln in contigs:
            fh.write(f">{name} extra description\n")
            seq = "".join(rng.choice("ACGTacgtN") for _ in range(ln))
            for i in range(0, ln, line_len):
                fh.write(seq[i: i + line_len] + "\n")


def random_reads(contigs=CONTIGS, n: int = 800, seed: int = 11,
                 max_read: int = 150,
                 end_slack: Optional[int] = None) -> List[Tuple]:
    """Coordinate-sorted (tid, pos0, flag, mapq, cigar) records with a
    spread of CIGAR shapes, FLAG bits and MAPQs.

    ``end_slack`` caps how far past its contig end a read may reach —
    the reference's multi-file engine only allocates +100 slack cells
    (src/PanDepth.cpp:2687-2699) and heap-overflows beyond that, so
    multi-file parity fixtures pass a value < 100.
    """
    rng = random.Random(seed)
    recs = []
    while len(recs) < n:
        tid = rng.randrange(len(contigs))
        clen = contigs[tid][1]
        pos = rng.randrange(0, max(clen - 20, 1))
        roll = rng.random()
        if roll < 0.55:
            cigar = f"{rng.randrange(20, max_read)}M"
        elif roll < 0.7:
            a, b, c = (rng.randrange(5, 40) for _ in range(3))
            cigar = f"{a}M{rng.randrange(1, 9)}D{b}M{rng.randrange(1, 5)}I{c}M"
        elif roll < 0.8:
            a, b = rng.randrange(5, 40), rng.randrange(5, 40)
            cigar = f"{rng.randrange(1, 20)}S{a}M{rng.randrange(20, 400)}N{b}M"
        elif roll < 0.9:
            a, b = rng.randrange(5, 40), rng.randrange(5, 40)
            cigar = f"{a}={rng.randrange(1, 6)}X{b}="
        else:
            cigar = f"{rng.randrange(10, 60)}M{rng.randrange(5, 30)}S"
        flag = 0
        r = rng.random()
        if r < 0.06:
            flag |= 0x100   # secondary
        elif r < 0.1:
            flag |= 0x400   # duplicate
        elif r < 0.13:
            flag |= 0x200   # QC fail
        elif r < 0.15:
            flag = 4        # unmapped
            cigar = "*"
        if rng.random() < 0.5:
            flag |= 0x10
        mapq = rng.choice([0, 1, 10, 30, 60])
        if end_slack is not None and cigar != "*":
            end = pos + ref_span(cigar_str_to_ops(cigar))
            if end > clen + end_slack:
                continue
        recs.append((tid, pos, flag, mapq, cigar))
    recs.sort(key=lambda r: (r[0], r[1]))
    return recs


def make_bam(path: str, contigs=CONTIGS, n: int = 800, seed: int = 11,
             make_index: bool = True,
             end_slack: Optional[int] = None) -> List[Tuple]:
    recs = random_reads(contigs, n, seed, end_slack=end_slack)
    names = [c[0] for c in contigs]
    lengths = [c[1] for c in contigs]
    write_bam(path, names, lengths, recs, make_index=make_index)
    return recs


def make_gff(path: str, contigs=CONTIGS, feature: str = "CDS",
             gz: bool = False, overhang: bool = True) -> None:
    """``overhang=True`` includes a segment past a contig end (good
    depth-slack coverage, but UB garbage in the reference's GC reads —
    GC fixtures must pass False)."""
    end_c6 = 3300 if overhang else 3150
    lines = [
        "##gff-version 3",
        f"{contigs[0][0]}\tsrc\tgene\t100\t900\t.\t+\t.\tID=gene1",
        f"{contigs[0][0]}\tsrc\t{feature}\t120\t340\t.\t+\t0\tID=cds1;Parent=mRNA1",
        f"{contigs[0][0]}\tsrc\t{feature}\t300\t520\t.\t+\t0\tID=cds2;Parent=mRNA1",
        f"{contigs[0][0]}\tsrc\t{feature}\t700\t890\t.\t+\t0\tID=cds3;Parent=mRNA1",
        f"{contigs[0][0]}\tsrc\t{feature}\t1200\t1500\t.\t-\t0\tID=c4;Parent=mRNA2",
        f"{contigs[1][0]}\tsrc\t{feature}\t50\t400\t.\t+\t0\tID=c5;Parent=mRNA3",
        f"{contigs[1][0]}\tsrc\t{feature}\t2900\t{end_c6}\t.\t+\t0\tID=c6;Parent=mRNA4",
        f"{contigs[2][0]}\tsrc\t{feature}\t1\t700\t.\t+\t0\tID=c7;Parent=mRNA5",
        f"chrNOPE\tsrc\t{feature}\t1\t100\t.\t+\t0\tID=c8;Parent=mRNA6",
    ]
    data = ("\n".join(lines) + "\n").encode()
    if gz:
        with gzip.open(path, "wb") as fh:
            fh.write(data)
    else:
        with open(path, "wb") as fh:
            fh.write(data)


def make_gtf(path: str, contigs=CONTIGS, feature: str = "CDS") -> None:
    lines = [
        f'{contigs[0][0]}\tsrc\t{feature}\t150\t450\t.\t+\t0\t'
        f'gene_id "g1"; transcript_id "t1";',
        f'{contigs[0][0]}\tsrc\t{feature}\t600\t800\t.\t+\t0\t'
        f'gene_id "g1"; transcript_id "t1";',
        f'{contigs[1][0]}\tsrc\t{feature}\t10\t500\t.\t-\t0\t'
        f'gene_id "g2"; transcript_id "t2";',
    ]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def make_bed(path: str, contigs=CONTIGS, four_col: bool = False) -> None:
    rows = [
        (contigs[0][0], 100, 600),
        (contigs[0][0], 550, 1200),
        (contigs[1][0], 1, 3200),
        (contigs[2][0], 650, 800),   # overhangs the contig end
        (contigs[0][0], 100, 600),   # duplicate row (id-merge quirk)
    ]
    with open(path, "w") as fh:
        for i, (c, s, e) in enumerate(rows):
            if four_col:
                fh.write(f"{c}\t{s}\t{e}\tregion{i % 4}\n")
            else:
                fh.write(f"{c}\t{s}\t{e}\n")


def run_oracle(oracle: str, workdir: str, args: Sequence[str]) -> None:
    subprocess.run([oracle] + list(args), cwd=workdir, check=True,
                   capture_output=True)


def gunzip_bytes(path: str) -> bytes:
    with gzip.open(path, "rb") as fh:
        return fh.read()


def drop_gc_column(data: bytes) -> bytes:
    """Remove the GC(%) column (located via the header) and the footer's
    GC field — for comparing tables where the reference's GC output is
    undefined behavior."""
    lines = data.decode().splitlines()
    gc_idx = None
    out = []
    for line in lines:
        if line.startswith("##"):
            fields = [f for f in line.split("\t")
                      if not f.startswith("GC(%):")]
        elif line.startswith("#"):
            cols = line.split("\t")
            if "GC(%)" in cols:
                gc_idx = cols.index("GC(%)")
                cols.remove("GC(%)")
            fields = cols
        else:
            fields = line.split("\t")
            if gc_idx is not None:
                del fields[gc_idx]
        out.append("\t".join(fields))
    return ("\n".join(out) + "\n").encode()


def naive_depth(contigs, recs, flags_mask: int = 1796,
                min_mapq: int = -1) -> List[np.ndarray]:
    """Per-base oracle: straight CIGAR walk like the reference hot loop
    (src/PanDepth.cpp:436-460), with +512 slack."""
    depth = [np.zeros(ln + 512, np.int64) for _, ln in contigs]
    for tid, pos, flag, mapq, cigar, *_ in recs:
        if flag & flags_mask:
            continue
        if min_mapq >= 1 and mapq < min_mapq:
            continue
        if cigar == "*":
            continue
        cur = pos
        for op, ln in cigar_str_to_ops(cigar):
            if op in (0, 7, 8):
                end = min(cur + ln, depth[tid].shape[0])
                depth[tid][cur:end] += 1
                cur += ln
            elif op in (2, 3):
                cur += ln
    return depth
