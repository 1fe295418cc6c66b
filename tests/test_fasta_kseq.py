"""kseq-exact FASTA semantics (reference include/kseq.h:94-224).

The reference reads ``-r`` with kseq, whose contract is subtle on
pathological bytes: records start at any '>' or '@'; name = bytes to
the first isspace(); '\\n' is the only line break (mid-line '\\r' is a
length-occupying base); ONE trailing '\\r' per line is trimmed, only
while the cumulative length exceeds 1; line-initial '+' switches to
FASTQ quality handling whose length mismatch (kseq_read -2) drops the
record and abandons the file. Both our scanners (Python iter_fasta and
the native pancov_fasta_gc_load) were built against a kseq-linked
differential oracle; these tests pin the corpus and the end-to-end
oracle parity.
"""

import glob
import os
import subprocess

import numpy as np
import pytest

from pandepth_jax.cli import main as cli_main
from pandepth_jax.io.fasta import PackedGC, iter_fasta, iter_fasta_gc
from tests.fixtures import gunzip_bytes, make_bam

NASTY = [
    b"> c1 desc\nACGT\nACGT\n>c2\nAC\rGT\n",
    b">a\nACGT\r\n",
    b">a\nACGT\r\r\n",
    b">a\n\r\n",
    b">a\n\r",
    b"junk\nxx>abc d\nACGT\n",
    b"xx@fq1 z\nACGT\n+\nIIII\n>next\nGG\n",
    b"@fq\nACGT\n+\nII\n",            # short qual: -2, drop + stop
    b"@fq\nACGT\n+\nIIIII\n>x\nA\n",  # long qual: -2, drop + stop
    b">a\nAC\n+\nXY\n>b\nGG\n",       # '+' inside a '>' record
    b">s\n+\nAB\n",
    b">s\n+\n",
    b">s\nAC\n+\n",
    b">",
    b">\n",
    b">n\nACGT\r",
    b">n\n\rACGT\n",
    b">n1\n>n2\nAC\n",
    b"\r\n>n\r\nA\r\n",
    b">a b\rc\nAG\n",
    b">x\nNNNN\n\n\nGG\n",
    b"G GGG+A +CAGCA\nAAACA\rG\t>AAG\n+AGG",  # '+' line hits EOF: drop
]

# (input, expected (name, seq) records) pinned from the kseq oracle
EXPECT = [
    (b"> c1 desc\nACGT\nACGT\n>c2\nAC\rGT\n",
     [("", b"ACGTACGT"), ("c2", b"AC\rGT")]),
    (b">a\nACGT\r\r\n", [("a", b"ACGT\r")]),
    (b">a\n\r\n", [("a", b"\r")]),      # lone leading \r survives (l==1)
    (b">a\n\r", [("a", b"\r")]),
    (b"xx@fq1 z\nACGT\n+\nIIII\n>next\nGG\n",
     [("fq1", b"ACGT"), ("next", b"GG")]),
    (b"@fq\nACGT\n+\nII\n", []),
    (b">a\nAC\n+\nXY\n>b\nGG\n", [("a", b"AC"), ("b", b"GG")]),
    (b">s\n+\n", [("s", b"")]),
    (b">", []),
    (b">\n", [("", b"")]),
    (b">n\nACGT\r", [("n", b"ACGT")]),
    (b"G GGG+A +CAGCA\nAAACA\rG\t>AAG\n+AGG", []),
]


def test_iter_fasta_kseq_corpus(tmp_path):
    p = str(tmp_path / "k.fa")
    for data, want in EXPECT:
        with open(p, "wb") as fh:
            fh.write(data)
        got = list(iter_fasta(p))
        assert got == want, data


def test_native_matches_python_scanner(tmp_path):
    from pandepth_jax.io.native import load_library

    if load_library() is None:
        pytest.skip("native library unavailable")
    p = str(tmp_path / "n.fa")
    for data in NASTY:
        with open(p, "wb") as fh:
            fh.write(data)
        py = [(nm, PackedGC(sq).n, PackedGC(sq).packed.tobytes())
              for nm, sq in iter_fasta(p)]
        nat = [(nm, g.n, np.asarray(g.packed).tobytes())
               for nm, g in iter_fasta_gc(p)]
        assert py == nat, data


def test_gc_parity_on_pathological_fasta(tmp_path, oracle_bin):
    """End-to-end: GC columns must match the reference byte-for-byte
    when the -r fasta has CRLF endings, mid-line '\\r' bases (which
    shift every downstream GC index), a space-separated header (name
    ''), and '\\r\\r' line ends."""
    tmp = str(tmp_path)
    contigs = [("chr1", 400), ("chr2", 300)]
    bam = os.path.join(tmp, "t.bam")
    make_bam(bam, contigs, n=300, seed=55)
    fa = os.path.join(tmp, "weird.fa")
    import random

    rng = random.Random(9)
    with open(fa, "wb") as fh:
        # chr1: CRLF + a mid-line \r + a \r\r line end
        s1 = "".join(rng.choice("ACGTacgtN") for _ in range(400))
        fh.write(b">chr1 desc\r\n")
        fh.write(s1[:97].encode() + b"\r\n")
        fh.write(s1[97:150].encode() + b"\r" + s1[150:199].encode()
                 + b"\n")
        fh.write(s1[199:260].encode() + b"\r\r\n")
        fh.write(s1[260:].encode() + b"\r\n")
        # '> chr2' parses as name '' (kseq stops at the space)
        fh.write(b"> chr2\r\n")
        fh.write("".join(rng.choice("ACGT") for _ in range(300)).encode()
                 + b"\r\n")
        # real chr2 afterwards
        fh.write(b">chr2\n")
        fh.write("".join(rng.choice("GCCA") for _ in range(300)).encode()
                 + b"\n")
    bed = os.path.join(tmp, "r.bed")
    with open(bed, "w") as fh:
        fh.write("chr1\t10\t220\nchr1\t90\t260\nchr2\t5\t290\n")
    for args in ([], ["-b", bed]):
        ref_out = os.path.join(tmp, "ref" + str(len(args)))
        our_out = os.path.join(tmp, "ours" + str(len(args)))
        rr = subprocess.run(
            [oracle_bin, "-i", bam, "-c", "-r", fa, "-o", ref_out]
            + args, capture_output=True)
        assert rr.returncode == 0, rr.stderr
        rc = cli_main(["pandepth", "-i", bam, "-c", "-r", fa,
                       "-o", our_out] + args)
        assert rc == 0
        for rf in sorted(glob.glob(ref_out + "*.gz")):
            of = rf.replace("ref" + str(len(args)),
                            "ours" + str(len(args)), 1)
            assert gunzip_bytes(rf) == gunzip_bytes(of), rf
