"""PAF engine parity tests."""

import gzip
import os
import random
import subprocess

from tests.fixtures import CONTIGS, gunzip_bytes, make_bed, make_fasta

from pandepth_jax.cli import main as cli_main


def make_paf(path: str, contigs=CONTIGS, n: int = 500, seed: int = 13,
             gz: bool = False) -> None:
    rng = random.Random(seed)
    lines = []
    for i in range(n):
        tid = rng.randrange(len(contigs))
        tname, tlen = contigs[tid]
        ts = rng.randrange(0, max(tlen - 150, 1))
        r = rng.random()
        extra = ""
        if r < 0.55:
            span = rng.randrange(30, 140)
            cg = f"cg:Z:{span}M"
            te = ts + span
            extra = f"\t{cg}"
        elif r < 0.75:
            a, d, b = rng.randrange(10, 50), rng.randrange(1, 9), \
                rng.randrange(10, 50)
            cg = f"cg:Z:{a}M{d}D{b}M{rng.randrange(1, 7)}I"
            te = ts + a + d + b
            extra = f"\t{cg}"
        else:
            # no cg -> span fill [ts-1, te): ts must be >= 1 or the
            # reference writes depth[-1] and corrupts its heap (quirk Q7)
            ts = max(ts, 1)
            te = ts + rng.randrange(20, 120)
        mapq = rng.choice([0, 5, 30, 60])
        tp = "\ttp:A:S" if rng.random() < 0.15 else "\ttp:A:P"
        qlen = 150
        lines.append(
            f"q{i}\t{qlen}\t0\t{qlen}\t+\t{tname}\t{tlen}\t{ts}\t{te}\t"
            f"100\t{max(te - ts, 1)}\t{mapq}{tp}{extra}")
    data = ("\n".join(lines) + "\n").encode()
    if gz:
        with gzip.open(path, "wb") as fh:
            fh.write(data)
    else:
        with open(path, "wb") as fh:
            fh.write(data)


def _compare(tmp):
    import glob

    ref_files = sorted(glob.glob(os.path.join(tmp, "ref*.gz")))
    assert ref_files
    for rf in ref_files:
        of = rf.replace("ref", "ours", 1)
        assert os.path.exists(of), of
        assert gunzip_bytes(of) == gunzip_bytes(rf), os.path.basename(rf)


def _both(tmp, oracle, paf, extra):
    subprocess.run([oracle, "-i", paf, "-o", os.path.join(tmp, "ref")]
                   + extra, check=True, capture_output=True)
    rc = cli_main(["pandepth", "-i", paf, "-o",
                   os.path.join(tmp, "ours")] + extra)
    assert rc == 0
    _compare(tmp)


def test_paf_chr_mode(tmp_path, oracle_bin):
    tmp = str(tmp_path)
    paf = os.path.join(tmp, "t.paf")
    make_paf(paf)
    _both(tmp, oracle_bin, paf, [])


def test_paf_gz_with_windows(tmp_path, oracle_bin):
    tmp = str(tmp_path)
    paf = os.path.join(tmp, "t.paf.gz")
    make_paf(paf, gz=True)
    _both(tmp, oracle_bin, paf, ["-w", "300"])


def test_paf_secondary_filter_and_mapq(tmp_path, oracle_bin):
    tmp = str(tmp_path)
    paf = os.path.join(tmp, "t.paf")
    make_paf(paf)
    _both(tmp, oracle_bin, paf, ["-q", "30", "-x", "256"])


def test_paf_with_reference_fasta(tmp_path, oracle_bin):
    # -r alone switches the contig table to fasta order and enables GC
    # columns; without -c the reference's GC counts read freed memory
    # (UB), so the GC column is excluded from the comparison
    from tests.fixtures import drop_gc_column

    tmp = str(tmp_path)
    paf = os.path.join(tmp, "t.paf")
    fa = os.path.join(tmp, "ref.fa")
    make_paf(paf)
    make_fasta(fa)
    subprocess.run([oracle_bin, "-i", paf, "-o", os.path.join(tmp, "ref"),
                    "-r", fa], check=True, capture_output=True)
    rc = cli_main(["pandepth", "-i", paf, "-o", os.path.join(tmp, "ours"),
                   "-r", fa])
    assert rc == 0
    ref = drop_gc_column(gunzip_bytes(os.path.join(tmp,
                                                   "ref.chr.stat.gz")))
    ours = drop_gc_column(gunzip_bytes(os.path.join(tmp,
                                                    "ours.chr.stat.gz")))
    assert ref == ours


def test_paf_gc(tmp_path, oracle_bin):
    tmp = str(tmp_path)
    paf = os.path.join(tmp, "t.paf")
    fa = os.path.join(tmp, "ref.fa")
    make_paf(paf)
    make_fasta(fa)
    _both(tmp, oracle_bin, paf, ["-c", "-r", fa])


def test_paf_bed_and_site_output(tmp_path, oracle_bin):
    tmp = str(tmp_path)
    paf = os.path.join(tmp, "t.paf")
    bed = os.path.join(tmp, "t.bed")
    make_paf(paf)
    make_bed(bed)
    _both(tmp, oracle_bin, paf, ["-b", bed, "-a"])


def test_paf_multi_file_list(tmp_path, oracle_bin):
    tmp = str(tmp_path)
    p1 = os.path.join(tmp, "a.paf")
    p2 = os.path.join(tmp, "b.paf")
    make_paf(p1, seed=31)
    make_paf(p2, seed=32)
    lst = os.path.join(tmp, "in.list")
    with open(lst, "w") as fh:
        fh.write(p1 + "\n" + p2 + "\n")
    subprocess.run([oracle_bin, "-i", lst, "-o",
                    os.path.join(tmp, "ref")], check=True,
                   capture_output=True)
    rc = cli_main(["pandepth", "-i", lst, "-o", os.path.join(tmp, "ours")])
    assert rc == 0
    _compare(tmp)


def test_paf_contig_table_native_matches_python(tmp_path, monkeypatch):
    """The native memchr contig scan must match the Python line scan
    exactly: first-seen order, <7-token lines skipped, CRLF stripped,
    duplicate names keep the first length, space-separated columns."""
    from pandepth_jax.io.paf import paf_contig_table

    p = str(tmp_path / "c.paf")
    with open(p, "wb") as fh:
        fh.write(b"r1\t100\t0\t100\t+\tctgA\t5000\t10\t110\t100\t100\t60\n")
        fh.write(b"r2\t100\t0\t100\t+\tctgB\t900\t1\t90\t100\t100\t60\r\n")
        fh.write(b"short\tline\n")                  # <7 tokens: skipped
        fh.write(b"\n")
        fh.write(b"r3 100 0 100 + ctgA 7777 5 80 100 100 60\n")  # dup
        fh.write(b"r4\t5\t0\t5\t+\tctgC\t42\t0\t5\t5\t5\t0")  # no NL
    native = paf_contig_table([p])
    monkeypatch.setenv("PANDEPTH_NO_NATIVE", "1")
    py = paf_contig_table([p])
    assert native[0] == py[0] == ["ctgA", "ctgB", "ctgC"]
    assert native[1].tolist() == py[1].tolist() == [5000, 900, 42]
