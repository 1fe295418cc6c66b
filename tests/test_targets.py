"""Unit tests for target parsing semantics (SURVEY.md §4.2)."""

import gzip
import os

import numpy as np
import pytest

from pandepth_jax.config import (MODE_BED3, MODE_BED4, MODE_CHR, MODE_GFF,
                                 MODE_GTF, MODE_WIN_BIG, MODE_WIN_SMALL)
from pandepth_jax.targets.parse import (detect_bed_mode, detect_gff_mode,
                                        parse_targets)
from pandepth_jax.targets.windows import (small_window_tiling,
                                          synthesize_default_targets)

CHR2TID = {"chr1": 0, "chr2": 1}


def w(tmp_path, name, text):
    p = os.path.join(str(tmp_path), name)
    if name.endswith(".gz"):
        with gzip.open(p, "wt") as fh:
            fh.write(text)
    else:
        with open(p, "w") as fh:
            fh.write(text)
    return p


def test_detect_gff_vs_gtf(tmp_path):
    assert detect_gff_mode(w(tmp_path, "a.gff",
                             "chr1\tx\tCDS\t1\t5\t.\t+\t0\tID=a;Parent=b\n"
                             )) == MODE_GFF
    assert detect_gff_mode(w(tmp_path, "a.gtf",
                             'chr1\tx\tCDS\t1\t5\t.\t+\t0\tgene_id "g"; '
                             'transcript_id "t";\n')) == MODE_GTF
    # last informative line wins
    assert detect_gff_mode(w(tmp_path, "b.gff",
                             "chr1\tx\ty\t1\t2\t.\t+\t.\tParent=a\n"
                             "chr1\tx\ty\t1\t2\t.\t+\t.\ttranscript_id q\n"
                             )) == MODE_GTF
    assert detect_gff_mode(w(tmp_path, "c.gff", "#comment\n\n")) == 0


def test_detect_bed_mode(tmp_path):
    assert detect_bed_mode(w(tmp_path, "a.bed",
                             "chr1\t1\t10\nchr1\t5\t20\n")) == MODE_BED3
    assert detect_bed_mode(w(tmp_path, "b.bed",
                             "chr1\t1\t10\tr1\n")) == MODE_BED4
    assert detect_bed_mode(w(tmp_path, "c.bed",
                             "chr1\t1\t10\nchr1\t5\t20\tr2\n")) == MODE_BED4


def test_gff_parent_id_extraction(tmp_path):
    p = w(tmp_path, "t.gff",
          "chr1\ts\tCDS\t10\t20\t.\t+\t0\tID=cds1;Parent=mr1\n"
          "chr1\ts\tCDS\t30\t40\t.\t+\t0\tID=cds2,Parent=mr1\n"
          "chr1\ts\tCDS\t50\t60\t.\t+\t0\tID=cds3\n"
          "chr1\ts\texon\t70\t80\t.\t+\t0\tID=skipme;Parent=mr1\n")
    t = parse_targets(p, MODE_GFF, CHR2TID)
    assert t.gene_id == ["mr1", "cds3"]
    assert t.n_segments == 3
    # merged gene: span 10-40, length = 11 + 11
    assert t.gene_start[0] == 10 and t.gene_end[0] == 40
    assert t.gene_length[0] == 22


def test_gtf_token10_quirk(tmp_path):
    p = w(tmp_path, "t.gtf",
          'chr1\ts\tCDS\t10\t20\t.\t+\t0\tgene_id "gX"; '
          'transcript_id "tY";\n')
    t = parse_targets(p, MODE_GTF, CHR2TID)
    # quirk Q3: id is attribute token 10 (the gene_id VALUE), never
    # the transcript_id
    assert t.gene_id == ["gX"]


def test_bed3_string_ids_and_merge(tmp_path):
    p = w(tmp_path, "t.bed",
          "chr1\t007\t20\n"        # id keeps the original "007" string
          "chr1\t007\t20\n"        # duplicate row doubles the length
          "chr2\t30\t10\n"         # start > end: skipped
          "chrX\t1\t5\n")          # unknown contig: skipped
    t = parse_targets(p, MODE_BED3, CHR2TID)
    assert t.gene_id == ["chr1_007_20"]
    assert t.gene_length[0] == 28  # (20-7+1) * 2
    assert t.n_segments == 2


def test_bed4_ids(tmp_path):
    p = w(tmp_path, "t.bed", "chr1\t5\t9\tA\nchr1\t20\t30\tA\n"
                             "chr2\t1\t4\tB\n")
    t = parse_targets(p, MODE_BED4, CHR2TID)
    assert t.gene_id == ["A", "B"]
    assert t.gene_length[0] == 5 + 11
    assert t.gene_start[0] == 5 and t.gene_end[0] == 30


def test_window_synthesis_modes():
    names = ["c1", "c2"]
    lengths = np.array([250, 1])
    mode, t = synthesize_default_targets(names, lengths, 0)
    assert mode == MODE_CHR
    assert t.n_genes == 1          # len-1 contig gets no region
    mode, t = synthesize_default_targets(names, lengths, 100)
    assert mode == MODE_WIN_SMALL
    mode, t = synthesize_default_targets(names, lengths, 200)
    assert mode == MODE_WIN_BIG
    assert [int(x) for x in t.gene_start] == [1, 201]
    assert [int(x) for x in t.gene_end] == [200, 250]


def test_small_window_tiling_drops_last_base_quirk():
    tw = small_window_tiling(5, 2)
    # j in {1, 3} only (j < CC strictly): base 5 is dropped
    assert tw.tolist() == [[1, 2], [3, 4]]
    tw = small_window_tiling(6, 2)
    assert tw.tolist() == [[1, 2], [3, 4], [5, 6]]


def test_merged_spans_fuzz_vs_scalar_oracle():
    """Vectorized merged_spans/fetch_windows vs a straightforward
    per-tid scalar merge on random (incl. negative-start) spans."""
    import numpy as np
    from pandepth_jax.targets.model import TargetSet
    from pandepth_jax.config import MODE_BED3

    rng = np.random.RandomState(3)
    for trial in range(60):
        n_t = int(rng.randint(1, 6))
        n = int(rng.randint(0, 80))
        tid = rng.randint(0, n_t, n).astype(np.int32)
        s = rng.randint(-20, 400, n).astype(np.int64)
        e = s + rng.randint(0, 120, n).astype(np.int64)
        ts = TargetSet(mode=MODE_BED3, gene_tid=tid, gene_id=None,
                       gene_start=s, gene_end=e,
                       gene_length=e - s + 1,
                       gene_gc=np.zeros(n, np.int64),
                       seg_gene=np.arange(n, dtype=np.int32),
                       seg_start=s, seg_end=e)
        off, ms, me = ts.merged_spans(n_t)
        # scalar oracle
        o_off = [0]
        o_s, o_e = [], []
        for t in range(n_t):
            sel = np.flatnonzero(tid == t)
            order = sel[np.argsort(s[sel], kind="stable")]
            cur = None
            for i in order:
                if cur is None or s[i] > cur[1]:
                    if cur is not None:
                        o_s.append(cur[0]); o_e.append(cur[1])
                    cur = [int(s[i]), int(e[i])]
                elif e[i] > cur[1]:
                    cur[1] = int(e[i])
            if cur is not None:
                o_s.append(cur[0]); o_e.append(cur[1])
            o_off.append(len(o_s))
        assert np.array_equal(off, np.asarray(o_off)), trial
        assert np.array_equal(ms, np.asarray(o_s, np.int64)), trial
        assert np.array_equal(me, np.asarray(o_e, np.int64)), trial

        lengths = rng.randint(50, 500, n_t).astype(np.int64)
        w_off, b0, e0 = ts.fetch_windows(lengths)
        ob0, oe0, ow = [], [], [0]
        for t in range(n_t):
            c = 0
            for k in range(o_off[t], o_off[t + 1]):
                b = max(o_s[k] - 1, 1) - 1
                ee = min(o_e[k] + 1, int(lengths[t]))
                if ee > b:
                    ob0.append(b); oe0.append(ee); c += 1
            ow.append(ow[-1] + c)
        assert np.array_equal(w_off, np.asarray(ow)), trial
        assert np.array_equal(b0, np.asarray(ob0, np.int64)), trial
        assert np.array_equal(e0, np.asarray(oe0, np.int64)), trial


def test_packed_gc_matches_bytes():
    """PackedGC popcount counts must equal the raw-bytes path on random
    sequences for every alignment of range boundaries (head/tail/full
    byte splits, empty ranges, out-of-range clipping, lowercase, N)."""
    import numpy as np

    from pandepth_jax.io.fasta import PackedGC, gc_count_ranges

    rng = np.random.RandomState(11)
    seq = bytes(rng.choice(list(b"ACGTacgtNn"), 10_037).astype(np.uint8))
    p = PackedGC(seq)
    assert len(p) == len(seq)
    starts = rng.randint(-5, len(seq) + 10, 4000).astype(np.int64)
    ends = starts + rng.randint(-3, 40, 4000)
    np.testing.assert_array_equal(p.count_ranges(starts, ends),
                                  gc_count_ranges(seq, starts, ends))
    # dense sweep of every (offset, length<=17) pair at a byte seam
    s2, e2 = [], []
    for off in range(64, 90):
        for ln in range(0, 18):
            s2.append(off)
            e2.append(off + ln - 1)
    s2 = np.asarray(s2, np.int64)
    e2 = np.asarray(e2, np.int64)
    np.testing.assert_array_equal(p.count_ranges(s2, e2),
                                  gc_count_ranges(seq, s2, e2))
    assert PackedGC(b"").count_ranges(np.array([1]),
                                      np.array([5])).tolist() == [0]


def test_native_fasta_gc_matches_python(tmp_path):
    """The C++ streaming FASTA->PackedGC scanner must agree with the
    Python path on names, lengths, and packed bits (multi-contig,
    descriptions, CRLF, trailing header without newline, gzip)."""
    import gzip as _gz

    import numpy as np
    import pytest

    native = pytest.importorskip("pandepth_jax.io.native")
    if native.load_library() is None:
        pytest.skip("native unavailable")
    from pandepth_jax.io.fasta import PackedGC, iter_fasta, iter_fasta_gc

    rng = np.random.RandomState(4)
    body = b">c1 some description\r\n"
    s1 = bytes(rng.choice(list(b"ACGTacgtNn"), 1000).astype(np.uint8))
    body += b"\r\n".join(s1[i:i + 60] for i in range(0, 1000, 60))
    s2 = bytes(rng.choice(list(b"ACGT"), 17).astype(np.uint8))
    body += b"\n>c2\n" + s2 + b"\n>empty"
    for gz in (False, True):
        p = str(tmp_path / ("t.fa.gz" if gz else "t.fa"))
        if gz:
            with _gz.open(p, "wb") as fh:
                fh.write(body)
        else:
            with open(p, "wb") as fh:
                fh.write(body)
        got = list(iter_fasta_gc(p))
        exp = [(n, PackedGC(s)) for n, s in iter_fasta(p)]
        assert [g[0] for g in got] == [e[0] for e in exp] \
            == ["c1", "c2", "empty"]
        for (gn, gp), (en, ep) in zip(got, exp):
            assert len(gp) == len(ep)
            np.testing.assert_array_equal(gp.packed, ep.packed)
