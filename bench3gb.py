"""North-star benchmark (BASELINE.md): a 3 Gb-genome BAM, chr mode and
gene mode (~175k CDS segments, mirroring the reference's Capsicum
annuum workload: 33,688 genes / 175,274 exons), ours vs the reference
binary on the same host, wall + max RSS both.

Prints one JSON object (merged into ``$PANDEPTH_BENCH3GB_OUT`` when
set). Run standalone: ``python bench3gb.py``.
"""

from __future__ import annotations

import json
import os
import resource
import subprocess
import sys
import time

BENCH_DIR = os.environ.get("PANDEPTH_BENCH_DIR", "/tmp/pandepth_bench")
N_READS = int(os.environ.get("PANDEPTH_BENCH3GB_READS", 8_000_000))
N_CONTIGS = 12
CONTIG_LEN = 250_000_000          # 12 x 250 Mb = 3 Gb
N_GENES = 33_688
SEGS_PER_GENE = 5                 # ~175k CDS segments
REF_BIN = "/tmp/refbin/pandepth"
REF_SRC = "/root/reference/src/PanDepth.cpp"


def _make(what: str) -> None:
    """Generate a fixture in a subprocess. Numpy-heavy generation in
    THIS process would inflate every later child's inherited RSS
    watermark (fork snapshots the parent's resident set into the
    child's ru_maxrss baseline), corrupting the artifact's RSS
    columns."""
    subprocess.run([sys.executable, os.path.abspath(__file__),
                    "--make", what], check=True)


def ensure_fixture():
    os.makedirs(BENCH_DIR, exist_ok=True)
    bam = os.path.join(BENCH_DIR, f"bench3gb_{N_READS}.bam")
    gff = os.path.join(BENCH_DIR, "bench3gb_genes.gff")
    bed = os.path.join(BENCH_DIR, "bench3gb_regions.bed")
    if not os.path.exists(bed) and os.path.exists(gff):
        _write_bed_from_gff(gff, bed)
    if os.path.exists(bam) and os.path.exists(gff):
        return bam, gff, bed
    sys.stderr.write(f"bench3gb: generating {N_READS}-read / 3 Gb "
                     f"fixture...\n")
    _make("main")
    return bam, gff, bed


def _gen_main_fixture(bam, gff, bed, n_reads=N_READS,
                      n_contigs=N_CONTIGS, contig_len=CONTIG_LEN,
                      n_genes=N_GENES):
    import numpy as np

    from pandepth_jax.io.bam_writer import write_uniform_bam

    rng = np.random.RandomState(7)
    names = [f"chr{i + 1}" for i in range(n_contigs)]
    lens = np.full(n_contigs, contig_len, np.int64)
    tid = rng.randint(0, n_contigs, n_reads).astype(np.int32)
    pos = (rng.rand(n_reads) * (contig_len - 200)).astype(np.int32)
    order = np.lexsort((pos, tid))
    tid, pos = tid[order], pos[order]
    mapq = rng.choice([0, 10, 30, 60], n_reads).astype(np.uint8)
    flag = np.where(rng.rand(n_reads) < 0.05, 1024, 0).astype(
        np.uint16)
    tmp = bam + ".tmp"
    write_uniform_bam(tmp, names, lens.tolist(), tid, pos, flag, mapq)
    os.replace(tmp + ".bai", bam + ".bai")
    os.replace(tmp, bam)

    with open(gff + ".tmp", "w") as fh:
        g = 0
        per = n_genes // n_contigs + 1
        for c in range(n_contigs):
            step = (contig_len - 50_000) // per
            for k in range(per):
                if g >= n_genes:
                    break
                base = 1000 + k * step
                gid = f"g{g}"
                fh.write(f"{names[c]}\tsrc\tmRNA\t{base}\t"
                         f"{base + 20_000}\t.\t+\t.\tID={gid}\n")
                for s in range(SEGS_PER_GENE):
                    a = base + s * 4_000
                    b = a + 1_500
                    fh.write(f"{names[c]}\tsrc\tCDS\t{a}\t{b}\t.\t+"
                             f"\t.\tParent={gid}\n")
                g += 1
    os.replace(gff + ".tmp", gff)
    _write_bed_from_gff(gff, bed)


def _write_bed_from_gff(gff: str, bed: str) -> None:
    """BED4 regions from the CDS rows of the gene fixture (same ~175k
    segments, exercising the .bed table shape / RegionID path)."""
    with open(gff) as fh, open(bed + ".tmp", "w") as out:
        k = 0
        for line in fh:
            f = line.split("\t")
            if len(f) > 4 and f[2] == "CDS":
                out.write(f"{f[0]}\t{int(f[3]) - 1}\t{f[4]}\tr{k}\n")
                k += 1
    os.replace(bed + ".tmp", bed)


def _gen_list_extra_fixture(bam: str, seed: int, n=N_READS // 2,
                            n_contigs=N_CONTIGS,
                            contig_len=CONTIG_LEN) -> None:
    """One extra 4M-read sample BAM for the `.list` pooled config."""
    import numpy as np

    from pandepth_jax.io.bam_writer import write_uniform_bam

    rng = np.random.RandomState(100 + seed)
    names = [f"chr{i + 1}" for i in range(n_contigs)]
    tid = rng.randint(0, n_contigs, n).astype(np.int32)
    pos = (rng.rand(n) * (contig_len - 200)).astype(np.int32)
    order = np.lexsort((pos, tid))
    tid, pos = tid[order], pos[order]
    mapq = rng.choice([0, 10, 30, 60], n).astype(np.uint8)
    flag = np.where(rng.rand(n) < 0.05, 1024, 0).astype(np.uint16)
    tmp = bam + ".tmp"
    write_uniform_bam(tmp, names, [contig_len] * n_contigs, tid, pos,
                      flag, mapq)
    os.replace(tmp + ".bai", bam + ".bai")
    os.replace(tmp, bam)


def _gen_scale10x_fixture(bam: str) -> None:
    """80M sorted reads over the same 3 Gb contig space (chunked
    generation: 80M-read lexsort at once would swap this 4-core VM)."""
    import numpy as np

    from pandepth_jax.io.bam_writer import write_uniform_bam

    rng = np.random.RandomState(11)
    n = N_READS * 10
    names = [f"chr{i + 1}" for i in range(N_CONTIGS)]
    tid = np.sort(rng.randint(0, N_CONTIGS, n).astype(np.int32))
    pos = np.empty(n, np.int32)
    for t in range(N_CONTIGS):
        sel = np.nonzero(tid == t)[0]
        pos[sel] = np.sort((rng.rand(sel.shape[0])
                            * (CONTIG_LEN - 200)).astype(np.int32))
    mapq = rng.choice([0, 10, 30, 60], n).astype(np.uint8)
    flag = np.where(rng.rand(n) < 0.05, 1024, 0).astype(np.uint16)
    tmp = bam + ".tmp"
    write_uniform_bam(tmp, names, [CONTIG_LEN] * N_CONTIGS, tid, pos,
                      flag, mapq)
    os.replace(tmp + ".bai", bam + ".bai")
    os.replace(tmp, bam)


def _gen_deep_fixture(bam: str) -> None:
    """240M sorted 375 bp reads over the 3 Gb contig space (~30x
    coverage): the deep-coverage row (the reference's
    per-base arrays are flat O(genome) at any read count; ours bounds
    one-shot RSS via the host engine's streaming fold)."""
    import numpy as np

    from pandepth_jax.io.bam_writer import write_uniform_bam

    rng = np.random.RandomState(23)
    n = N_READS * 30
    names = [f"chr{i + 1}" for i in range(N_CONTIGS)]
    counts = rng.multinomial(n, [1.0 / N_CONTIGS] * N_CONTIGS)
    tid = np.repeat(np.arange(N_CONTIGS, dtype=np.int32), counts)
    pos = np.empty(n, np.int32)
    o = 0
    for t in range(N_CONTIGS):
        k = int(counts[t])
        pos[o:o + k] = np.sort(
            (rng.rand(k) * (CONTIG_LEN - 400)).astype(np.int32))
        o += k
    mapq = rng.choice([0, 10, 30, 60], n).astype(np.uint8)
    flag = np.where(rng.rand(n) < 0.05, 1024, 0).astype(np.uint16)
    tmp = bam + ".tmp"
    write_uniform_bam(tmp, names, [CONTIG_LEN] * N_CONTIGS, tid, pos,
                      flag, mapq, read_len=375)
    os.replace(tmp + ".bai", bam + ".bai")
    os.replace(tmp, bam)


def _gen_big_genome_fixture(bam: str, n=N_READS) -> None:
    """8M sorted reads over a 15 Gb / 8 x 1.875 Gb genome (int64
    coordinate tier; contig lengths stay under BAM's int32 limit)."""
    import numpy as np

    from pandepth_jax.io.bam_writer import write_uniform_bam

    rng = np.random.RandomState(29)
    clen = 1_875_000_000
    names = [f"w{i + 1}" for i in range(8)]
    counts = rng.multinomial(n, [1.0 / 8] * 8)
    tid = np.repeat(np.arange(8, dtype=np.int32), counts)
    pos = np.empty(n, np.int32)
    o = 0
    for t in range(8):
        k = int(counts[t])
        pos[o:o + k] = np.sort(
            (rng.rand(k) * (clen - 200)).astype(np.int32))
        o += k
    mapq = rng.choice([0, 10, 30, 60], n).astype(np.uint8)
    flag = np.where(rng.rand(n) < 0.05, 1024, 0).astype(np.uint16)
    tmp = bam + ".tmp"
    write_uniform_bam(tmp, names, [clen] * 8, tid, pos, flag, mapq)
    os.replace(tmp + ".csi", bam + ".csi")
    os.replace(tmp, bam)


def _write_fasta_fixture(fa: str, n_contigs=N_CONTIGS,
                         contig_len=CONTIG_LEN) -> None:
    """3 Gb random ACGT reference over the same contig space."""
    import numpy as np

    rng = np.random.RandomState(9)
    line = min(contig_len, 10_000_000)
    with open(fa + ".tmp", "w", buffering=1 << 22) as fh:
        for c in range(n_contigs):
            fh.write(f">chr{c + 1}\n")
            for _ in range(contig_len // line):
                seq = rng.choice([65, 67, 71, 84],
                                 line).astype(np.uint8)
                fh.write(seq.tobytes().decode("ascii"))
                fh.write("\n")
    os.replace(fa + ".tmp", fa)


def _write_cram_fixture(cram: str, n=2_000_000, n_contigs=N_CONTIGS,
                        contig_len=CONTIG_LEN) -> None:
    """2M-read coordinate-sorted CRAM (+.crai) over the contig space."""
    import numpy as np

    from pandepth_jax.io.cram_writer import write_cram

    rng = np.random.RandomState(3)
    names = [f"chr{i + 1}" for i in range(n_contigs)]
    tid = np.sort(rng.randint(0, n_contigs, n))
    recs = []
    for t in range(n_contigs):
        k = int((tid == t).sum())
        pos = np.sort(rng.randint(0, contig_len - 200, k))
        mq = rng.choice([0, 10, 30, 60], k)
        recs.extend((int(t), int(p), 0, int(q), "150M")
                    for p, q in zip(pos, mq))
    write_cram(cram + ".tmp", names, [contig_len] * n_contigs, recs,
               index=True)
    os.replace(cram + ".tmp.crai", cram + ".crai")
    os.replace(cram + ".tmp", cram)


def _write_paf_fixture(paf: str, n=N_READS, n_contigs=N_CONTIGS,
                       contig_len=CONTIG_LEN) -> None:
    """8M-line PAF over the same 3 Gb contig space (cg:Z:150M)."""
    import numpy as np

    rng = np.random.RandomState(5)
    names = [f"chr{i + 1}" for i in range(n_contigs)]
    L = contig_len
    tid = rng.randint(0, n_contigs, n)
    pos = rng.randint(0, L - 200, n)
    mapq = rng.choice([0, 10, 30, 60], n)
    with open(paf + ".tmp", "w", buffering=1 << 22) as fh:
        chunk = 200_000
        for i in range(0, n, chunk):
            rows = [f"r\t150\t0\t150\t+\t{names[t]}\t{L}\t{p}\t"
                    f"{p + 150}\t150\t150\t{q}\tcg:Z:150M"
                    for t, p, q in zip(tid[i:i + chunk],
                                       pos[i:i + chunk],
                                       mapq[i:i + chunk])]
            fh.write("\n".join(rows) + "\n")
    os.replace(paf + ".tmp", paf)


def ensure_reference():
    if os.path.exists(REF_BIN):
        return REF_BIN
    if not os.path.exists(REF_SRC):
        return None
    os.makedirs(os.path.dirname(REF_BIN), exist_ok=True)
    try:
        subprocess.run(
            ["g++", "--std=c++11", "-O3", "-o", REF_BIN, REF_SRC,
             "-I/root/reference/include", "-L/root/reference/lib",
             "-lhts", "-ldeflate", "-lz", "-lpthread"],
            check=True, capture_output=True, timeout=600)
        return REF_BIN
    except Exception:
        return None


def run_child(argv):
    """(wall_s, max_rss_mb) of one subprocess run."""
    t0 = time.perf_counter()
    p = subprocess.Popen(argv, stdout=subprocess.DEVNULL,
                         stderr=subprocess.DEVNULL)
    _, status, ru = os.wait4(p.pid, 0)
    wall = time.perf_counter() - t0
    if status != 0:
        raise RuntimeError(f"{argv[0]} exited {status}")
    return wall, ru.ru_maxrss / 1024.0


def ours_argv(bam, out, extra):
    launcher = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "pandepth")
    return [sys.executable, "-S", launcher, "-i", bam,
            "-o", out] + extra


def _gz_eq(a_path, b_path, chunk=1 << 24):
    """Streamed decompressed-byte equality — SiteDepth dumps are tens
    of GB decompressed, never load them whole."""
    import gzip

    with gzip.open(a_path, "rb") as fa, gzip.open(b_path, "rb") as fb:
        while True:
            a = fa.read(chunk)
            b = fb.read(chunk)
            if a != b:
                return False
            if not a:
                return True


def best(fn, n):
    """(median wall, max RSS) over n runs — medians survive the host's
    load noise better than minima."""
    import statistics

    walls, rss = [], []
    for _ in range(n):
        w, r = fn()
        walls.append(w)
        rss.append(r)
    return statistics.median(walls), max(rss)


def main():
    # the launcher routes through the resident daemon by default; the
    # cold sections must measure the honest cold-subprocess path (the
    # daemon section below opts back in explicitly)
    os.environ["PANDEPTH_DAEMON"] = "0"
    # the bench's own daemon socket: its direct runs stop only the
    # daemon they would share the device with
    os.environ.setdefault("PANDEPTH_DAEMON_SOCK",
                          os.path.join(BENCH_DIR, "bench.sock"))
    bam, gff, bed = ensure_fixture()
    ref = ensure_reference()
    out = os.path.join(BENCH_DIR, "b3g")
    results = {"n_reads": N_READS, "genome_bp": N_CONTIGS * CONTIG_LEN,
               "gene_segments": N_GENES * SEGS_PER_GENE,
               "host_cores": os.cpu_count(),
               "estimator": "median3",
               "platform": os.environ.get("JAX_PLATFORMS") or "default"}

    # PANDEPTH_BENCH3GB_ONLY=sitedump,w100,... reruns just the named
    # opt-in sections (merge-update keeps the other keys): the base
    # configs cost ~15 min and need not be re-measured to land one
    # long section's row
    only = os.environ.get("PANDEPTH_BENCH3GB_ONLY")
    only = set(only.split(",")) if only else None

    def want(section: str) -> bool:
        return only is None or section in only

    # all four table shapes of the BASELINE parity configs: chr, gene
    # (GFF CDS), bed (BED4), win (mode 5 tiling)
    configs = (("chr", []), ("gene", ["-g", gff]),
               ("bed", ["-b", bed]), ("win", ["-w", "500000"]))
    for mode, extra in configs if want("base") else ():
        # ours first; one warm-up run per mode pays the compile
        run_child(ours_argv(bam, out + "o", extra))
        w, r = best(lambda: run_child(ours_argv(bam, out + "o",
                                                extra)), 3)
        results[f"ours_{mode}_wall_s"] = round(w, 3)
        results[f"ours_{mode}_rss_mb"] = round(r, 1)
        results[f"ours_{mode}_reads_per_s"] = round(N_READS / w, 1)
        if ref:
            w2, r2 = best(lambda: run_child(
                [ref, "-i", bam, "-o", out + "r"] + extra), 3)
            results[f"ref_{mode}_wall_s"] = round(w2, 3)
            results[f"ref_{mode}_rss_mb"] = round(r2, 1)
            results[f"ref_{mode}_reads_per_s"] = round(N_READS / w2, 1)
            results[f"vs_baseline_{mode}"] = round(w2 / w, 3)

    # small-window whole-genome mode (-w 100: ~30M windows; the
    # reference allocates per-base SiteInfo arrays, 12.8 GB at 3 Gb).
    # Long (the reference needs 10+ min), so opt-in; single runs.
    if os.environ.get("PANDEPTH_BENCH3GB_W100") == "1" or \
            (only is not None and "w100" in only):
        # distinct output prefixes: the mode-5 win tables above feed
        # the parity check below and must not be overwritten
        run_child(ours_argv(bam, out + "ow100", ["-w", "100"]))  # warm: populate the jit cache
        w, r = run_child(ours_argv(bam, out + "ow100", ["-w", "100"]))
        results["ours_w100_wall_s"] = round(w, 3)
        results["ours_w100_rss_mb"] = round(r, 1)
        if ref:
            try:
                w2, r2 = run_child(["timeout", "2400", ref, "-i", bam,
                                    "-o", out + "rw100", "-w", "100"])
                results["ref_w100_wall_s"] = round(w2, 3)
                results["ref_w100_rss_mb"] = round(r2, 1)
                results["vs_baseline_w100"] = round(w2 / w, 3)
                import gzip as _g
                with _g.open(out + "ow100.win.stat.gz", "rb") as fh:
                    a = fh.read()
                with _g.open(out + "rw100.win.stat.gz", "rb") as fh:
                    b = fh.read()
                results["parity_w100"] = a == b
            except RuntimeError:
                results["ref_w100_wall_s"] = None  # timed out (2400s)
                results["vs_baseline_w100"] = round(2400.0 / w, 3)

    # GC mode (opt-in: generates a 3 GB reference fasta once)
    if os.environ.get("PANDEPTH_BENCH3GB_GC") == "1" or \
            (only is not None and "gc" in only):
        fa = os.path.join(BENCH_DIR, "bench3gb.fa")
        if not os.path.exists(fa):
            _make("fasta")
        extra = ["-g", gff, "-c", "-r", fa]
        run_child(ours_argv(bam, out + "ogc", extra))  # warm: populate the jit cache
        w, r = run_child(ours_argv(bam, out + "ogc", extra))
        results["ours_gc_wall_s"] = round(w, 3)
        results["ours_gc_rss_mb"] = round(r, 1)
        if ref:
            w2, r2 = run_child([ref, "-i", bam, "-o", out + "rgc"]
                               + extra)
            results["ref_gc_wall_s"] = round(w2, 3)
            results["ref_gc_rss_mb"] = round(r2, 1)
            results["vs_baseline_gc"] = round(w2 / w, 3)
            import gzip as _g
            with _g.open(out + "ogc.gene.stat.gz", "rb") as fh:
                a = fh.read()
            with _g.open(out + "rgc.gene.stat.gz", "rb") as fh:
                b = fh.read()
            results["parity_gc"] = a == b

    # CRAM + GC (BASELINE parity config 5) at scale (opt-in: writes a
    # 2M-read CRAM once, ~4 min)
    if os.environ.get("PANDEPTH_BENCH3GB_CRAM") == "1" or \
            (only is not None and "cram" in only):
        cram = os.path.join(BENCH_DIR, "bench3gb_2m.cram")
        if not os.path.exists(cram):
            _make("cram")
        fa = os.path.join(BENCH_DIR, "bench3gb.fa")
        if not os.path.exists(fa):
            _make("fasta")
        extra = ["-g", gff, "-c", "-r", fa]
        run_child(ours_argv(cram, out + "ocr", extra))  # warm: populate the jit cache
        w, r = run_child(ours_argv(cram, out + "ocr", extra))
        results["ours_cramgc_wall_s"] = round(w, 3)
        results["ours_cramgc_rss_mb"] = round(r, 1)
        if ref:
            w2, r2 = run_child([ref, "-i", cram, "-o", out + "rcr"]
                               + extra)
            results["ref_cramgc_wall_s"] = round(w2, 3)
            results["ref_cramgc_rss_mb"] = round(r2, 1)
            results["vs_baseline_cramgc"] = round(w2 / w, 3)
            import gzip as _g
            with _g.open(out + "ocr.gene.stat.gz", "rb") as fh:
                a = fh.read()
            with _g.open(out + "rcr.gene.stat.gz", "rb") as fh:
                b = fh.read()
            results["parity_cramgc"] = a == b

    # -a site dump at scale (opt-in: writes chr\tpos\tdepth for every
    # base of the 3 Gb genome — tens of GB decompressed — so single
    # runs, and the reference gets the same timeout as w100)
    if os.environ.get("PANDEPTH_BENCH3GB_SITEDUMP") == "1" or \
            (only is not None and "sitedump" in only):
        run_child(ours_argv(bam, out + "oa", ["-a"]))  # warm
        w, r = run_child(ours_argv(bam, out + "oa", ["-a"]))
        results["ours_sitedump_wall_s"] = round(w, 3)
        results["ours_sitedump_rss_mb"] = round(r, 1)
        if ref:
            try:
                w2, r2 = run_child(["timeout", "3600", ref, "-i", bam,
                                    "-o", out + "ra", "-a"])
                results["ref_sitedump_wall_s"] = round(w2, 3)
                results["ref_sitedump_rss_mb"] = round(r2, 1)
                results["vs_baseline_sitedump"] = round(w2 / w, 3)
                results["parity_sitedump"] = _gz_eq(
                    out + "oa.SiteDepth.gz", out + "ra.SiteDepth.gz")
            except RuntimeError:
                results["ref_sitedump_wall_s"] = None  # timed out
                results["vs_baseline_sitedump"] = round(3600.0 / w, 3)

    # PAF engine at scale (opt-in: the reference's single-threaded
    # PAF parse + per-base fill needs ~7 min on this fixture)
    if os.environ.get("PANDEPTH_BENCH3GB_PAF") == "1" or \
            (only is not None and "paf" in only):
        paf = os.path.join(BENCH_DIR, "bench3gb.paf")
        if not os.path.exists(paf):
            _make("paf")
        run_child(ours_argv(paf, out + "opaf", []))  # warm: populate the jit cache
        w, r = run_child(ours_argv(paf, out + "opaf", []))
        results["ours_paf_wall_s"] = round(w, 3)
        results["ours_paf_rss_mb"] = round(r, 1)
        if ref:
            try:
                w2, r2 = run_child(["timeout", "2400", ref, "-i", paf,
                                    "-o", out + "rpaf"])
                results["ref_paf_wall_s"] = round(w2, 3)
                results["vs_baseline_paf"] = round(w2 / w, 3)
                import gzip as _g
                with _g.open(out + "opaf.chr.stat.gz", "rb") as fh:
                    a = fh.read()
                with _g.open(out + "rpaf.chr.stat.gz", "rb") as fh:
                    b = fh.read()
                results["parity_paf"] = a == b
            except RuntimeError:
                results["ref_paf_wall_s"] = None
                results["vs_baseline_paf"] = round(2400.0 / w, 3)

    # multi-sample `.list` accumulation (opt-in: writes two extra 4M-
    # read BAMs once). The reference's BamList_main pools depths from
    # every file into ONE whole-genome SiteInfo array set
    # (src/PanDepth.cpp:2029-3410); parity = pooled tables match.
    if os.environ.get("PANDEPTH_BENCH3GB_LIST") == "1" or \
            (only is not None and "list" in only):
        extra_bams = [os.path.join(BENCH_DIR, f"bench3gb_s{k}.bam")
                      for k in (2, 3)]
        if not all(os.path.exists(b) for b in extra_bams):
            _make("listextra")
        lst = os.path.join(BENCH_DIR, "bench3gb.list")
        with open(lst, "w") as fh:
            fh.write("\n".join([bam] + extra_bams) + "\n")
        results["list_files"] = 1 + len(extra_bams)
        results["list_reads"] = N_READS + 2 * (N_READS // 2)
        run_child(ours_argv(lst, out + "ol", []))  # warm
        w, r = best(lambda: run_child(ours_argv(lst, out + "ol", [])),
                    3)
        results["ours_list_wall_s"] = round(w, 3)
        results["ours_list_rss_mb"] = round(r, 1)
        if ref:
            w2, r2 = best(lambda: run_child(
                [ref, "-i", lst, "-o", out + "rl"]), 3)
            results["ref_list_wall_s"] = round(w2, 3)
            results["ref_list_rss_mb"] = round(r2, 1)
            results["vs_baseline_list"] = round(w2 / w, 3)
            results["parity_list"] = _gz_eq(
                out + "ol.chr.stat.gz", out + "rl.chr.stat.gz")

    # 10x scale check (opt-in: writes an 80M-read / ~600 MB BAM once):
    # chr mode at 10x the north-star read count, showing the margin
    # and the O(events) memory story at depth
    if os.environ.get("PANDEPTH_BENCH3GB_SCALE10X") == "1" or \
            (only is not None and "scale10x" in only):
        n10 = N_READS * 10
        bam10 = os.path.join(BENCH_DIR, f"bench3gb_{n10}.bam")
        if not os.path.exists(bam10):
            _make("scale10x")
        results["scale10x_reads"] = n10
        run_child(ours_argv(bam10, out + "o10", []))  # warm
        w, r = run_child(ours_argv(bam10, out + "o10", []))
        results["ours_scale10x_wall_s"] = round(w, 3)
        results["ours_scale10x_rss_mb"] = round(r, 1)
        if ref:
            w2, r2 = run_child([ref, "-i", bam10, "-o", out + "r10"])
            results["ref_scale10x_wall_s"] = round(w2, 3)
            results["ref_scale10x_rss_mb"] = round(r2, 1)
            results["vs_baseline_scale10x"] = round(w2 / w, 3)
            results["parity_scale10x"] = _gz_eq(
                out + "o10.chr.stat.gz", out + "r10.chr.stat.gz")

    # deep-coverage check (opt-in: writes a 240M-read / ~30x BAM
    # once): chr mode at 30x coverage, proving the streaming fold's
    # bounded one-shot RSS against the reference's flat O(genome)
    # arrays
    if os.environ.get("PANDEPTH_BENCH3GB_DEEP") == "1" or \
            (only is not None and "deep" in only):
        nd = N_READS * 30
        bamd = os.path.join(BENCH_DIR, f"bench3gb_deep_{nd}.bam")
        if not os.path.exists(bamd):
            sys.stderr.write(f"bench3gb: generating {nd}-read deep "
                             f"fixture (one-time, ~GBs)...\n")
            _make("deep")
        results["deep_reads"] = nd
        results["deep_read_len"] = 375
        run_child(ours_argv(bamd, out + "od", []))  # warm
        w, r = run_child(ours_argv(bamd, out + "od", []))
        results["ours_deep_wall_s"] = round(w, 3)
        results["ours_deep_rss_mb"] = round(r, 1)
        if ref:
            w2, r2 = run_child([ref, "-i", bamd, "-o", out + "rd"])
            results["ref_deep_wall_s"] = round(w2, 3)
            results["ref_deep_rss_mb"] = round(r2, 1)
            results["vs_baseline_deep"] = round(w2 / w, 3)
            results["parity_deep"] = _gz_eq(
                out + "od.chr.stat.gz", out + "rd.chr.stat.gz")

    # deep-coverage gene mode (opt-in): the streaming fold under a
    # BAI-ranged gene feed at 30x (168k CDS segments as registered
    # fold boundaries)
    if os.environ.get("PANDEPTH_BENCH3GB_DEEPGENE") == "1" or \
            (only is not None and "deepgene" in only):
        nd = N_READS * 30
        bamd = os.path.join(BENCH_DIR, f"bench3gb_deep_{nd}.bam")
        if not os.path.exists(bamd):
            _make("deep")
        run_child(ours_argv(bamd, out + "odg", ["-g", gff]))  # warm
        w, r = run_child(ours_argv(bamd, out + "odg", ["-g", gff]))
        results["ours_deepgene_wall_s"] = round(w, 3)
        results["ours_deepgene_rss_mb"] = round(r, 1)
        if ref:
            w2, r2 = run_child([ref, "-i", bamd, "-g", gff,
                                "-o", out + "rdg"])
            results["ref_deepgene_wall_s"] = round(w2, 3)
            results["ref_deepgene_rss_mb"] = round(r2, 1)
            results["vs_baseline_deepgene"] = round(w2 / w, 3)
            results["parity_deepgene"] = _gz_eq(
                out + "odg.gene.stat.gz", out + "rdg.gene.stat.gz")

    # deep multi-sample .list (opt-in): 400M pooled reads
    # (240M deep + 2 x 80M) through the per-contig split passes —
    # pooled depth cannot fold (sum across files), so this is the
    # bounded-memory path for the tool's namesake pangenome use
    if os.environ.get("PANDEPTH_BENCH3GB_DEEPLIST") == "1" or \
            (only is not None and "deeplist" in only):
        nd = N_READS * 30
        bamd = os.path.join(BENCH_DIR, f"bench3gb_deep_{nd}.bam")
        bam10 = os.path.join(BENCH_DIR, f"bench3gb_{N_READS * 10}.bam")
        if not os.path.exists(bamd):
            _make("deep")
        if not os.path.exists(bam10):
            _make("scale10x")
        lstd = os.path.join(BENCH_DIR, "bench3gb_deep.list")
        with open(lstd, "w") as fh:
            fh.write(f"{bamd}\n{bam10}\n{bam10}\n")
        results["deeplist_reads"] = nd + 2 * N_READS * 10
        w, r = run_child(ours_argv(lstd, out + "odl", []))
        results["ours_deeplist_wall_s"] = round(w, 3)
        results["ours_deeplist_rss_mb"] = round(r, 1)
        if ref:
            w2, r2 = run_child([ref, "-i", lstd, "-o", out + "rdl"])
            results["ref_deeplist_wall_s"] = round(w2, 3)
            results["ref_deeplist_rss_mb"] = round(r2, 1)
            results["vs_baseline_deeplist"] = round(w2 / w, 3)
            results["parity_deeplist"] = _gz_eq(
                out + "odl.chr.stat.gz", out + "rdl.chr.stat.gz")

    # deep-coverage -a site dump (opt-in): the per-contig split path
    # (run._run_site_split) holds O(max contig events) where the
    # reference is flat O(genome); one timed run per side (walls are
    # minutes)
    if os.environ.get("PANDEPTH_BENCH3GB_DEEPSITE") == "1" or \
            (only is not None and "deepsite" in only):
        nd = N_READS * 30
        bamd = os.path.join(BENCH_DIR, f"bench3gb_deep_{nd}.bam")
        if not os.path.exists(bamd):
            _make("deep")
        w, r = run_child(ours_argv(bamd, out + "ods", ["-a"]))
        results["ours_deepsite_wall_s"] = round(w, 3)
        results["ours_deepsite_rss_mb"] = round(r, 1)
        if ref:
            w2, r2 = run_child([ref, "-i", bamd, "-a",
                                "-o", out + "rds"])
            results["ref_deepsite_wall_s"] = round(w2, 3)
            results["ref_deepsite_rss_mb"] = round(r2, 1)
            results["vs_baseline_deepsite"] = round(w2 / w, 3)
            results["parity_deepsite"] = (
                _gz_eq(out + "ods.SiteDepth.gz",
                       out + "rds.SiteDepth.gz")
                and _gz_eq(out + "ods.chr.stat.gz",
                           out + "rds.chr.stat.gz"))

    # >4 Gb genome check (opt-in): a 15 Gb / 8-contig layout (int64
    # coordinate tier — wheat-scale pangenome shape) at the north-star
    # read count, proving the slabbed native finalize keeps one-shot
    # speed past the 32-bit coordinate width
    if os.environ.get("PANDEPTH_BENCH3GB_BIG") == "1" or \
            (only is not None and "big" in only):
        bamb = os.path.join(BENCH_DIR, "bench15gb_8000000.bam")
        if not os.path.exists(bamb):
            sys.stderr.write("bench3gb: generating 15 Gb-genome "
                             "fixture...\n")
            _make("big")
        results["big_genome_gb"] = 15
        results["big_reads"] = N_READS
        run_child(ours_argv(bamb, out + "ob", []))  # warm
        w, r = best(lambda: run_child(ours_argv(bamb, out + "ob", [])),
                    3)
        results["ours_big_wall_s"] = round(w, 3)
        results["ours_big_rss_mb"] = round(r, 1)
        if ref:
            w2, r2 = best(lambda: run_child(
                [ref, "-i", bamb, "-o", out + "rb"]), 3)
            results["ref_big_wall_s"] = round(w2, 3)
            results["ref_big_rss_mb"] = round(r2, 1)
            results["vs_baseline_big"] = round(w2 / w, 3)
            results["parity_big"] = _gz_eq(
                out + "ob.chr.stat.gz", out + "rb.chr.stat.gz")

    # serve mode: the multi-sample cost model (one resident warm
    # process; the reference's own protocol reruns the binary 10x per
    # config, reference/README.md:128-131). Same outputs, no per-run
    # start-up tax.
    os.environ["PANDEPTH_DAEMON"] = "1"
    os.environ["PANDEPTH_DAEMON_REQUIRE"] = "1"
    try:
      if want("daemon"):
        for mode, extra in (("chr", []), ("gene", ["-g", gff])):
            run_child(ours_argv(bam, out + "o", extra))  # warm daemon
            w, _ = best(lambda: run_child(ours_argv(bam, out + "o",
                                                    extra)), 3)
            results[f"ours_{mode}_daemon_wall_s"] = round(w, 3)
            results[f"ours_{mode}_daemon_reads_per_s"] = round(
                N_READS / w, 1)
            if f"ref_{mode}_wall_s" in results:
                results[f"vs_baseline_{mode}_daemon"] = round(
                    results[f"ref_{mode}_wall_s"] / w, 3)
        from pandepth_jax.serve import _request, sock_path
        st = _request(sock_path(), {"cmd": "stat"})
        if "rss_mb" in st:
            results["daemon_rss_mb"] = st["rss_mb"]
    except Exception as e:
        results["daemon_error"] = str(e)[:200]
    finally:
        from pandepth_jax.serve import stop_daemon
        stop_daemon()
        os.environ["PANDEPTH_DAEMON"] = "0"  # unset now means auto
        os.environ.pop("PANDEPTH_DAEMON_REQUIRE", None)

    # byte parity of the tables produced above (only when the base
    # section ran this invocation: stale files from an earlier run in
    # BENCH_DIR must not masquerade as fresh parity evidence)
    import gzip
    for mode, suffix in (("chr", ".chr.stat.gz"),
                         ("gene", ".gene.stat.gz"),
                         ("bed", ".bed.stat.gz"),
                         ("win", ".win.stat.gz")):
        if not ref or not want("base"):
            break
        with gzip.open(out + "o" + suffix, "rb") as fh:
            a = fh.read()
        with gzip.open(out + "r" + suffix, "rb") as fh:
            b = fh.read()
        results[f"parity_{mode}"] = a == b

    print(json.dumps(results))
    # merge-update into PANDEPTH_BENCH3GB_OUT when it is given:
    # sections are opt-in, so a partial rerun must not drop the
    # others' keys; same-platform results accumulate, others replace
    path = os.environ.get("PANDEPTH_BENCH3GB_OUT")
    if not path:
        return
    merged = results
    try:
        with open(path) as fh:
            old = json.load(fh)
        if old.get("platform") == results["platform"]:
            merged = {**old, **results}
    except (OSError, ValueError):
        pass
    with open(path, "w") as fh:
        json.dump(merged, fh, indent=1)
        fh.write("\n")


if __name__ == "__main__":
    if len(sys.argv) >= 3 and sys.argv[1] == "--make":
        os.makedirs(BENCH_DIR, exist_ok=True)
        what = sys.argv[2]
        if what == "main":
            _gen_main_fixture(
                os.path.join(BENCH_DIR, f"bench3gb_{N_READS}.bam"),
                os.path.join(BENCH_DIR, "bench3gb_genes.gff"),
                os.path.join(BENCH_DIR, "bench3gb_regions.bed"))
        elif what == "fasta":
            _write_fasta_fixture(os.path.join(BENCH_DIR, "bench3gb.fa"))
        elif what == "cram":
            _write_cram_fixture(
                os.path.join(BENCH_DIR, "bench3gb_2m.cram"))
        elif what == "paf":
            _write_paf_fixture(os.path.join(BENCH_DIR, "bench3gb.paf"))
        elif what == "scale10x":
            _gen_scale10x_fixture(os.path.join(
                BENCH_DIR, f"bench3gb_{N_READS * 10}.bam"))
        elif what == "deep":
            _gen_deep_fixture(os.path.join(
                BENCH_DIR, f"bench3gb_deep_{N_READS * 30}.bam"))
        elif what == "big":
            _gen_big_genome_fixture(os.path.join(
                BENCH_DIR, "bench15gb_8000000.bam"))
        elif what == "listextra":
            for k in (2, 3):
                _gen_list_extra_fixture(
                    os.path.join(BENCH_DIR, f"bench3gb_s{k}.bam"), k)
        else:
            sys.exit(f"unknown fixture: {what}")
        sys.exit(0)
    main()
