"""Randomized differential testing vs the reference binary: random
fixtures x random CLI configurations, byte-compared tables.

Each case generates its own genome shape, read mix and target files
from the seed, avoiding only the reference's known undefined-behavior
traps (documented in tests/fixtures.py and README)."""

import glob
import os
import random
import subprocess

import pytest

from tests.fixtures import drop_gc_column, gunzip_bytes, make_fasta

from pandepth_jax.cli import main as cli_main
from pandepth_jax.io.bam_writer import write_bam


def _gen_case(tmp: str, seed: int, fmt: str = "bam"):
    rng = random.Random(seed)
    n_contigs = rng.randint(1, 4)
    contigs = [(f"ctg{i}_{seed}", rng.randint(400, 9000))
               for i in range(n_contigs)]
    # occasionally a tiny contig (len<2 quirks)
    if rng.random() < 0.3:
        contigs.append((f"tiny{seed}", rng.randint(1, 3)))
    names = [c[0] for c in contigs]
    lengths = [c[1] for c in contigs]

    n = rng.randint(0, 900)
    recs = []
    for _ in range(n):
        tid = rng.randrange(len(contigs))
        clen = contigs[tid][1]
        pos = rng.randrange(0, max(clen, 1))
        kind = rng.random()
        if kind < 0.5:
            cigar = f"{rng.randint(1, 120)}M"
        elif kind < 0.65:
            cigar = (f"{rng.randint(1, 30)}M{rng.randint(1, 10)}D"
                     f"{rng.randint(1, 30)}M")
        elif kind < 0.75:
            cigar = (f"{rng.randint(1, 15)}S{rng.randint(1, 40)}M"
                     f"{rng.randint(1, 300)}N{rng.randint(1, 40)}M")
        elif kind < 0.85:
            cigar = (f"{rng.randint(1, 20)}={rng.randint(1, 9)}X"
                     f"{rng.randint(1, 20)}=")
        elif kind < 0.95:
            cigar = (f"{rng.randint(1, 9)}I{rng.randint(1, 50)}M"
                     f"{rng.randint(1, 5)}P{rng.randint(1, 20)}M")
        else:
            cigar = "*"
        flag = 0
        r = rng.random()
        if r < 0.08:
            flag |= rng.choice([0x100, 0x200, 0x400, 0x800])
        if cigar == "*":
            flag = 4
        if rng.random() < 0.5:
            flag |= 0x10
        mapq = rng.choice([0, 1, 5, 20, 40, 60, 254])
        # stay below +100 overhang (multi-file heap bug) for safety
        if cigar != "*":
            from pandepth_jax.io.bam_writer import cigar_str_to_ops, \
                ref_span
            if pos + ref_span(cigar_str_to_ops(cigar)) > clen + 90:
                continue
        recs.append((tid, pos, flag, mapq, cigar))
    if rng.random() < 0.05:
        # long-CIGAR read (>2^16-1 ops, stored via CG:B,I): needs its
        # own big contig so the span stays inside the sequence
        contigs.append((f"big{seed}", 170_000))
        names.append(contigs[-1][0])
        lengths.append(contigs[-1][1])
        pairs = rng.randint(32_769, 40_000)
        recs.append((len(contigs) - 1, rng.randint(0, 80_000),
                     0x10 if rng.random() < 0.5 else 0,
                     rng.choice([0, 30, 60]), "1M1D" * pairs))
    recs.sort(key=lambda x: (x[0], x[1]))
    if fmt in ("sam", "sam.gz"):
        # same records as SAM text (seq "*" keeps htslib's seq-vs-CIGAR
        # length check out of play, like the reference's own test data)
        bam = os.path.join(tmp, f"f{seed}.{fmt}")
        lines = []
        if rng.random() < 0.7:
            lines.append("@HD\tVN:1.6\tSO:coordinate")
        for nm, ln in zip(names, lengths):
            lines.append(f"@SQ\tSN:{nm}\tLN:{ln}")
        for k, (tid, pos, flag, mapq, cigar) in enumerate(recs):
            lines.append(f"r{k}\t{flag}\t{names[tid]}\t{pos + 1}\t"
                         f"{mapq}\t{cigar}\t*\t0\t0\t*\t*")
        data = ("\n".join(lines) + "\n").encode()
        if fmt == "sam.gz":
            import gzip as _gz

            with _gz.open(bam, "wb") as fh:
                fh.write(data)
        else:
            with open(bam, "wb") as fh:
                fh.write(data)
    elif fmt.startswith("cram"):
        from pandepth_jax.io.cram_writer import write_cram

        bam = os.path.join(tmp, f"f{seed}.cram")
        write_cram(bam, names, lengths, recs,
                   index=fmt == "cram+crai")
    else:
        bam = os.path.join(tmp, f"f{seed}.bam")
        write_bam(bam, names, lengths, recs,
                  make_index=rng.random() < 0.7)

    # random target mode
    args = []
    gc_risky = False
    mode = rng.choice(["chr", "win", "bed", "gff", "gtf"])
    if mode == "win":
        w = rng.choice([1, 7, 50, 149, 150, 500, 20000])
        if rng.random() < 0.3:
            # make (len - 1) % w == 0 likely: the reference drops the
            # final 1-base window then (End+2 loop quirk, see
            # targets/windows.py) — keep that boundary hot in the fuzz
            t = rng.randrange(len(contigs))
            for k in (2, 3, 4, 5):
                if (lengths[t] - 1) % k == 0 and (lengths[t] - 1) // k >= 150:
                    w = (lengths[t] - 1) // k
                    break
        args += ["-w", str(w)]
    elif mode == "bed":
        bed = os.path.join(tmp, f"f{seed}.bed")
        with open(bed, "w") as fh:
            for _ in range(rng.randint(1, 12)):
                t = rng.randrange(len(contigs))
                s = rng.randint(0, max(lengths[t] - 1, 1))
                e = s + rng.randint(0, 400)
                row = f"{names[t]}\t{s}\t{e}"
                if rng.random() < 0.5:
                    row += f"\tid{rng.randint(0, 5)}"
                fh.write(row + "\n")
            if rng.random() < 0.3:
                fh.write(f"{names[0]}\t50\t20\n")      # start > end
            if rng.random() < 0.3:
                fh.write(f"nochr\t1\t10\n")            # unknown contig
        args += ["-b", bed]
        gc_risky = True  # regions may overhang the sequence (ref UB)
    elif mode in ("gff", "gtf"):
        tf = os.path.join(tmp, f"f{seed}.{mode}")
        feature = rng.choice(["CDS", "exon"])
        with open(tf, "w") as fh:
            for g in range(rng.randint(1, 8)):
                t = rng.randrange(len(contigs))
                base = rng.randint(1, max(lengths[t] - 50, 2))
                for _ in range(rng.randint(1, 4)):
                    s = base + rng.randint(0, 200)
                    e = min(s + rng.randint(0, 300), lengths[t])
                    if e < s:
                        continue
                    if mode == "gff":
                        fh.write(f"{names[t]}\tsrc\t{feature}\t{s}\t{e}"
                                 f"\t.\t+\t0\tID=c{g};Parent=g{g}\n")
                    else:
                        fh.write(f'{names[t]}\tsrc\t{feature}\t{s}\t{e}'
                                 f'\t.\t+\t0\tgene_id "g{g}"; '
                                 f'transcript_id "t{g}";\n')
        args += ["-g", tf, "-f", feature]

    if rng.random() < 0.4:
        args += ["-q", str(rng.choice([0, 1, 10, 30, 255]))]
    if rng.random() < 0.4:
        args += ["-d", str(rng.choice([1, 2, 5, 100]))]
    if rng.random() < 0.3:
        args += ["-x", str(rng.choice([0, 4, 256, 1796, 3844]))]
    if rng.random() < 0.25:
        args += ["-s"]
    if rng.random() < 0.3:
        args += ["-a"]
    use_gc = rng.random() < 0.3
    if use_gc:
        fa = os.path.join(tmp, f"f{seed}.fa")
        make_fasta(fa, contigs, seed=seed)
        args += ["-c", "-r", fa]
    small_win = mode == "win" and int(args[1]) < 150
    strip_gc = use_gc and (small_win or gc_risky)
    return bam, args, strip_gc


def _run_case(tmp: str, oracle: str, seed: int, fmt: str = "bam"):
    bam, args, strip_gc = _gen_case(tmp, seed, fmt=fmt)
    ref_out = os.path.join(tmp, f"ref{seed}")
    our_out = os.path.join(tmp, f"ours{seed}")
    rr = subprocess.run([oracle, "-i", bam, "-o", ref_out] + args,
                        capture_output=True)
    if rr.returncode != 0:
        return "oracle-crash"
    rc = cli_main(["pandepth", "-i", bam, "-o", our_out] + args)
    ref_files = sorted(glob.glob(ref_out + "*.gz"))
    if not ref_files:
        # the reference rejected the inputs (e.g. an empty GFF) and
        # wrote nothing; we must also have produced nothing
        assert not glob.glob(our_out + "*.gz"), (seed, args)
        return "both-rejected"
    assert rc == 0, (seed, args)
    for rf in ref_files:
        of = rf.replace(f"ref{seed}", f"ours{seed}", 1)
        assert os.path.exists(of), (seed, args, rf)
        a, b = gunzip_bytes(rf), gunzip_bytes(of)
        if strip_gc:
            a, b = drop_gc_column(a), drop_gc_column(b)
        assert a == b, (seed, args, os.path.basename(rf))
    return "ok"


@pytest.mark.parametrize("seed", range(40))
def test_fuzz_case(tmp_path, oracle_bin, seed):
    _run_case(str(tmp_path), oracle_bin, seed)


@pytest.mark.parametrize("seed", range(16))
def test_fuzz_case_pure_python(tmp_path, oracle_bin, seed,
                               monkeypatch):
    """PANDEPTH_NO_NATIVE=1 runs the pure-Python decoders and the
    vectorized region cursor (the only path on hosts without g++) —
    same differential contract as the native path."""
    monkeypatch.setenv("PANDEPTH_NO_NATIVE", "1")
    _run_case(str(tmp_path), oracle_bin, 500 + seed)


@pytest.mark.parametrize("seed", range(16))
def test_fuzz_case_host_engine(tmp_path, oracle_bin, seed,
                               monkeypatch):
    """PANDEPTH_HOST_FINALIZE=1 runs the jax-free host engine
    (device/host_engine.py) — same differential contract; mixes BAM
    and the other containers so the host sweep sees every decode
    path in the default suite (the extended bursts run thousands)."""
    monkeypatch.setenv("PANDEPTH_HOST_FINALIZE", "1")
    fmt = ("bam", "bam", "sam.gz", "cram")[seed % 4]
    _run_case(str(tmp_path), oracle_bin, 1300 + seed, fmt=fmt)


@pytest.mark.parametrize("seed", range(16))
def test_fuzz_case_stream_fold(tmp_path, oracle_bin, seed,
                               monkeypatch):
    """The deep-coverage streaming fold forced hot (a fold per staged
    window, PANDEPTH_FOLD_PAIRS=1) on the host engine — same
    differential contract; run.py's election gates the fold off for
    the generated cases it can't serve (site dumps, mode 6,
    multi-file, unsorted), so this burst also proves the gate."""
    monkeypatch.setenv("PANDEPTH_HOST_FINALIZE", "1")
    monkeypatch.setenv("PANDEPTH_FOLD_PAIRS", "1")
    _run_case(str(tmp_path), oracle_bin, 2600 + seed)


@pytest.mark.parametrize("seed", range(16))
def test_fuzz_case_formats(tmp_path, oracle_bin, seed):
    """The same generated records spun through the other container
    formats (SAM text, gzipped SAM, CRAM, indexed CRAM) — exercises
    every decode path against the oracle, not just BGZF BAM."""
    fmt = ("sam", "sam.gz", "cram", "cram+crai")[seed % 4]
    _run_case(str(tmp_path), oracle_bin, 900 + seed, fmt=fmt)


def _gen_multi_case(tmp: str, seed: int):
    """Multi-file .list (BAM or PAF) or single CRAM, random filters."""
    rng = random.Random(10000 + seed)
    contigs = [(f"m{i}_{seed}", rng.randint(500, 6000))
               for i in range(rng.randint(1, 3))]
    names = [c[0] for c in contigs]
    lengths = [c[1] for c in contigs]
    kind = rng.choice(["bamlist", "paflist", "cram"])

    def rand_recs(file_seed):
        r2 = random.Random(file_seed)
        recs = []
        for _ in range(r2.randint(0, 400)):
            tid = r2.randrange(len(contigs))
            clen = contigs[tid][1]
            pos = r2.randrange(0, max(clen - 60, 1))
            ln = r2.randint(1, 60)
            from pandepth_jax.io.bam_writer import cigar_str_to_ops, \
                ref_span
            cigar = f"{ln}M" if r2.random() < 0.7 else \
                f"{ln}M{r2.randint(1, 9)}D{r2.randint(1, 30)}M"
            if pos + ref_span(cigar_str_to_ops(cigar)) > clen + 80:
                continue
            flag = 0x100 if r2.random() < 0.08 else 0
            recs.append((tid, pos, flag,
                         r2.choice([0, 10, 30, 60]), cigar))
        recs.sort(key=lambda x: (x[0], x[1]))
        return recs

    args = []
    if kind == "cram":
        from pandepth_jax.io.cram_writer import write_cram

        path = os.path.join(tmp, f"m{seed}.cram")
        write_cram(path, names, lengths, rand_recs(seed * 7 + 1))
        inp = path
    elif kind == "bamlist":
        paths = []
        for k in range(rng.randint(2, 3)):
            p = os.path.join(tmp, f"m{seed}_{k}.bam")
            write_bam(p, names, lengths, rand_recs(seed * 7 + k),
                      make_index=rng.random() < 0.7)
            paths.append(p)
        inp = os.path.join(tmp, f"m{seed}.list")
        with open(inp, "w") as fh:
            fh.write("\n".join(paths) + "\n")
    else:
        from tests.test_paf import make_paf

        paths = []
        for k in range(rng.randint(1, 3)):
            p = os.path.join(tmp, f"m{seed}_{k}.paf")
            make_paf(p, contigs, n=rng.randint(10, 300),
                     seed=seed * 7 + k)
            paths.append(p)
        if len(paths) == 1:
            inp = paths[0]
        else:
            inp = os.path.join(tmp, f"m{seed}.list")
            with open(inp, "w") as fh:
                fh.write("\n".join(paths) + "\n")

    if rng.random() < 0.5:
        args += ["-w", str(rng.choice([50, 200, 1000]))]
    elif rng.random() < 0.5:
        bed = os.path.join(tmp, f"m{seed}.bed")
        with open(bed, "w") as fh:
            # the PAF/multi-file engines allocate only 500/100 depth
            # cells for contigs WITHOUT regions but still write reads
            # into them (reference heap corruption) — every contig with
            # reads must get at least one region
            for t in range(len(contigs)):
                s = rng.randint(1, max(lengths[t] - 10, 2))
                e = min(s + rng.randint(0, 300), lengths[t] + 80)
                fh.write(f"{names[t]}\t{s}\t{e}\tr{rng.randint(0, 3)}\n")
            for _ in range(rng.randint(0, 4)):
                t = rng.randrange(len(contigs))
                s = rng.randint(1, max(lengths[t] - 10, 2))
                e = min(s + rng.randint(0, 300), lengths[t] + 80)
                fh.write(f"{names[t]}\t{s}\t{e}\tr{rng.randint(0, 3)}\n")
        args += ["-b", bed]
    if rng.random() < 0.4:
        args += ["-q", str(rng.choice([10, 30]))]
    if rng.random() < 0.3:
        args += ["-d", "2"]
    if rng.random() < 0.3:
        args += ["-x", str(rng.choice([0, 256, 1796]))]
    if rng.random() < 0.25:
        args += ["-a"]
    return inp, args


@pytest.mark.parametrize("seed", range(20))
def test_fuzz_multi_paf_cram(tmp_path, oracle_bin, seed):
    tmp = str(tmp_path)
    inp, args = _gen_multi_case(tmp, seed)
    ref_out = os.path.join(tmp, "refm")
    our_out = os.path.join(tmp, "oursm")
    rr = subprocess.run([oracle_bin, "-i", inp, "-o", ref_out] + args,
                        capture_output=True)
    if rr.returncode != 0:
        pytest.skip(f"oracle crashed: seed {seed}")
    rc = cli_main(["pandepth", "-i", inp, "-o", our_out] + args)
    ref_files = sorted(glob.glob(ref_out + "*.gz"))
    if not ref_files:
        assert not glob.glob(our_out + "*.gz"), (seed, args)
        return
    assert rc == 0, (seed, args)
    for rf in ref_files:
        of = rf.replace("refm", "oursm", 1)
        assert os.path.exists(of), (seed, args, rf)
        assert gunzip_bytes(rf) == gunzip_bytes(of), \
            (seed, args, os.path.basename(rf))
