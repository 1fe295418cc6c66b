"""Chip smoke test: pandepth's main path once on an NVIDIA GPU, checked
against the jax-free host engine.

    python3 chip_smoke.py                # one card
    python3 chip_smoke.py --four-cards   # the multi-device path only
    python3 chip_smoke.py --feed-timing  # raw vs encoded feed, timed
    python3 chip_smoke.py --cpu-rehearsal [--four-cards]
                                         # tiny sizes on the CPU backend

Run it from the root of a checkout. The parent process never imports
jax: every phase that touches the card is a subprocess, run one at a
time, with ``JAX_PLATFORMS=cuda`` so a broken CUDA plug-in fails the
run instead of falling back to the CPU. Any failed phase ends the run
with a non-zero exit and no result line.

The reference for every table is the jax-free ``HostCoverageEngine``
(``PANDEPTH_HOST_FINALIZE=1 JAX_PLATFORMS=cpu``): native radix sort
plus one sweep, sharing no code with ``device/sweep.py``. Everything
compared is integer (positions, depths, covered-base and depth sums);
there is no matrix product anywhere, so TF32 cannot enter, and every
comparison is exact (tolerance zero).

Phases (one card):

0. environment: card name and power limit (nvidia-smi), jax/jaxlib
   versions, compile-cache directory, native library and its inflate
   backend; fails unless jax reports a ``gpu`` device.
1. fixtures from fixed seeds (bench3gb.py's generators): the
   north-star shape (12 x 250 Mb contigs, 8M reads with BAI, the
   ~168k-CDS GFF and the matching BED); a 20 Mb genome for the
   heavy-output modes (FASTA, CRAM, PAF, a 3-file .list); a 15 Gb
   genome for the int64 coordinate tier.
2. the device programs at real widths against their numpy twins
   (device/hosteval.py): ~15M events on the uint32 tier from the real
   encoded feed, ~1M on the int64 tier; searchsorted timings.
3. the CLI end to end, cold (``PANDEPTH_DAEMON=0 ./pandepth ... -v``),
   every table byte-identical to the host engine's.
4. the warm daemon (on the encoded feed, ``PANDEPTH_ENC=1``, so both
   feed formats run on the card), then a direct run while it is
   resident; the daemon is stopped in a ``finally`` and no process of
   ours may be left on the card.

``--feed-timing`` runs only phase 0, the main fixture and the
feed-format comparison behind the default feed: cold chr and gene runs
with the raw feed (``PANDEPTH_ENC=0``), the encoded feed
(``PANDEPTH_ENC=1``) and the encoded feed without its finalize warm-up
(``PANDEPTH_ENC=1 PANDEPTH_WARM=0``), in alternating order after one
untimed run each, every table checked against the host engine.

Every device run gets a daemon socket inside the work directory
(``PANDEPTH_DAEMON_SOCK``): a direct run stops the daemon on its
socket, and this one belongs to this run alone.

``--four-cards`` runs only the multi-device path: the CLI with four
visible cards (``ShardedCoverageEngine``) in chr, gene, bed and win
modes, and ``python -m pandepth_jax.sharding.launch`` with four
ranks, one card each, over a 4-file .list (the all_to_all exchange
through NCCL).

Cut to fit about 20 minutes on the card's host: no deep-coverage
fixture, one 20 Mb genome (not the 3 Gb one) for ``-a``, GC, CRAM,
PAF and ``.list``, 200k-read CRAM and list samples, and 500k reads on
the 15 Gb genome. The last line of standard output is one JSON
object: ``{"ok": true, "device": {"platform", "kind", "count"}}``.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import shutil
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
LAUNCHER = os.path.join(REPO, "pandepth")
WORK = os.path.join(REPO, ".smoke")

# fixture sizes: "full" on the card, "tiny" for the CPU rehearsal
SCALES = {
    "full": dict(main_reads=8_000_000, main_contigs=12,
                 main_len=250_000_000, main_genes=33_688,
                 small_reads=400_000, small_contigs=4,
                 small_len=5_000_000, small_genes=2_000,
                 side_reads=200_000, big_reads=500_000,
                 four_extra_reads=4_000_000),
    "tiny": dict(main_reads=20_000, main_contigs=3, main_len=2_000_000,
                 main_genes=300, small_reads=20_000, small_contigs=2,
                 small_len=1_000_000, small_genes=100,
                 side_reads=10_000, big_reads=20_000,
                 four_extra_reads=10_000),
}
# searchsorted timing sizes: a chr run, the 4,096-query threshold the
# code used to carry, a gene/bed run (~168k boundaries), -w 500000
# scale and beyond
SEARCH_SIZES = (256, 4096, 168_000, 1_000_000)
SEARCH_METHODS = ("scan", "scan_unrolled", "sort")
# feed-format comparison: variants, timed rounds per variant and mode
FEED_VARIANTS = (("raw", dict(PANDEPTH_ENC=0)),
                 ("encoded", dict(PANDEPTH_ENC=1)),
                 ("encoded, no warm-up", dict(PANDEPTH_ENC=1,
                                              PANDEPTH_WARM=0)))
FEED_ROUNDS = 4


class SmokeError(RuntimeError):
    pass


def say(msg: str) -> None:
    print(msg, flush=True)


# ----------------------------------------------------------------------
# helpers shared by the parent and the tests (no jax)

def gz_equal(a: str, b: str, chunk: int = 1 << 24) -> bool:
    """Decompressed-byte equality, streamed (SiteDepth dumps are
    hundreds of MB decompressed)."""
    with gzip.open(a, "rb") as fa, gzip.open(b, "rb") as fb:
        while True:
            x, y = fa.read(chunk), fb.read(chunk)
            if x != y:
                return False
            if not x:
                return True


def compare_tables(ref_prefix: str, got_prefix: str) -> list:
    """Mismatches between the ``<prefix>.*.gz`` tables of two runs:
    every table of the reference run must exist in the other run and
    decompress to the same bytes, and the other run may write no
    table the reference did not. Returns a list of messages (empty
    when identical); a run that wrote no table at all is a
    mismatch."""
    ref = {p[len(ref_prefix):] for p in glob.glob(ref_prefix + ".*.gz")}
    got = {p[len(got_prefix):] for p in glob.glob(got_prefix + ".*.gz")}
    if not ref:
        return [f"reference run wrote no table at {ref_prefix}.*.gz"]
    bad = [f"missing {got_prefix}{s}" for s in sorted(ref - got)]
    bad += [f"unexpected {got_prefix}{s}" for s in sorted(got - ref)]
    bad += [f"differs: {got_prefix}{s}" for s in sorted(ref & got)
            if not gz_equal(ref_prefix + s, got_prefix + s)]
    return bad


def check_device(info: dict, platform: str, count: int = 0) -> None:
    """Raise unless jax reported ``platform`` devices (``count`` of
    them, when given)."""
    if info.get("platform") != platform:
        raise SmokeError(f"jax platform is {info.get('platform')!r}, "
                         f"expected {platform!r}")
    if count and info.get("count") != count:
        raise SmokeError(f"jax sees {info.get('count')} devices, "
                         f"expected {count}")


def _clean_env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PANDEPTH_")}
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _child(phase: str, env: dict, *args, timeout: float = 900):
    """Run one phase of this script in a subprocess; its stdout is
    echoed and its last line parsed as JSON."""
    cmd = [sys.executable, os.path.abspath(__file__), "--phase", phase,
           *map(str, args)]
    r = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                       text=True, timeout=timeout)
    lines = r.stdout.strip().splitlines()
    for line in lines[:-1]:
        say(f"  {line}")
    if r.returncode != 0:
        sys.stderr.write(r.stderr[-6000:])
        raise SmokeError(f"phase {phase} exited {r.returncode}")
    return json.loads(lines[-1]) if lines else {}


# ----------------------------------------------------------------------
# child phases (run with ``--phase``)

def phase_probe() -> dict:
    from pandepth_jax import boot

    jax = boot.configure_jax()
    import jaxlib

    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d), "jax": jax.__version__,
            "jaxlib": jaxlib.__version__,
            "cache_dir": jax.config.jax_compilation_cache_dir}


def phase_make(what: str, d: str, scale: str) -> dict:
    """Generate one fixture set into ``d`` (bench3gb.py's generators)."""
    from pandepth_jax import boot  # noqa: F401  (THP off before numpy)

    import bench3gb as g

    s = SCALES[scale]
    t0 = time.perf_counter()
    if what == "main":
        g._gen_main_fixture(f"{d}/main.bam", f"{d}/main.gff",
                            f"{d}/main.bed", n_reads=s["main_reads"],
                            n_contigs=s["main_contigs"],
                            contig_len=s["main_len"],
                            n_genes=s["main_genes"])
    elif what == "small":
        kw = dict(n_contigs=s["small_contigs"],
                  contig_len=s["small_len"])
        g._gen_main_fixture(f"{d}/small.bam", f"{d}/small.gff",
                            f"{d}/small.bed", n_reads=s["small_reads"],
                            n_genes=s["small_genes"], **kw)
        g._write_fasta_fixture(f"{d}/small.fa", **kw)
        g._write_cram_fixture(f"{d}/small.cram", n=s["side_reads"], **kw)
        g._write_paf_fixture(f"{d}/small.paf", n=s["small_reads"], **kw)
        for k in (2, 3):
            g._gen_list_extra_fixture(f"{d}/small_s{k}.bam", k,
                                      n=s["side_reads"], **kw)
        with open(f"{d}/small.list", "w") as fh:
            fh.write("".join(f"{d}/{b}\n" for b in (
                "small.bam", "small_s2.bam", "small_s3.bam")))
    elif what == "big":
        g._gen_big_genome_fixture(f"{d}/big.bam", n=s["big_reads"])
    elif what.startswith("extra"):
        k = int(what[5:])
        g._gen_list_extra_fixture(f"{d}/main_s{k}.bam", k,
                                  n=s["four_extra_reads"],
                                  n_contigs=s["main_contigs"],
                                  contig_len=s["main_len"])
    else:
        raise SmokeError(f"unknown fixture {what}")
    return {"fixture": what, "seconds": time.perf_counter() - t0}


def _pull_windows(bam: str):
    """Every encoded window of ``bam``, pulled by the CLI's own
    _EncPuller at the production window sizes."""
    from pandepth_jax.io.native import NativeBamStream
    from pandepth_jax.run import _EncPuller, _enc_caps

    r = NativeBamStream(bam, 1796, -1)
    p = _EncPuller(r, *_enc_caps())
    wins = []
    while not p.eof:
        w = p.next()
        if w is not None:
            wins.append(w)
    r.close()
    return wins


def _group_last(pos):
    """Indices of the last event at each distinct position: depth and
    the prefix integrals there do not depend on how the sort ordered
    tied events."""
    import numpy as np

    pos = np.asarray(pos)
    return np.flatnonzero(np.append(pos[1:] != pos[:-1], True))


def _kernel_case(name: str, bam: str, n_seg: int, rng, timings: bool,
                 out: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pandepth_jax.device import hosteval as he
    from pandepth_jax.device import sweep
    from pandepth_jax.device.engine import CoverageEngine
    from pandepth_jax.device.layout import GenomeLayout
    from pandepth_jax.io.bam import read_bam_header

    hdr = read_bam_header(bam)
    layout = GenomeLayout(np.asarray(hdr.lengths, np.int64))
    pdt = he.pos_dtype_for(layout.total)
    wins = _pull_windows(bam)
    starts, ends = zip(*(he.decode_enc_host(dd, ll, excd, excl, base, n)
                         for n, dd, ll, excd, excl, base in wins))
    s = np.concatenate(starts)
    e = np.concatenate(ends)
    pos = np.concatenate([s, e]).astype(pdt)
    delta = np.concatenate([np.ones(s.shape[0], np.int32),
                            -np.ones(e.shape[0], np.int32)])
    n_ev = pos.shape[0]
    say(f"{name}: {len(wins)} encoded windows, {n_ev} events, "
        f"genome {layout.total} bp, positions {np.dtype(pdt).name}")

    # host twin: any stable sort + cumsum + derive_integrals
    order = np.argsort(pos, kind="stable")
    hpos = pos[order].astype(np.int64)
    hdep = np.cumsum(delta[order], dtype=np.int64).astype(np.int32)
    hsweep = he.derive_integrals(hpos, hdep, 1)
    last = _group_last(hpos)

    # Q_cov/Q_sum at every event position and one past it: the
    # integrals a sweep state answers, whatever its tie order or the
    # depth-neutral padding events it carries
    xq = np.unique(hpos)
    xq = np.concatenate([xq, xq[xq < xq[-1]] + 1])
    want_q = he.host_q_eval(hsweep, 1, xq,
                            np.searchsorted(hpos, xq, side="left"))

    def same_q(tag, st):
        dsw = tuple(np.asarray(a).astype(np.int64) for a in st[:4])
        got_q = he.host_q_eval(dsw, 1, xq,
                               np.searchsorted(dsw[0], xq, side="left"))
        if not (np.array_equal(got_q[0], want_q[0])
                and np.array_equal(got_q[1], want_q[1])):
            raise SmokeError(f"{name}: {tag} integrals differ")

    def same_state(tag, st):
        # no padding here: element for element, at each position's
        # last event (tied events may sort in any order)
        dpos = np.asarray(st[0]).astype(np.int64)
        ok = np.array_equal(dpos, hpos)
        for k in (1, 2, 3):
            ok &= np.array_equal(np.asarray(st[k])[last],
                                 hsweep[k][last])
        if not ok:
            raise SmokeError(f"{name}: {tag} sweep state differs")
        same_q(tag, st)

    st = sweep.sort_events(jnp.asarray(pos), jnp.asarray(delta))
    same_state("sort_events", st)

    # segments over the genome; a query's rank is #{events < x}
    lo = np.sort(rng.randint(0, layout.total - 10_000, n_seg))
    hi = lo + rng.randint(1, 10_000, n_seg)
    lo, hi = lo.astype(pdt), hi.astype(pdt)

    def host_pair(lo, hi):
        q = [he.host_q_eval(hsweep, 1, x.astype(np.int64),
                            np.searchsorted(hpos, x.astype(np.int64),
                                            side="left"))
             for x in (lo, hi)]
        return q[1][0] - q[0][0], q[1][1] - q[0][1]

    want = host_pair(lo, hi)
    md = jnp.int32(1)
    for m in SEARCH_METHODS:
        got = sweep.eval_pair(st[0], st[1], st[2], st[3], md,
                              jnp.asarray(lo), jnp.asarray(hi), method=m)
        if not (np.array_equal(np.asarray(got[0]), want[0])
                and np.array_equal(np.asarray(got[1]), want[1])):
            raise SmokeError(f"{name}: eval_pair(method={m}) differs")
    out[f"{name}_eval_pair_methods_exact"] = list(SEARCH_METHODS)

    fin = sweep.finalize_segments(jnp.asarray(pos), jnp.asarray(delta),
                                  jnp.asarray(lo), jnp.asarray(hi))
    if not (np.array_equal(np.asarray(fin[0]), want[0])
            and np.array_equal(np.asarray(fin[1]), want[1])):
        raise SmokeError(f"{name}: finalize_segments differs")
    same_state("finalize_segments", fin[2:6])

    # finalize_encoded through the engine's own block stacking
    eng = CoverageEngine(layout)
    for w in wins:
        eng.add_encoded_window(*w)
    seg_tid = np.searchsorted(layout.offsets, lo.astype(np.int64),
                              side="right") - 1
    s1 = lo.astype(np.int64) - layout.offsets[seg_tid] + 1
    e1 = hi.astype(np.int64) - layout.offsets[seg_tid]
    got = eng.segment_stats(seg_tid, s1, e1, keep_state=True)
    clo, chi = he.clamp_segments(layout, seg_tid, s1, e1)
    want_c = host_pair(clo, chi)
    if not (np.array_equal(got.cover, want_c[0])
            and np.array_equal(got.depth_sum, want_c[1])):
        raise SmokeError(f"{name}: finalize_encoded differs")
    same_q("finalize_encoded", eng._state)
    say(f"{name}: sort_events, eval_pair x{len(SEARCH_METHODS)}, "
        f"finalize_segments, finalize_encoded exact over {n_seg} "
        f"segments")

    if not timings:
        return
    pos_s = st[0]
    for nq in SEARCH_SIZES:
        x = jnp.asarray(np.sort(rng.randint(
            0, layout.total, nq)).astype(pdt))
        row = {}
        for m in SEARCH_METHODS:
            f = jax.jit(lambda p, q, m=m: jnp.searchsorted(
                p, q, side="left", method=m))
            f(pos_s, x).block_until_ready()
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                f(pos_s, x).block_until_ready()
                ts.append(time.perf_counter() - t0)
            row[m] = sorted(ts)[2] * 1e3
        out[f"searchsorted_ms_{nq}"] = row
        say(f"searchsorted over {n_ev} events, {nq} queries (median "
            f"of 5, ms): " + ", ".join(f"{m}={v:.3f}"
                                       for m, v in row.items()))


def phase_kernels(d: str) -> dict:
    import numpy as np

    from pandepth_jax import boot

    jax = boot.configure_jax()
    out = {"device": jax.devices()[0].device_kind}
    rng = np.random.RandomState(11)
    _kernel_case("main fixture", f"{d}/main.bam", 84_000, rng, True,
                 out)
    _kernel_case("15 Gb fixture", f"{d}/big.bam", 20_000, rng, False,
                 out)
    return out


# ----------------------------------------------------------------------
# parent

class Smoke:
    def __init__(self, rehearsal: bool, four: bool, feed: bool = False):
        self.rehearsal = rehearsal
        self.four = four
        self.feed = feed
        self.sock = os.path.join(WORK, "d.sock")
        self.scale = "tiny" if rehearsal else "full"
        self.plat = "cpu" if rehearsal else "gpu"
        self.jax_plat = "cpu" if rehearsal else "cuda"
        self.fix = os.path.join(WORK, "fixtures")
        self.out = os.path.join(WORK, "out")
        self.card = "cpu rehearsal"
        self.n_dev = 4 if four else 1
        # CPU-sized encoded windows: the production 2^19-pair blocks
        # make a tiny CPU run sort mostly padding (tables unaffected)
        self.small_enc = (dict(PANDEPTH_ENC_CAP=1 << 14,
                               PANDEPTH_ENC_EXC=1 << 11)
                          if rehearsal else {})

    def device_env(self, **extra) -> dict:
        env = _clean_env(JAX_PLATFORMS=self.jax_plat,
                         PANDEPTH_DAEMON_SOCK=self.sock, **self.small_enc,
                         **extra)
        if self.rehearsal and self.four:
            env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_"
                                "force_host_platform_device_count=4")
        return env

    def host_env(self) -> dict:
        return _clean_env(JAX_PLATFORMS="cpu", PANDEPTH_HOST_FINALIZE=1,
                          PANDEPTH_DAEMON=0, PANDEPTH_DAEMON_SOCK=self.sock,
                          **self.small_enc)

    # -- phase 0
    def environment(self) -> dict:
        if self.rehearsal:
            say("nvidia-smi: not queried (CPU rehearsal)")
        else:
            r = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"],
                capture_output=True, text=True, timeout=60, check=True)
            self.card = r.stdout.strip().splitlines()[0]
            say(f"card: {self.card}")
        info = _child("probe", self.device_env(), timeout=300)
        check_device(info, self.plat, self.n_dev)
        say(f"jax {info['jax']}, jaxlib {info['jaxlib']}, "
            f"{info['count']} x {info['kind']} ({info['platform']}), "
            f"compile cache {info['cache_dir']}")
        from pandepth_jax.io import native

        lib = native.load_library()
        if lib is None:
            raise SmokeError(f"libpancov_io did not load: "
                             f"{native._build_error}")
        say(f"libpancov_io: loaded, inflate backend "
            f"{lib.pancov_inflate_backend().decode()}")
        return info

    # -- phase 1
    def fixtures(self) -> None:
        shutil.rmtree(WORK, ignore_errors=True)
        os.makedirs(self.fix)
        os.makedirs(self.out)
        sets = (["main", "extra2", "extra3", "extra4"] if self.four
                else ["main"] if self.feed else ["main", "small", "big"])
        t0 = time.perf_counter()
        # independent generators run side by side (CPU only)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--phase",
             "make", w, self.fix, self.scale], cwd=REPO,
            env=_clean_env(), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for w in sets]
        for w, p in zip(sets, procs):
            o, e = p.communicate(timeout=900)
            if p.returncode != 0:
                sys.stderr.write(e[-4000:])
                raise SmokeError(f"fixture {w} exited {p.returncode}")
        if self.four:
            with open(f"{self.fix}/four.list", "w") as fh:
                fh.write("".join(f"{self.fix}/{b}\n" for b in (
                    "main.bam", "main_s2.bam", "main_s3.bam",
                    "main_s4.bam")))
        say(f"fixtures ({', '.join(sets)}): "
            f"{time.perf_counter() - t0:.1f} s of set-up")

    # -- CLI runs
    def _run(self, argv, prefix, env, expect=None):
        cmd = [sys.executable, "-S", LAUNCHER, *argv, "-o", prefix, "-v"]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True,
                           text=True, timeout=1200)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            sys.stderr.write(r.stderr[-6000:])
            raise SmokeError(f"{' '.join(argv)} exited {r.returncode}")
        if expect and expect not in r.stderr:
            sys.stderr.write(r.stderr[-3000:])
            raise SmokeError(f"{' '.join(argv)}: no '{expect}' in -v")
        return wall, r.stderr

    def engine_line(self, engine: str) -> str:
        return f"INFO: engine={engine} device={self.plat}:"

    def host_ref(self, name, argv) -> float:
        wall, _ = self._run(argv, f"{self.out}/{name}.host",
                            self.host_env(),
                            "INFO: engine=HostCoverageEngine device=host")
        return wall

    def parity(self, name, got_prefix) -> None:
        bad = compare_tables(f"{self.out}/{name}.host", got_prefix)
        if bad:
            raise SmokeError(f"{name}: " + "; ".join(bad[:5]))

    def cli_cases(self):
        f = self.fix
        main = [("chr", ["-i", f"{f}/main.bam"]),
                ("gene", ["-i", f"{f}/main.bam", "-g", f"{f}/main.gff",
                          "-f", "CDS"]),
                ("bed", ["-i", f"{f}/main.bam", "-b", f"{f}/main.bed"]),
                ("win", ["-i", f"{f}/main.bam", "-w", "500000"])]
        if self.four:
            return main
        return main + [
            ("w100", ["-i", f"{f}/main.bam", "-w", "100"]),
            ("site", ["-i", f"{f}/small.bam", "-a"]),
            ("gc", ["-i", f"{f}/small.bam", "-c", "-r", f"{f}/small.fa"]),
            ("cram", ["-i", f"{f}/small.cram", "-g", f"{f}/small.gff",
                      "-c", "-r", f"{f}/small.fa"]),
            ("paf", ["-i", f"{f}/small.paf"]),
            ("list", ["-i", f"{f}/small.list"])]

    def cli(self, engine: str) -> None:
        walls = {}
        for name, argv in self.cli_cases():
            walls[name], _ = self._run(
                argv, f"{self.out}/{name}.dev",
                self.device_env(PANDEPTH_DAEMON=0),
                self.engine_line(engine))
        # references after the device runs, side by side (CPU only)
        import concurrent.futures as cf

        with cf.ThreadPoolExecutor(4) as ex:
            refs = dict(zip(
                [n for n, _ in self.cli_cases()],
                ex.map(lambda c: self.host_ref(*c), self.cli_cases())))
        for name, _ in self.cli_cases():
            self.parity(name, f"{self.out}/{name}.dev")
            say(f"cli {name}: {engine} cold {walls[name]:.2f} s, "
                f"host reference {refs[name]:.2f} s, tables identical "
                f"[{self.card}]")

    # -- phase 4
    def daemon(self) -> None:
        # the daemon runs take the encoded feed (and its finalize
        # warm-up), the cold runs the default raw one: both on the card
        env = self.device_env(PANDEPTH_DAEMON=1,
                              PANDEPTH_DAEMON_REQUIRE=1, PANDEPTH_ENC=1)
        cases = dict(self.cli_cases())
        try:
            for name in ("chr", "gene"):
                for k in range(2):
                    wall, _ = self._run(
                        cases[name], f"{self.out}/{name}.daemon{k}", env,
                        self.engine_line("CoverageEngine"))
                    self.parity(name, f"{self.out}/{name}.daemon{k}")
                    say(f"daemon {name} run {k + 1}: {wall:.2f} s, tables "
                        f"identical [{self.card}]")
            direct = dict(env, PANDEPTH_DAEMON="0")
            del direct["PANDEPTH_ENC"]
            wall, err = self._run(cases["chr"], f"{self.out}/chr.direct",
                                  direct,
                                  self.engine_line("CoverageEngine"))
            if "stopped the resident pandepth daemon" not in err:
                raise SmokeError("direct run did not stop the daemon")
            pid = int(err.split("daemon (pid ")[1].split(")")[0])
            if os.path.exists(f"/proc/{pid}"):
                with open(f"/proc/{pid}/stat") as fh:
                    if fh.read().rsplit(")", 1)[1].split()[0] != "Z":
                        raise SmokeError(f"daemon {pid} still running")
            self.parity("chr", f"{self.out}/chr.direct")
            say(f"direct run beside the daemon: stopped it (pid {pid}) "
                f"first, {wall:.2f} s, tables identical [{self.card}]")
        finally:
            subprocess.run([sys.executable, "-S", LAUNCHER,
                            "--daemon-stop"], env=env, cwd=REPO,
                           timeout=120, capture_output=True)
            self.no_leftovers()

    def no_leftovers(self) -> None:
        if self.rehearsal:
            return
        r = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60,
                           check=True)
        pids = [p.strip() for p in r.stdout.splitlines() if p.strip()]
        ours = []
        for p in pids:
            try:
                with open(f"/proc/{p}/cmdline", "rb") as fh:
                    cmd = fh.read().decode(errors="replace")
            except OSError:
                continue  # not visible here: not ours
            if "pandepth" in cmd or REPO in cmd:
                ours.append(p)
        if ours:
            raise SmokeError(f"processes still on the card: {ours}")
        say(f"card released: nvidia-smi lists {len(pids)} compute "
            f"process(es), none of ours")

    # -- feed-format timing
    def feed_timing(self) -> None:
        import statistics

        for name, argv in self.cli_cases()[:2]:  # chr, gene
            ref = self.host_ref(name, argv)
            walls = {v: [] for v, _ in FEED_VARIANTS}
            for rnd in range(FEED_ROUNDS + 1):
                order = FEED_VARIANTS if rnd % 2 else FEED_VARIANTS[::-1]
                for v, extra in order:
                    prefix = f"{self.out}/{name}.feed"
                    wall, err = self._run(
                        argv, prefix,
                        self.device_env(PANDEPTH_DAEMON=0, **extra),
                        self.engine_line("CoverageEngine"))
                    self.parity(name, prefix)
                    info = [ln for ln in err.splitlines()
                            if ln.startswith("INFO: wall=")]
                    if rnd == 0:
                        continue  # untimed: loads this variant's programs
                    walls[v].append(wall)
                    say(f"feed {name} {v} round {rnd}: {wall:.3f} s "
                        f"{info[-1] if info else ''}")
            say(f"feed {name}: host reference {ref:.2f} s; median cold "
                f"wall over {FEED_ROUNDS} rounds: " + ", ".join(
                    f"{v} {statistics.median(w):.3f} s"
                    for v, w in walls.items()) + f" [{self.card}]")

    # -- four cards
    def launcher(self) -> None:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        name = "four_list"
        prefix = f"{self.out}/{name}.launch"
        procs = []
        t0 = time.perf_counter()
        for rank in range(4):
            env = _clean_env(JAX_PLATFORMS=self.jax_plat, **self.small_enc)
            if not self.rehearsal:
                env["CUDA_VISIBLE_DEVICES"] = str(rank)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "pandepth_jax.sharding.launch",
                 "--coordinator", f"localhost:{port}", "--nprocs", "4",
                 "--rank", str(rank), "-i",
                 f"{self.fix}/four.list", "-o", prefix, "-v"],
                cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        errs = []
        try:
            for p in procs:
                _, e = p.communicate(timeout=1200)
                errs.append(e)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        wall = time.perf_counter() - t0
        for rank, (p, e) in enumerate(zip(procs, errs)):
            if p.returncode != 0:
                sys.stderr.write(e[-4000:])
                raise SmokeError(f"launcher rank {rank} exited "
                                 f"{p.returncode}")
            if self.engine_line("MultihostCoverageEngine") not in e:
                raise SmokeError(f"rank {rank}: no multihost engine line")
        ref = self.host_ref(name, ["-i", f"{self.fix}/four.list"])
        self.parity(name, prefix)
        say(f"launcher, 4 ranks x 1 card over a 4-file .list: "
            f"{wall:.2f} s, host reference {ref:.2f} s, tables "
            f"identical [{self.card}]")

    def run(self) -> dict:
        info = self.environment()
        self.fixtures()
        if self.four:
            self.cli("ShardedCoverageEngine")
            self.launcher()
            return info
        if self.feed:
            self.feed_timing()
            return info
        _child("kernels", self.device_env(), self.fix, timeout=1200)
        self.cli("CoverageEngine")
        self.daemon()
        return info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card path")
    ap.add_argument("--feed-timing", action="store_true",
                    help="run only the feed-format comparison")
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="tiny sizes on the CPU backend; prints no "
                         "result line")
    ap.add_argument("--phase", nargs="+", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.phase:
        kind, args = a.phase[0], a.phase[1:]
        fn = {"probe": phase_probe, "make": phase_make,
              "kernels": phase_kernels}[kind]
        print(json.dumps(fn(*args)), flush=True)
        return 0

    if not os.path.exists(os.path.join(REPO, "pandepth_jax")):
        sys.stderr.write("chip_smoke.py: run it from a pandepth "
                         "checkout\n")
        return 2
    t0 = time.perf_counter()
    if a.four_cards and a.feed_timing:
        ap.error("--four-cards and --feed-timing are separate runs")
    smoke = Smoke(a.cpu_rehearsal, a.four_cards, a.feed_timing)
    try:
        info = smoke.run()
    except (SmokeError, subprocess.SubprocessError, OSError) as e:
        sys.stderr.write(f"chip_smoke: FAILED: {e}\n")
        return 1
    say(f"all phases passed in {time.perf_counter() - t0:.1f} s "
        f"[{smoke.card}]")
    if a.cpu_rehearsal:
        say("CPU rehearsal passed (no result line: not a card run)")
        return 0
    say(smoke.card)
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
