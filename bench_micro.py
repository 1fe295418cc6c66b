"""Host-side micro-benchmarks of the native components (host-sweep
ns/pair, native FASTA GC scanner MB/s, native PAF tokenizer lines/s).
Prints one JSON object; these are host-CPU numbers, never device ones.

Run alone (never concurrently with another bench):
    python bench_micro.py
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time

from pandepth_jax import boot  # noqa: F401  (THP off before numpy work)

import numpy as np

def bench_host_sweep(n_pairs: int = 16 << 20) -> dict:
    """ns/pair of the native host finalize (parallel radix sort + one
    sweep + query eval) at 3 Gb coordinate scale — the engine cold
    one-shot runs elect (device/host_engine.py)."""
    from pandepth_jax.device import hosteval as he

    total = 3_000_000_000
    dt = he.pos_dtype_for(total)  # uint32 at 3 Gb
    sentinel = int(np.iinfo(dt).max)
    rng = np.random.RandomState(11)
    starts = rng.randint(0, total - 200, n_pairs).astype(dt)
    ends = (starts + 150).astype(dt)
    lo = np.zeros(1, np.int64)
    hi = np.full(1, total, np.int64)
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        he.finalize_events([(starts, ends)], None, None, sentinel,
                           lo, hi, 1, False, keep_state=False)
        walls.append(time.perf_counter() - t0)
    w = statistics.median(walls)
    return {"host_sweep_pairs": n_pairs,
            "host_sweep_wall_s": round(w, 3),
            "host_sweep_ns_per_pair": round(w / n_pairs * 1e9, 2)}


def bench_fasta_scan(mb: int = 256) -> dict:
    """MB/s of the native streaming FASTA scanner -> PackedGC."""
    from pandepth_jax.io.fasta import iter_fasta_gc

    rng = np.random.RandomState(13)
    with tempfile.TemporaryDirectory() as td:
        fa = os.path.join(td, "m.fa")
        with open(fa, "w", buffering=1 << 22) as fh:
            for c in range(2):
                fh.write(f">c{c}\n")
                for _ in range(mb // 2 // 8):
                    seq = rng.choice([65, 67, 71, 84],
                                     8_000_000).astype(np.uint8)
                    fh.write(seq.tobytes().decode("ascii"))
                    fh.write("\n")
        size = os.path.getsize(fa)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            for _name, _gc in iter_fasta_gc(fa):
                pass
            walls.append(time.perf_counter() - t0)
    w = statistics.median(walls)
    return {"fasta_scan_mb": round(size / 1e6),
            "fasta_scan_mb_s": round(size / 1e6 / w, 1)}


def bench_paf_tokenize(n_lines: int = 2_000_000) -> dict:
    """lines/s of the native PAF tokenizer -> clamped global depth
    intervals (pancov_paf_load)."""
    from pandepth_jax.io.native import NativePafLoad

    rng = np.random.RandomState(17)
    L = 250_000_000
    names = [f"chr{i + 1}" for i in range(4)]
    tid = rng.randint(0, 4, n_lines)
    pos = rng.randint(0, L - 200, n_lines)
    mapq = rng.choice([0, 10, 30, 60], n_lines)
    offsets = np.arange(4, dtype=np.int64) * (L + 512)
    limits = offsets + L
    with tempfile.TemporaryDirectory() as td:
        paf = os.path.join(td, "m.paf")
        with open(paf, "w", buffering=1 << 22) as fh:
            chunk = 200_000
            for i in range(0, n_lines, chunk):
                rows = [f"r\t150\t0\t150\t+\t{names[t]}\t{L}\t{p}\t"
                        f"{p + 150}\t150\t150\t{q}\tcg:Z:150M"
                        for t, p, q in zip(tid[i:i + chunk],
                                           pos[i:i + chunk],
                                           mapq[i:i + chunk])]
                fh.write("\n".join(rows) + "\n")
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            ld = NativePafLoad(paf, 1796, -1, names, offsets, limits)
            ld.close()
            walls.append(time.perf_counter() - t0)
    w = statistics.median(walls)
    return {"paf_lines": n_lines,
            "paf_lines_per_s": round(n_lines / w)}


def main() -> int:
    try:
        os.sync()
    except OSError:
        pass
    res = {}
    for fn in (bench_host_sweep, bench_fasta_scan,
               bench_paf_tokenize):
        part = fn()
        sys.stderr.write(f"bench_micro: {part}\n")
        res.update(part)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
