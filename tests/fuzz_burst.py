"""Extended differential fuzz burst (standalone, not in the suite).

Runs the test_fuzz_parity generators over a large seed range in worker
processes, every case byte-compared against the reference binary:

    python tests/fuzz_burst.py START COUNT [WORKERS]

Case kinds cycle by seed: native BAM, pure-Python decoders, the format
spins (SAM / SAM.gz / CRAM / indexed CRAM), and the multi-file
BAM-list / PAF-list / CRAM cases. Prints one summary line and exits
nonzero if any case diverges. The default suite runs a fixed ~90-seed
slice of these generators; bursts of thousands of fresh seeds are how
the 1-base-final-window and PAF heap-corruption parity bugs were
found.
"""

from __future__ import annotations

import glob
import multiprocessing as mp
import os
import shutil
import subprocess
import sys
import tempfile
import traceback


def _init_worker():
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.setdefault("PANDEPTH_ENC_CAP", str(1 << 14))
    os.environ.setdefault("PANDEPTH_ENC_EXC", str(1 << 11))
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    from pandepth_jax.boot import disable_thp

    disable_thp()
    jax.config.update("jax_num_cpu_devices", 8)


ORACLE = "/tmp/refbin/pandepth"


def _run_multi(tmp: str, seed: int) -> str:
    from pandepth_jax.cli import main as cli_main
    from tests.test_fuzz_parity import _gen_multi_case, gunzip_bytes

    inp, args = _gen_multi_case(tmp, seed)
    ref_out = os.path.join(tmp, "refm")
    our_out = os.path.join(tmp, "oursm")
    rr = subprocess.run([ORACLE, "-i", inp, "-o", ref_out] + args,
                        capture_output=True)
    if rr.returncode != 0:
        return "oracle-crash"
    rc = cli_main(["pandepth", "-i", inp, "-o", our_out] + args)
    ref_files = sorted(glob.glob(ref_out + "*.gz"))
    if not ref_files:
        assert not glob.glob(our_out + "*.gz"), (seed, args)
        return "both-rejected"
    assert rc == 0, (seed, args)
    for rf in ref_files:
        of = rf.replace("refm", "oursm", 1)
        assert os.path.exists(of), (seed, args, rf)
        assert gunzip_bytes(rf) == gunzip_bytes(of), \
            (seed, args, os.path.basename(rf))
    return "ok"


def run_one(seed: int) -> tuple:
    """One fuzz case; returns (seed, status, detail)."""
    kind = seed % 8
    tmp = tempfile.mkdtemp(prefix=f"fz{seed}_", dir="/tmp/fuzzburst")
    try:
        from tests.test_fuzz_parity import _run_case

        if kind < 3:
            st = _run_case(tmp, ORACLE, seed)
        elif kind == 3:
            os.environ["PANDEPTH_NO_NATIVE"] = "1"
            try:
                st = _run_case(tmp, ORACLE, seed)
            finally:
                os.environ.pop("PANDEPTH_NO_NATIVE", None)
        elif kind < 7:
            # (seed // 8) % 4, NOT seed % 4: kind = seed % 8 in
            # {4,5,6} pins seed % 4 to {0,1,2} and 'cram+crai' would
            # never be selected
            fmt = ("sam", "sam.gz", "cram", "cram+crai")[(seed // 8) % 4]
            st = _run_case(tmp, ORACLE, seed, fmt=fmt)
        else:
            st = _run_multi(tmp, seed)
        return seed, st, ""
    except Exception:
        return seed, "FAIL", traceback.format_exc(limit=12)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    start = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    count = int(sys.argv[2]) if len(sys.argv) > 2 else 500
    workers = int(sys.argv[3]) if len(sys.argv) > 3 else 3
    os.makedirs("/tmp/fuzzburst", exist_ok=True)
    if not os.path.exists(ORACLE):
        sys.path.insert(0, os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        _init_worker()
        import tests.conftest  # noqa: F401  (builds via fixture only)

        subprocess.run(
            ["g++", "--std=c++11", "-O2", "-o", ORACLE,
             "/root/reference/src/PanDepth.cpp",
             "-I/root/reference/include", "-L/root/reference/lib",
             "-lhts", "-ldeflate", "-lz", "-lpthread"], check=True)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    counts: dict = {}
    failures = []
    with mp.Pool(workers, initializer=_init_worker) as pool:
        for i, (seed, st, detail) in enumerate(
                pool.imap_unordered(run_one,
                                    range(start, start + count))):
            counts[st] = counts.get(st, 0) + 1
            if st == "FAIL":
                failures.append((seed, detail))
                print(f"FAIL seed={seed}\n{detail}", flush=True)
            if (i + 1) % 50 == 0:
                print(f"[{i + 1}/{count}] {counts}", flush=True)
    print(f"fuzz_burst {start}..{start + count}: {counts}")
    for seed, _ in failures:
        print(f"  failed seed: {seed}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
