"""ThreadSanitizer run of the native library's multi-threaded paths
(SURVEY.md §5 "race detection"): pancov_io.cpp + tests/tsan_driver.cpp
built with -fsanitize=thread and run on a real BAM. Any data race in
the streaming producer / inflate pool / work-stealing chaser makes
TSAN report and the driver exit nonzero."""

import os
import subprocess

import numpy as np
import pytest

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "pandepth_jax", "io", "native",
                    "pancov_io.cpp")
_DRIVER = os.path.join(_HERE, "tsan_driver.cpp")
_BIN = "/tmp/pandepth_tsan/driver"


def _build():
    os.makedirs(os.path.dirname(_BIN), exist_ok=True)
    srcs = [os.path.getmtime(_SRC), os.path.getmtime(_DRIVER)]
    if os.path.exists(_BIN) and os.path.getmtime(_BIN) > max(srcs):
        return None
    base = ["g++", "-std=c++17", "-O1", "-g", "-fsanitize=thread",
            "-o", _BIN, _SRC, _DRIVER]
    ld = "/root/reference"
    attempts = []
    if os.path.exists(os.path.join(ld, "lib", "libdeflate.a")):
        attempts.append(base + ["-DUSE_LIBDEFLATE", f"-I{ld}/include",
                                f"-L{ld}/lib", "-ldeflate", "-lz",
                                "-lpthread"])
    attempts.append(base + ["-lz", "-lpthread"])
    err = "no attempts"
    for cmd in attempts:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=300)
        if r.returncode == 0:
            return None
        err = r.stderr[-1500:]
    return err


def test_native_io_under_tsan(tmp_path):
    err = _build()
    if err is not None:
        pytest.fail(f"TSAN build failed: {err}")

    from tests.fixtures import make_bam

    bam = str(tmp_path / "t.bam")
    # enough records for several 1 MB stream windows + escape traffic
    make_bam(bam, n=60_000, seed=21)
    env = dict(os.environ)
    env["TSAN_OPTIONS"] = "halt_on_error=1 exitcode=66"
    r = subprocess.run([_BIN, bam], capture_output=True, text=True,
                       timeout=600, env=env)
    assert "WARNING: ThreadSanitizer" not in r.stderr, r.stderr[-4000:]
    assert r.returncode == 0, (r.returncode, r.stderr[-4000:])
    assert "TSAN_DRIVER_OK" in r.stdout, r.stdout
