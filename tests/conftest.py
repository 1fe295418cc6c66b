"""Test configuration: force the CPU backend with 8 virtual devices so
mesh/sharding tests run without accelerator hardware (SURVEY.md §4.4).
Tests that need the GPU are marked ``chip`` and skip here."""

import os
import shutil
import subprocess
import tempfile

os.environ["JAX_PLATFORMS"] = "cpu"
# the launcher routes through the resident daemon by default; tests
# must stay in-process and deterministic (test_serve opts back in with
# its own socket per subprocess)
os.environ["PANDEPTH_DAEMON"] = "0"
# a direct run stops the daemon on its socket: give this test process
# and its children a socket of their own, which no other checkout's
# daemon listens on
os.environ.setdefault("PANDEPTH_DAEMON_SOCK", os.path.join(
    tempfile.gettempdir(), f"pandepth-test-{os.getpid()}.sock"))
# small encoded-window buffers: test fixtures are hundreds of reads,
# and the production 2^19-pair windows make every CPU run sort ~99.9%
# padding (~5 s per CLI run, ~0.15 s with these). The encoding logic
# is cap-independent; tests that exercise capacity behavior set their
# own values (setdefault keeps them in charge).
os.environ.setdefault("PANDEPTH_ENC_CAP", str(1 << 14))
os.environ.setdefault("PANDEPTH_ENC_EXC", str(1 << 11))
# keep the CPU suite exercising the encoded feed path (the default
# feed is raw staging — tests that want that default unset this)
os.environ.setdefault("PANDEPTH_ENC", "1")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# khugepaged stalls large numpy buffers on this host (see
# boot.disable_thp); opt the test process out before arrays exist
from pandepth_jax.boot import disable_thp  # noqa: E402

disable_thp()

import jax  # noqa: E402

jax.config.update("jax_num_cpu_devices", 8)

import pytest  # noqa: E402

REF_SRC = "/root/reference/src/PanDepth.cpp"
ORACLE = "/tmp/refbin/pandepth"


@pytest.fixture(scope="session")
def oracle_bin():
    """Path to the reference pandepth binary (built once per machine),
    or skip when the reference tree isn't available."""
    if os.path.exists(ORACLE):
        return ORACLE
    if not os.path.exists(REF_SRC) or shutil.which("g++") is None:
        pytest.skip("reference oracle unavailable")
    os.makedirs(os.path.dirname(ORACLE), exist_ok=True)
    subprocess.run(
        ["g++", "--std=c++11", "-O2", "-o", ORACLE, REF_SRC,
         "-I/root/reference/include", "-L/root/reference/lib",
         "-lhts", "-ldeflate", "-lz", "-lpthread"],
        check=True)
    return ORACLE


def pytest_collection_modifyitems(config, items):
    """The suite runs on the CPU backend: ``chip`` tests skip."""
    skip = pytest.mark.skip(
        reason="needs the GPU; chip_smoke.py covers it on the card")
    for item in items:
        if "chip" in item.keywords:
            item.add_marker(skip)
