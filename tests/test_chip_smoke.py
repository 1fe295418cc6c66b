"""chip_smoke.py off the card: its table comparison, its device check,
its refusal to report a result without a GPU, and a full rehearsal of
its one-card phases at tiny sizes on the CPU backend."""

import gzip
import importlib.util
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")


def _load():
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write(path, text):
    with gzip.open(path, "wt") as fh:
        fh.write(text)


@pytest.mark.parametrize("case", ["same", "differs", "missing",
                                  "unexpected", "no_reference"])
def test_compare_tables(tmp_path, case):
    cs = _load()
    ref, got = str(tmp_path / "r"), str(tmp_path / "g")
    if case != "no_reference":
        _write(ref + ".chr.stat.gz", "#Chr\tLength\nchr1\t10\n")
        _write(ref + ".gene.stat.gz", "g1\t5\n")
    _write(got + ".chr.stat.gz", "#Chr\tLength\n" + (
        "chr1\t11\n" if case == "differs" else "chr1\t10\n"))
    if case not in ("missing", "no_reference"):
        _write(got + ".gene.stat.gz", "g1\t5\n")
    if case == "unexpected":
        _write(got + ".SiteDepth.gz", "chr1\t1\t0\n")
    bad = cs.compare_tables(ref, got)
    if case == "same":
        assert bad == []
    else:
        assert len(bad) == 1, bad
        word = {"differs": "differs", "missing": "missing",
                "unexpected": "unexpected",
                "no_reference": "no table"}[case]
        assert word in bad[0]


@pytest.mark.parametrize("info,count,ok", [
    ({"platform": "gpu", "count": 1}, 1, True),
    ({"platform": "gpu", "count": 4}, 4, True),
    ({"platform": "cpu", "count": 1}, 1, False),
    ({"platform": "gpu", "count": 1}, 4, False),
    ({}, 1, False),
])
def test_check_device(info, count, ok):
    cs = _load()
    if ok:
        cs.check_device(info, "gpu", count)
    else:
        with pytest.raises(cs.SmokeError):
            cs.check_device(info, "gpu", count)


def _no_result(r):
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_no_gpu_no_result():
    """Without a GPU (this machine) the script fails before any
    result line."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    r = subprocess.run([sys.executable, SMOKE], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    _no_result(r)


def test_alone_no_result(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the
    repository, the script fails without a result line."""
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"],
                       cwd=str(tmp_path), capture_output=True,
                       text=True, timeout=120)
    _no_result(r)


def test_cpu_rehearsal():
    """Every one-card phase at tiny sizes on the CPU backend: kernel
    checks, the CLI in every mode against the host engine, the warm
    daemon and a direct run that stops it."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    r = subprocess.run([sys.executable, SMOKE, "--cpu-rehearsal"],
                       cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "CPU rehearsal passed" in r.stdout
    assert "stopped it (pid" in r.stdout
    cli_lines = [line for line in r.stdout.splitlines()
                 if line.startswith("cli ")]
    assert len(cli_lines) == 10, r.stdout


@pytest.mark.parametrize("four,feed", [(False, False), (True, False),
                                       (False, True)])
def test_runs_use_own_socket(four, feed):
    """Every run the smoke starts, device or reference, names a daemon
    socket inside the smoke's work directory: its direct runs stop no
    daemon but its own."""
    cs = _load()
    smoke = cs.Smoke(True, four, feed)
    for env in (smoke.device_env(PANDEPTH_DAEMON=0), smoke.host_env()):
        sock = env["PANDEPTH_DAEMON_SOCK"]
        assert os.path.dirname(sock) == cs.WORK
    assert smoke.device_env()["JAX_PLATFORMS"] == "cpu"


def test_feed_timing_and_four_cards_exclusive():
    r = subprocess.run([sys.executable, SMOKE, "--four-cards",
                        "--feed-timing"], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    _no_result(r)
    assert "separate runs" in r.stderr
