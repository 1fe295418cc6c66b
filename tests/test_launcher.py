"""The fast-start ``pandepth`` launcher (python -S + deferred jax init,
pandepth_jax/boot.py) must produce byte-identical tables to the
in-process CLI."""

import gzip
import os
import subprocess
import sys

from pandepth_jax.cli import main as cli_main

from fixtures import make_bam, make_gff

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCHER = os.path.join(REPO, "pandepth")


def _read(path):
    with gzip.open(path, "rb") as fh:
        return fh.read()


def _launcher_env():
    env = dict(os.environ)
    # the launcher subprocess stays on the CPU backend like the suite
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_launcher_matches_inprocess(tmp_path):
    bam = str(tmp_path / "t.bam")
    gff = str(tmp_path / "t.gff")
    make_bam(bam, n=600, seed=5)
    make_gff(gff)

    rc = cli_main(["pandepth", "-i", bam, "-g", gff, "-o",
                   str(tmp_path / "inproc")])
    assert rc == 0

    r = subprocess.run(
        [sys.executable, "-S", LAUNCHER, "-i", bam, "-g", gff, "-o",
         str(tmp_path / "launched")],
        capture_output=True, text=True, timeout=600,
        env=_launcher_env())
    assert r.returncode == 0, r.stderr[-2000:]
    assert _read(str(tmp_path / "launched.gene.stat.gz")) == \
        _read(str(tmp_path / "inproc.gene.stat.gz"))


def test_launcher_host_run_spawns_no_daemon(tmp_path):
    """Engine-aware routing (boot.main): a host-engine run executes
    in-process — no daemon socket appears, output matches the
    in-process CLI, and a forced PANDEPTH_HOST_FINALIZE=1 is honored
    rather than silently overridden by daemon routing."""
    bam = str(tmp_path / "t.bam")
    make_bam(bam, n=400, seed=6)
    rc = cli_main(["pandepth", "-i", bam,
                   "-o", str(tmp_path / "inproc")])
    assert rc == 0

    sock = str(tmp_path / "d.sock")
    env = _launcher_env()
    env["PANDEPTH_HOST_FINALIZE"] = "1"
    env["PANDEPTH_DAEMON_SOCK"] = sock
    env.pop("PANDEPTH_DAEMON", None)  # "auto": daemon would be default
    r = subprocess.run(
        [sys.executable, "-S", LAUNCHER, "-i", bam, "-o",
         str(tmp_path / "hosted")],
        capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert not os.path.exists(sock), "host run must not spawn a daemon"
    assert _read(str(tmp_path / "hosted.chr.stat.gz")) == \
        _read(str(tmp_path / "inproc.chr.stat.gz"))


def test_launcher_help_is_sitecustomize_free(tmp_path):
    """Under ``python -S`` (no site hooks at all) the launcher finds
    its packages through restore_site, and -h exits before any jax
    import."""
    # a jax package that refuses to import shadows the real one
    fake = tmp_path / "jax"
    fake.mkdir()
    (fake / "__init__.py").write_text(
        "raise ImportError('jax imported by -h')\n")
    env = _launcher_env()
    env["PYTHONPATH"] = os.pathsep.join(
        [str(tmp_path), env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    r = subprocess.run([sys.executable, "-S", LAUNCHER, "-h"],
                       capture_output=True, text=True, timeout=120,
                       env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "Usage: pandepth" in r.stdout
