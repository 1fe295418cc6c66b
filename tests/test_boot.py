"""Process bootstrap rules that need no accelerator: where the
persistent compile cache lives, and what the native build links."""

import os
import subprocess
import sys

import pytest

from pandepth_jax import boot
from pandepth_jax.io import native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env,plat,want", [
    ("/elsewhere/cache", "cpu", "/elsewhere/cache"),
    ("/elsewhere/cache", "cuda", "/elsewhere/cache"),
    (None, "cpu", os.path.join(REPO, ".jax_cache_cpu")),
    (None, "cpu,cuda", os.path.join(REPO, ".jax_cache_cpu")),
    (None, "cuda", os.path.join(REPO, ".jax_cache")),
    (None, "", os.path.join(REPO, ".jax_cache")),
])
def test_cache_dir_rules(monkeypatch, env, plat, want):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    monkeypatch.setenv("JAX_PLATFORMS", plat)
    assert boot.jax_cache_dir() == want


@pytest.mark.parametrize("env_dir", [True, False])
def test_configure_jax_cache_dir(tmp_path, env_dir):
    """With JAX_COMPILATION_CACHE_DIR set, jax's own setting is the
    env's (the code sets no directory); unset, it is the fixed
    directory inside the checkout."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    want = os.path.join(REPO, ".jax_cache_cpu")
    if env_dir:
        want = str(tmp_path / "jc")
        env["JAX_COMPILATION_CACHE_DIR"] = want
    r = subprocess.run(
        [sys.executable, "-c",
         "from pandepth_jax import boot; "
         "jax = boot.configure_jax(); "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == want


def test_native_build_uses_only_the_checkout():
    """Every build attempt compiles the committed source into the
    build directory and links system libraries only."""
    cmds = native.build_commands()
    assert cmds and all(native._SRC in c for c in cmds)
    assert cmds[-1][-2:] == ["-lz", "-lpthread"]  # zlib fallback last
    for cmd in cmds:
        for arg in cmd:
            for path in (arg, arg[2:]):  # -I/-L prefixes
                if os.path.isabs(path):
                    assert path in (native._SRC, native._LIB), arg


def test_native_reports_inflate_backend():
    lib = native.load_library()
    if lib is None:
        pytest.skip("native library unavailable")
    assert lib.pancov_inflate_backend().decode() in ("libdeflate",
                                                      "zlib")
