"""Process bootstrap: cheap CLI start with deferred jax initialization.

The reference pandepth is a compiled binary whose ``main``
(src/PanDepth.cpp:3441) starts doing IO within microseconds of
``exec``. A Python CLI normally pays the whole import tax up front:
``import jax`` plus the device client's creation are seconds of
mostly GIL-bound CPU spent before ``main`` even runs, a fixed loss on
any short run.

The ``pandepth`` launcher removes that serial cost:

* Python starts with ``-S`` (skip the ``site`` module), which skips
  only the *automatic* site-packages setup — ``PYTHONPATH`` entries
  stay on ``sys.path``.
* :func:`restore_site` re-adds site-packages (and the venv prefix,
  which ``site.venv`` normally resolves) in microseconds.
* :func:`background` runs the expensive part — ``import jax``, the
  framework's jax config and the device client's creation — on a
  daemon thread, overlapped with native file IO whose C++ worker
  threads don't hold the GIL.
* Anything that needs jax calls :func:`configure_jax` first (the
  ``pandepth_jax.device`` / ``pandepth_jax.sharding`` package inits
  do), which blocks until the background init finishes.

Under a normal ``python -m pandepth_jax.cli`` start all of this
degrades to cheap no-ops: :func:`configure_jax` only applies the jax
config once.
"""

from __future__ import annotations

import os
import sys
import threading

_lock = threading.RLock()
_configured = False
_ready = threading.Event()
_bg = None


def disable_thp() -> None:
    """Opt this process out of transparent huge pages.

    numpy madvises ``MADV_HUGEPAGE`` on every allocation >= 4 MB; on
    this host family the huge-page fault path crawls (measured: a
    fresh 240 MB ``np.arange`` takes 26-35 s with the madvise vs
    0.14-0.5 s without — ~9 MB/s of first-touch compaction stalls).
    ``PR_SET_THP_DISABLE`` alone does NOT neutralize madvised regions
    on this kernel, so numpy's own switch must be thrown too. The
    prctl flag is inherited across fork/exec, so the serve daemon and
    test subprocesses keep it; each Python child re-runs this for the
    numpy side. ``PANDEPTH_THP=1`` keeps THP enabled."""
    if os.environ.get("PANDEPTH_THP") == "1":
        return
    try:
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(41, 1, 0, 0, 0)  # PR_SET_THP_DISABLE
    except Exception:  # best-effort tuning only
        pass
    try:
        from numpy._core.multiarray import _set_madvise_hugepage
    except ImportError:
        try:
            from numpy.core.multiarray import _set_madvise_hugepage
        except ImportError:
            _set_madvise_hugepage = None
    if _set_madvise_hugepage is not None:
        try:
            _set_madvise_hugepage(False)
        except Exception:
            pass
    # keep big blocks on glibc's freelist instead of munmapping them:
    # genome-scale table passes allocate GBs of short-lived numpy
    # temporaries, and this host's page faults are slow enough
    # (~3-10 us) that refaulting every temporary dominated sys time
    # (measured 5x 240MB alloc cycles: 1.7 s sys before, 0.0 after)
    try:
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD
        libc.mallopt(-1, 1 << 30)  # M_TRIM_THRESHOLD
    except Exception:
        pass


disable_thp()


def restore_site() -> None:
    """Under ``python -S``: add the site-packages directories that
    ``site.main()`` would have added (venv resolution via
    ``pyvenv.cfg`` lives in ``site.venv``, so ``-S`` skips that too
    and it must be replayed here)."""
    if not sys.flags.no_site:
        return
    import site

    site.ENABLE_USER_SITE = False
    known = site.venv(set())
    site.addsitepackages(known)


_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_cache_dir() -> str:
    """The persistent-compile-cache directory this process uses.

    ``JAX_COMPILATION_CACHE_DIR`` when it is set (jax reads it itself;
    :func:`configure_jax` then sets no directory). Otherwise a fixed
    directory inside the checkout — a fixed path, because the path is
    part of the cache key: ``.jax_cache``, or ``.jax_cache_cpu`` for
    runs held to the CPU (``JAX_PLATFORMS=cpu``), whose XLA-CPU
    executables are specific to the host's CPU features and must
    stay cheap to wipe apart from the device cache. Sidecar state kept
    next to the cache (the warm-signature list in
    ``device/engine.py``) derives its path from THIS function, so
    wiping one cache also invalidates its sidecar."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    cpu = os.environ.get("JAX_PLATFORMS", "").split(",")[0] == "cpu"
    return os.path.join(_CHECKOUT,
                        ".jax_cache_cpu" if cpu else ".jax_cache")


def configure_jax():
    """Import jax and apply the framework's process config exactly
    once. Thread-safe; every caller blocks until the first one
    finishes. Returns the jax module."""
    global _configured
    with _lock:
        import jax

        if _configured:
            return jax
        # Genome coordinates are flattened onto one global int64 axis
        # (a 3 Gb genome overflows int32), so 64-bit types must be
        # real, not silently truncated. Set before any jax array is
        # created.
        jax.config.update("jax_enable_x64", True)
        # CLI-style workloads pay full jit cost per process; a
        # persistent compile cache makes repeat invocations start in
        # milliseconds (directory rules: jax_cache_dir)
        try:
            if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
                cache = jax_cache_dir()
                os.makedirs(cache, exist_ok=True)
                jax.config.update("jax_compilation_cache_dir", cache)
            jax.config.update(
                "jax_persistent_cache_min_entry_size_bytes", -1)
            jax.config.update(
                "jax_persistent_cache_min_compile_time_secs", 0.0)
        except OSError:  # unwritable checkout: run uncached
            pass
        _configured = True
        _ready.set()
        return jax


def _init_and_touch() -> None:
    configure_jax()
    # the first device op of a process creates the device client;
    # force it here so it overlaps the host-side decode instead of
    # landing on the feed's first device_put. After _ready is set, so
    # configure_jax() consumers never wait on it.
    try:
        import numpy as _np

        import jax as _jax

        _np.asarray(_jax.numpy.arange(8).sum())
    except Exception:
        pass  # device probe trouble surfaces at the real first op


def background() -> None:
    """Start jax initialization on a daemon thread (idempotent). The
    first jax consumer (``configure_jax``) blocks until it finishes."""
    global _bg
    with _lock:
        if _bg is not None or _configured:
            return
        _bg = threading.Thread(target=_init_and_touch,
                               name="pandepth-jax-init", daemon=True)
        _bg.start()


def is_ready() -> bool:
    return _ready.is_set()


def init_started() -> bool:
    """True once background() or configure_jax() has been called —
    i.e. is_ready() will eventually flip without further action."""
    return _bg is not None or _configured


def main(argv=None) -> int:
    """Launcher entry (the ``pandepth`` script): restore site cheaply,
    kick jax init into the background, run the CLI. ``--serve`` /
    ``--daemon-stop`` and ``PANDEPTH_DAEMON=1`` route through the
    resident serve mode (pandepth_jax/serve.py) instead."""
    restore_site()
    # under `python -S` numpy was not importable when the module-level
    # call ran, so its madvise switch silently no-opped — repeat now
    disable_thp()
    args = list(sys.argv[1:] if argv is None else argv)
    if "--serve" in args:
        from pandepth_jax.serve import serve_foreground

        return serve_foreground()
    if "--daemon-stop" in args:
        from pandepth_jax.serve import stop_daemon

        stop_daemon()
        return 0
    # Engine-aware routing. Host-engine runs (PANDEPTH_HOST_FINALIZE=1,
    # run._want_host_finalize) execute IN-PROCESS and never touch jax:
    # a forced host engine must not be silently overridden by daemon
    # routing, and they need neither the daemon's warm device programs
    # nor the background jax init.
    from pandepth_jax.cli import main as cli_main
    from pandepth_jax.run import _want_host_finalize

    daemon_env = os.environ.get("PANDEPTH_DAEMON", "auto")
    if daemon_env == "auto" and _want_host_finalize():
        return cli_main(["pandepth"] + args)
    # Device-path runs default to serve mode: a cold Python+jax
    # process pays the jax import, the device client's creation and
    # the fused finalize's executable load per invocation, which the
    # reference binary never pays; routing through the resident
    # daemon (spawned on first use, idle-exit after
    # PANDEPTH_DAEMON_IDLE_S) removes that fixed tax from every run
    # after the first. Results are identical — serve.py ships argv,
    # cwd, PANDEPTH_* env and the caller's stdio fds, and a staleness
    # token (code mtimes + platform env) guarantees an edited tree or
    # a different backend never reuses an old daemon.
    # PANDEPTH_DAEMON=0 opts out (benchmarks pin it to measure the
    # cold path); cli.main then stops a resident daemon before it
    # initializes jax, so one device never has two jax processes. The
    # daemon serializes concurrent requests; parallel per-sample
    # pipelines should use the multihost launcher. No background() on
    # the daemon path: it must fork before any jax thread exists. An
    # EXPLICIT PANDEPTH_DAEMON=1 wins over the host election above
    # (service deployments pin it to keep a warm process).
    if daemon_env not in ("0", ""):
        from pandepth_jax.serve import client_main

        return client_main(args)
    # cli.main's argv convention is the reference binary's: a full
    # argv whose [0] is the program name (src/PanDepth.cpp:84)
    return cli_main(["pandepth"] + args)
