"""Resident serve mode: a warm pandepth process answering CLI runs.

The reference pandepth is a compiled binary with zero start-up tax; a
Python + jax process pays seconds of import, device-client and
jit-cache initialization per invocation — a fixed loss on every sample of a
multi-sample campaign (the reference's own benchmark protocol runs
the tool 10x per configuration, reference/README.md:128-131).

Serve mode removes that loss the way production services do: one
resident process keeps jax, the native library, and the jit caches
warm; each ``pandepth`` invocation becomes a microsecond-scale unix
socket round-trip that ships ``argv`` + the caller's
stdin/stdout/stderr file descriptors (SCM_RIGHTS) to the daemon,
which runs the normal CLI ``main`` under the caller's cwd and streams
output to the caller's own terminal/pipes. Observable behavior
(tables, stdout/stderr bytes, exit codes) is identical to a direct
run — only the start-up tax is gone.

Surface:

* ``pandepth --serve``        run a server in the foreground
* ``PANDEPTH_DAEMON=1 pandepth ...``  run via the daemon, spawning it
  on first use (double-fork detached; idle-exit after
  ``PANDEPTH_DAEMON_IDLE_S``, default 900 s)
* ``pandepth --daemon-stop``  terminate the daemon
* ``PANDEPTH_DAEMON_SOCK``    socket path override (default: this
  uid's socket in the temporary directory, so ``TMPDIR`` scopes it)

Staleness safety: the handshake carries a token derived from the
package source mtimes; a daemon built from older sources answers
``stale`` and exits, and the client respawns — an edited tree never
silently serves old code.

One JAX process per device: the daemon holds its device's memory
while it idles, so a direct (non-daemon) run first stops this uid's
daemon (:func:`stop_daemon`) before it initializes JAX itself.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import tempfile
import threading
import time
from typing import Optional

# True inside the resident daemon process (set by _Server.serve): its
# own CLI runs must not stop the daemon they run in
IN_PROCESS_DAEMON = False

_REQ_LIMIT = 1 << 20


def sock_path() -> str:
    return os.environ.get(
        "PANDEPTH_DAEMON_SOCK",
        os.path.join(tempfile.gettempdir(),
                     f"pandepth-daemon-{os.getuid()}.sock"))


def code_token() -> str:
    """Cheap package-version fingerprint: newest mtime among the
    package's top-level sources (covers the compiled-in native lib
    too, whose rebuild touches its directory) plus the
    platform-determining env. jax's backend/cache config is applied
    once per process at daemon start, so a client whose platform env
    differs (e.g. a CPU-forced test vs a GPU run) must NOT reuse a
    running daemon — the env rides the token, the daemon answers
    ``stale`` and exits, and the client respawns under its own env."""
    pkg = os.path.dirname(os.path.abspath(__file__))
    newest = 0.0
    for root, dirs, files in os.walk(pkg):
        if "_build" in root or "__pycache__" in root:
            continue
        for f in files:
            if f.endswith((".py", ".cpp")):
                try:
                    m = os.stat(os.path.join(root, f)).st_mtime
                except OSError:
                    continue
                if m > newest:
                    newest = m
    env = "|".join(os.environ.get(k, "") for k in
                   ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR",
                    "CUDA_VISIBLE_DEVICES", "XLA_FLAGS"))
    return f"{newest:.6f}|{env}"


def _recv_request(conn):
    """One request: (json dict, [fds]). The client half-closes after
    sending, so read to EOF — a stream socket may split the JSON
    across recvs (the SCM_RIGHTS fds ride the first chunk).

    Owns the received fds until successful return: every failure path
    (empty request, oversized/undecodable payload, socket timeout mid
    read) closes them — SCM_RIGHTS fds arrive before the payload is
    validated and would otherwise leak toward EMFILE in a long-lived
    daemon."""
    fds = []
    try:
        msg, fds, _flags, _addr = socket.recv_fds(conn, _REQ_LIMIT, 3)
        fds = list(fds)
        if not msg:
            raise ValueError("empty request")
        buf = bytearray(msg)
        while len(buf) < _REQ_LIMIT:
            part = conn.recv(65536)
            if not part:
                break
            buf += part
        req = json.loads(bytes(buf).decode())
    except (OSError, ValueError):
        for fd in fds:
            try:
                os.close(fd)
            except OSError:
                pass
        return None, []
    return req, fds


class _Server:
    def __init__(self, path: str):
        self.path = path
        self.token = code_token()
        self.lock = threading.Lock()
        self.stop = False

    def _run_one(self, req, fds):
        """Execute one CLI request under the caller's cwd/fds; returns
        the reply dict. The caller's PANDEPTH_* env REPLACES the
        daemon's for the duration (vars the daemon inherited at spawn
        but absent from the request are removed — they are read at run
        time, not import time — so runs behave exactly like a fresh
        process with the client's env). No exception may escape: the
        daemon must survive dead cwds, bad fds, and string SystemExit
        codes."""
        from pandepth_jax.cli import main as cli_main

        saved_fds = [os.dup(i) for i in range(3)]
        saved_cwd = os.getcwd()
        saved_env = {}
        rc = 1
        try:
            try:
                for i, fd in enumerate(fds[:3]):
                    os.dup2(fd, i)
                req_env = {k: v
                           for k, v in (req.get("env") or {}).items()
                           if k.startswith("PANDEPTH_")}
                mine = [k for k in os.environ
                        if k.startswith("PANDEPTH_")]
                for k in set(mine) | set(req_env):
                    saved_env[k] = os.environ.get(k)
                for k in mine:
                    if k not in req_env:
                        del os.environ[k]
                os.environ.update(req_env)
                os.chdir(req.get("cwd") or "/")
                rc = int(cli_main(["pandepth"] + list(req["argv"])))
            except SystemExit as e:
                # CPython: sys.exit(str) prints to stderr, exits 1
                if e.code is None:
                    rc = 0
                elif isinstance(e.code, int):
                    rc = e.code
                else:
                    print(e.code, file=sys.stderr)
                    rc = 1
            except BaseException as e:  # never kill the daemon
                try:
                    print(f"Error: {e}", file=sys.stderr)
                except OSError:
                    pass
                rc = 1
        finally:
            try:
                sys.stdout.flush()
                sys.stderr.flush()
            except OSError:
                pass
            try:
                os.chdir(saved_cwd)
            except OSError:  # daemon home vanished: any stable cwd
                os.chdir("/")
            for k, v in saved_env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            for i, fd in enumerate(saved_fds):
                os.dup2(fd, i)
                os.close(fd)
            for fd in fds:
                os.close(fd)
        import resource

        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0
        return {"rc": rc, "rss_mb": round(rss, 1)}

    def serve(self, idle_s: float, ready_fd: int = -1) -> int:
        global IN_PROCESS_DAEMON
        IN_PROCESS_DAEMON = True
        try:
            os.unlink(self.path)
        except OSError:
            pass
        srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        srv.bind(self.path)
        os.chmod(self.path, 0o600)
        srv.listen(16)
        srv.settimeout(idle_s)
        # remember which inode WE bound: a replacement daemon may have
        # re-created the path by the time this one exits, and deleting
        # the replacement's socket would orphan it (clients would spawn
        # a third daemon while it sits on the device until idle-exit)
        try:
            bound = os.stat(self.path)
        except OSError:
            bound = None
        if ready_fd >= 0:  # spawner handshake
            os.write(ready_fd, b"R")
            os.close(ready_fd)
        # warm the heavy imports before the first request lands
        from pandepth_jax import boot

        boot.background()
        # a hung/stopped client must not wedge the single-threaded
        # daemon: the accepted socket gets its own recv/send deadline
        # (the run itself is not under this timeout)
        req_timeout = float(os.environ.get(
            "PANDEPTH_DAEMON_REQ_TIMEOUT_S", "120"))
        try:
            while not self.stop:
                try:
                    conn, _ = srv.accept()
                except socket.timeout:
                    break  # idle: exit and free the device/socket
                with conn:
                    conn.settimeout(req_timeout)
                    req, fds = _recv_request(conn)
                    if req is None:
                        continue

                    def close_fds():
                        for fd in fds:
                            try:
                                os.close(fd)
                            except OSError:
                                pass
                    def send(obj) -> None:
                        try:
                            conn.sendall(json.dumps(obj).encode())
                        except OSError:
                            pass  # client went away mid-reply

                    if req.get("cmd") == "stop":
                        close_fds()
                        send({"rc": 0, "pid": os.getpid()})
                        break
                    if req.get("cmd") == "stat":
                        import resource

                        close_fds()
                        rss = resource.getrusage(
                            resource.RUSAGE_SELF).ru_maxrss / 1024.0
                        send({"rc": 0, "rss_mb": round(rss, 1)})
                        continue
                    if req.get("cmd") == "ping":
                        close_fds()
                        ok = req.get("token") == self.token
                        send({"rc": 0 if ok else 1})
                        if not ok:
                            break
                        continue
                    if req.get("token") != self.token:
                        close_fds()
                        send({"error": "stale"})
                        break  # exit: the client respawns fresh code
                    with self.lock:
                        reply = self._run_one(req, fds)
                    send(reply)
        finally:
            srv.close()
            try:
                if bound is not None:
                    st = os.stat(self.path)
                    if (st.st_ino, st.st_dev) == (bound.st_ino,
                                                  bound.st_dev):
                        os.unlink(self.path)
            except OSError:
                pass
        return 0


def serve_foreground() -> int:
    idle = float(os.environ.get("PANDEPTH_DAEMON_IDLE_S", "900"))
    return _Server(sock_path()).serve(idle)


def _spawn_daemon() -> bool:
    """Detached daemon via double fork; True once its socket is
    listening (the grandchild signals readiness over a pipe *after*
    bind+listen, so a racing client can't connect into the void)."""
    rfd, wfd = os.pipe()
    pid = os.fork()
    if pid == 0:  # child
        try:
            os.close(rfd)
            os.setsid()
            pid2 = os.fork()
            if pid2 > 0:
                os._exit(0)
            devnull = os.open(os.devnull, os.O_RDWR)
            for i in range(3):
                os.dup2(devnull, i)
            os.close(devnull)
            idle = float(os.environ.get("PANDEPTH_DAEMON_IDLE_S",
                                        "900"))
            _Server(sock_path()).serve(idle, ready_fd=wfd)
        finally:
            os._exit(0)
    os.close(wfd)
    os.waitpid(pid, 0)  # reap the intermediate child
    try:
        ready = os.read(rfd, 1) == b"R"
    finally:
        os.close(rfd)
    return ready


def _request(path: str, payload: dict, fds=()) -> dict:
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        conn.connect(path)
        msg = json.dumps(payload).encode()
        if fds:
            socket.send_fds(conn, [msg], list(fds))
        else:
            conn.sendall(msg)
        conn.shutdown(socket.SHUT_WR)
        buf = b""
        while True:
            part = conn.recv(65536)
            if not part:
                break
            buf += part
        return json.loads(buf.decode()) if buf else {"error": "closed"}
    finally:
        conn.close()


def _alive(pid: int) -> bool:
    """True while ``pid`` runs (a zombie has released its device)."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False


def stop_daemon(wait_s: float = 60.0) -> Optional[int]:
    """Stop the daemon listening on :func:`sock_path` and wait up to
    ``wait_s`` for its process to exit, so its device is free when
    this returns. Returns the daemon's pid, or None when none
    answered."""
    try:
        reply = _request(sock_path(), {"cmd": "stop"})
    except OSError:
        return None
    pid = reply.get("pid")
    if not isinstance(pid, int):
        return None
    deadline = time.monotonic() + wait_s
    while _alive(pid) and time.monotonic() < deadline:
        time.sleep(0.05)
    return pid


def release_device() -> None:
    """Before a direct run initializes JAX: stop the resident daemon
    on :func:`sock_path` so no two JAX processes hold one device (the second would
    find most of the device memory taken). No-op inside the daemon."""
    if IN_PROCESS_DAEMON:
        return
    pid = stop_daemon()
    if pid is not None:
        print(f"INFO: stopped the resident pandepth daemon (pid {pid}) "
              f"so this run can use the device", file=sys.stderr)


def client_main(argv) -> int:
    """Run one CLI invocation through the daemon, spawning it when
    absent or stale. Falls back to in-process on spawn failure."""
    path = sock_path()
    payload = {
        "argv": list(argv),
        "cwd": os.getcwd(),
        "token": code_token(),
        "env": {k: v for k, v in os.environ.items()
                if k.startswith("PANDEPTH_") and k != "PANDEPTH_DAEMON"},
    }
    for attempt in range(2):
        try:
            reply = _request(path, payload,
                             fds=[0, sys.stdout.fileno(),
                                  sys.stderr.fileno()])
            if "rc" in reply:
                return int(reply["rc"])
        except OSError:
            pass
        if attempt == 0 and not _spawn_daemon():
            break
    if os.environ.get("PANDEPTH_DAEMON_REQUIRE") == "1":
        # benches/tests: a silent in-process fallback would fake the
        # daemon's latency numbers — fail loudly instead
        print("Error: pandepth daemon unavailable", file=sys.stderr)
        return 1
    # daemon unavailable: run directly (never fail the user's job)
    from pandepth_jax.cli import main as cli_main

    return cli_main(["pandepth"] + list(argv))
