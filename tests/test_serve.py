"""Resident serve mode (pandepth_jax/serve.py): a foreground server
answers CLI runs shipped over the unix socket with byte-identical
outputs, honors per-request cwd, survives bad requests, and refuses
stale-code clients."""

import gzip
import json
import os
import socket
import subprocess
import sys
import time

import pytest

from tests.fixtures import make_bam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCHER = os.path.join(REPO, "pandepth")


def _serve_env(sock):
    env = dict(os.environ)
    env.update({
        "PANDEPTH_DAEMON_SOCK": sock,
        "JAX_PLATFORMS": "cpu",
        "PANDEPTH_DAEMON_IDLE_S": "120",
        # keep daemon-side runs cheap (same knobs as conftest)
        "PANDEPTH_ENC_CAP": str(1 << 14),
        "PANDEPTH_ENC_EXC": str(1 << 11),
    })
    return env


def _direct_env(env):
    """A direct run's env pointed at a socket no daemon listens on: a
    direct run stops the daemon it finds on its socket (one jax
    process per device)."""
    return dict(env, PANDEPTH_DAEMON_SOCK=env["PANDEPTH_DAEMON_SOCK"]
                + ".direct")


def _wait_sock(path, timeout=60.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if os.path.exists(path):
            return
        time.sleep(0.1)
    raise TimeoutError("daemon socket never appeared")


def _client(env, args, cwd, check=True):
    env = dict(env, PANDEPTH_DAEMON="1", PANDEPTH_DAEMON_REQUIRE="1")
    p = subprocess.run([sys.executable, "-S", LAUNCHER] + args,
                       env=env, cwd=cwd, capture_output=True,
                       text=True, timeout=300)
    if check:
        assert p.returncode == 0, p.stderr[-2000:]
    return p


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    bam = str(d / "t.bam")
    make_bam(bam, n=300, seed=3)
    sock = str(d / "d.sock")
    env = _serve_env(sock)
    srv = subprocess.Popen([sys.executable, "-S", LAUNCHER, "--serve"],
                           env=env, stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL)
    _wait_sock(sock)
    state = {"dir": str(d), "bam": bam, "sock": sock, "env": env,
             "srv": srv}
    yield state
    srv = state["srv"]  # a test may have replaced the server
    if srv.poll() is None:
        subprocess.run([sys.executable, "-S", LAUNCHER,
                        "--daemon-stop"], env=env, timeout=60)
        try:
            srv.wait(timeout=30)
        except subprocess.TimeoutExpired:
            srv.kill()


def test_serve_matches_direct(served, tmp_path):
    d = served["dir"]
    _client(served["env"], ["-i", served["bam"], "-o", "srv1"], d)
    # direct in-process oracle run of the same config
    direct = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, %r);"
         "import jax; jax.config.update('jax_platforms','cpu');"
         "from pandepth_jax.cli import main;"
         "sys.exit(main(['pandepth','-i',%r,'-o','direct1']))"
         % (REPO, served["bam"])],
        cwd=str(tmp_path), env=_direct_env(served["env"]),
        capture_output=True, timeout=300)
    assert direct.returncode == 0, direct.stderr[-2000:]
    with gzip.open(os.path.join(d, "srv1.chr.stat.gz")) as fh:
        a = fh.read()
    with gzip.open(str(tmp_path / "direct1.chr.stat.gz")) as fh:
        b = fh.read()
    assert a == b


def test_serve_second_run_and_cwd(served, tmp_path):
    """Requests land in the caller's cwd, and a warm daemon keeps
    serving after the first request."""
    _client(served["env"], ["-i", served["bam"], "-o", "srv2"],
            str(tmp_path))
    assert os.path.exists(str(tmp_path / "srv2.chr.stat.gz"))
    assert served["srv"].poll() is None


def test_serve_propagates_exit_code(served):
    p = _client(served["env"], ["-i", "/nonexistent.bam", "-o", "x"],
                served["dir"], check=False)
    assert p.returncode != 0
    assert "Error" in p.stderr
    assert served["srv"].poll() is None  # daemon survives bad runs


def test_serve_stale_token_refused(served):
    """A client whose code token mismatches gets 'stale' and the
    daemon exits (so a respawn picks up fresh code)."""
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    conn.connect(served["sock"])
    payload = {"argv": ["-i", served["bam"], "-o", "nope"],
               "cwd": served["dir"], "token": "0.0", "env": {}}
    socket.send_fds(conn, [json.dumps(payload).encode()],
                    [0, 1, 2])
    conn.shutdown(socket.SHUT_WR)
    buf = conn.recv(65536)
    conn.close()
    assert json.loads(buf.decode()).get("error") == "stale"
    served["srv"].wait(timeout=30)
    # respawn a fresh server for the remaining fixture teardown path
    srv = subprocess.Popen([sys.executable, "-S", LAUNCHER, "--serve"],
                           env=served["env"],
                           stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL)
    _wait_sock(served["sock"])
    served["srv"] = srv


def test_run_one_env_replacement_and_errors(tmp_path, monkeypatch):
    """_run_one must (a) REPLACE the daemon's PANDEPTH_* env with the
    request's — a var the daemon inherited at spawn but absent from
    the request must not leak into the run; (b) survive a dead cwd and
    a string SystemExit without killing the daemon; (c) restore env
    afterwards."""
    from pandepth_jax import serve as srv_mod

    s = srv_mod._Server(str(tmp_path / "x.sock"))
    monkeypatch.setenv("PANDEPTH_TEST_INHERITED", "1")

    seen = {}

    def fake_main(argv):
        seen["inherited"] = os.environ.get("PANDEPTH_TEST_INHERITED")
        seen["sent"] = os.environ.get("PANDEPTH_TEST_SENT")
        seen["cwd"] = os.getcwd()
        return 0

    monkeypatch.setattr("pandepth_jax.cli.main", fake_main)
    fds = [os.open(os.devnull, os.O_RDONLY),
           os.open(os.devnull, os.O_WRONLY),
           os.open(os.devnull, os.O_WRONLY)]
    reply = s._run_one({"argv": ["-h"], "cwd": str(tmp_path),
                        "env": {"PANDEPTH_TEST_SENT": "yes"}}, fds)
    assert reply["rc"] == 0
    assert seen["inherited"] is None      # removed for the run
    assert seen["sent"] == "yes"
    assert os.environ.get("PANDEPTH_TEST_INHERITED") == "1"  # restored
    assert "PANDEPTH_TEST_SENT" not in os.environ

    # dead cwd: rc != 0, no exception escapes
    gone = tmp_path / "gone"
    gone.mkdir()
    gone.rmdir()
    fds = [os.open(os.devnull, os.O_RDONLY),
           os.open(os.devnull, os.O_WRONLY),
           os.open(os.devnull, os.O_WRONLY)]
    reply = s._run_one({"argv": [], "cwd": str(gone), "env": {}}, fds)
    assert reply["rc"] != 0

    # string SystemExit: CPython prints it and exits 1
    def exit_main(argv):
        raise SystemExit("boom")

    monkeypatch.setattr("pandepth_jax.cli.main", exit_main)
    fds = [os.open(os.devnull, os.O_RDONLY),
           os.open(os.devnull, os.O_WRONLY),
           os.open(os.devnull, os.O_WRONLY)]
    reply = s._run_one({"argv": [], "cwd": str(tmp_path), "env": {}},
                       fds)
    assert reply["rc"] == 1


def test_direct_run_stops_resident_daemon(tmp_path):
    """One JAX process per device: a direct (PANDEPTH_DAEMON=0) device
    run stops this socket's resident daemon, and waits for its process
    to exit, before it initializes jax; its tables are unaffected."""
    bam = str(tmp_path / "t.bam")
    make_bam(bam, n=200, seed=9)
    sock = str(tmp_path / "d.sock")
    env = _serve_env(sock)
    srv = subprocess.Popen([sys.executable, "-S", LAUNCHER, "--serve"],
                           env=env, stdout=subprocess.DEVNULL,
                           stderr=subprocess.DEVNULL)
    try:
        _wait_sock(sock)
        r = subprocess.run(
            [sys.executable, "-S", LAUNCHER, "-i", bam, "-o",
             str(tmp_path / "direct")],
            env=dict(env, PANDEPTH_DAEMON="0"), capture_output=True,
            text=True, timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        assert f"stopped the resident pandepth daemon (pid {srv.pid})" \
            in r.stderr
        assert srv.wait(timeout=30) == 0   # already gone: no wait here
        assert os.path.exists(str(tmp_path / "direct.chr.stat.gz"))
        # nothing left to stop: a second direct run says nothing
        r2 = subprocess.run(
            [sys.executable, "-S", LAUNCHER, "-i", bam, "-o",
             str(tmp_path / "direct2")],
            env=dict(env, PANDEPTH_DAEMON="0"), capture_output=True,
            text=True, timeout=300)
        assert r2.returncode == 0, r2.stderr[-2000:]
        assert "stopped" not in r2.stderr
    finally:
        if srv.poll() is None:
            srv.kill()


@pytest.mark.parametrize("tmpdir_env", [True, False])
def test_sock_path_default_follows_tmpdir(tmp_path, monkeypatch,
                                          tmpdir_env):
    """Without PANDEPTH_DAEMON_SOCK the socket lives in the temporary
    directory (TMPDIR when set), keyed by uid: two checkouts run with
    their own TMPDIR never stop each other's daemon. The variable,
    when set, wins."""
    import tempfile

    from pandepth_jax import serve as srv_mod

    monkeypatch.delenv("PANDEPTH_DAEMON_SOCK", raising=False)
    if tmpdir_env:
        monkeypatch.setenv("TMPDIR", str(tmp_path))
    else:
        monkeypatch.delenv("TMPDIR", raising=False)
    monkeypatch.setattr(tempfile, "tempdir", None)  # re-read TMPDIR
    want_dir = str(tmp_path) if tmpdir_env else tempfile.gettempdir()
    assert srv_mod.sock_path() == os.path.join(
        want_dir, f"pandepth-daemon-{os.getuid()}.sock")
    monkeypatch.setenv("PANDEPTH_DAEMON_SOCK", str(tmp_path / "x.sock"))
    assert srv_mod.sock_path() == str(tmp_path / "x.sock")
