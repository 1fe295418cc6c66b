"""2-process jax.distributed test (SURVEY.md §4.4): the sharded
coverage step over a global mesh spanning two CPU processes must match
the single-process engine."""

import os
import subprocess
import sys

import numpy as np
import pytest

_WORKER = r"""
import sys, os
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)  # 2 local devices/process
from pandepth_jax.sharding.distributed import init_multihost
init_multihost(coordinator="localhost:%PORT%", num_processes=2,
               process_id=int(sys.argv[1]))
import jax.numpy as jnp
import numpy as np
from pandepth_jax.device.layout import GenomeLayout
from pandepth_jax.sharding.mesh import make_mesh, sharded_coverage_step

rank = int(sys.argv[1])
n_dev = len(jax.devices())          # global devices (4)
assert n_dev == 4, n_dev
lengths = np.array([5000, 3000], np.int64)
layout = GenomeLayout(lengths)
mesh = make_mesh(jax.devices(), dp=1)

rng = np.random.RandomState(0)
n = 32 * n_dev
tid = rng.randint(0, 2, n).astype(np.int32)
pos = rng.randint(0, 2500, n).astype(np.int32)
flag = np.zeros(n, np.int32)
mapq = np.full(n, 60, np.int32)
opc = np.zeros(n, np.int32)
opl = rng.randint(10, 100, n).astype(np.int32)
per = n // n_dev
opr = (np.arange(n, dtype=np.int32) % per)

from jax.sharding import NamedSharding, PartitionSpec as P
sh = NamedSharding(mesh, P(("dp", "gs")))
dev_index = {d: i for i, d in enumerate(jax.devices())}
def put(a):
    # global array from per-process shards (device ids are not
    # sequential across processes; use mesh enumeration order)
    la = a.reshape(n_dev, per)
    local = [jax.device_put(la[dev_index[d]], d)
             for d in jax.local_devices()]
    return jax.make_array_from_single_device_arrays((n,), sh, local)

step = sharded_coverage_step(mesh, flags_mask=1796, min_mapq=-1,
                             min_dep=1)
bounds = jnp.asarray(layout.shard_bounds(n_dev))
seg_tid = np.array([0, 1], np.int32)
seg_lo = jnp.asarray(layout.offsets[seg_tid])
seg_hi = jnp.asarray(layout.offsets[seg_tid] + lengths)
cover, dsum = step(put(tid), put(pos), put(flag), put(mapq), put(opc),
                   put(opl), put(opr), jnp.asarray(layout.offsets),
                   jnp.asarray(layout.limits), bounds, seg_lo, seg_hi)
out = np.asarray(jax.device_get(cover)), np.asarray(jax.device_get(dsum))
print("RESULT", rank, out[0].tolist(), out[1].tolist(), flush=True)
"""


@pytest.mark.parametrize("port", [18476])
def test_two_process_distributed(tmp_path, port):
    script = _WORKER.replace("%PORT%", str(port))
    sp = str(tmp_path / "worker.py")
    with open(sp, "w") as fh:
        fh.write(script)
    env = dict(os.environ)
    env["PYTHONPATH"] = "/root/repo:" + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen([sys.executable, sp, str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, env=env,
                              text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed workers timed out (the 2-process "
                        "jax.distributed path regressed)")
        assert p.returncode == 0, \
            f"distributed worker failed: {err[-1500:]}"
        outs.append(out)

    results = [ln for o in outs for ln in o.splitlines()
               if ln.startswith("RESULT")]
    assert len(results) == 2
    # both ranks must agree
    a = results[0].split(" ", 2)[2]
    b = results[1].split(" ", 2)[2]
    assert a == b

    # single-process reference value
    from pandepth_jax.device.engine import CoverageEngine
    from pandepth_jax.device.layout import GenomeLayout
    from pandepth_jax.io.bam import ReadBatch

    rng = np.random.RandomState(0)
    n = 32 * 4
    lengths = np.array([5000, 3000], np.int64)
    tid = rng.randint(0, 2, n).astype(np.int32)
    pos = rng.randint(0, 2500, n).astype(np.int32)
    flag = np.zeros(n, np.int32)
    mapq = np.full(n, 60, np.int32)
    opc = np.zeros(n, np.int32)
    opl = rng.randint(10, 100, n).astype(np.int32)
    opr = np.arange(n, dtype=np.int32)
    eng = CoverageEngine(GenomeLayout(lengths))
    eng.add_batch(ReadBatch(tid, pos, flag, mapq,
                            np.ones(n, np.int32), opc, opl, opr))
    st = eng.segment_stats(np.array([0, 1], np.int32),
                           np.array([1, 1]), lengths)
    expect = f"{st.cover.tolist()} {st.depth_sum.tolist()}"
    assert a == expect, (a, expect)


_CLI_WORKER = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
from pandepth_jax.sharding.launch import main
rc = main(["launch", "--coordinator", "localhost:%PORT%",
           "--nprocs", "2", "--rank", sys.argv[1],
           "-i", sys.argv[2], "-o", sys.argv[3]] + sys.argv[4:])
print("RC", rc, flush=True)
sys.exit(rc)
"""


def test_multihost_cli_matches_single(tmp_path):
    """Full product path under jax.distributed: 2 processes x 2
    devices, each decoding its shard of a 2-file .list; rank 0's
    table must be byte-identical to the single-process CLI on the
    same .list."""
    import gzip

    from tests.fixtures import make_bam

    bam_a = str(tmp_path / "a.bam")
    bam_b = str(tmp_path / "b.bam")
    make_bam(bam_a, n=400, seed=52)
    make_bam(bam_b, n=300, seed=53)
    lst = str(tmp_path / "in.list")
    with open(lst, "w") as fh:
        fh.write(bam_a + "\n" + bam_b + "\n")

    sp = str(tmp_path / "cli_worker.py")
    with open(sp, "w") as fh:
        fh.write(_CLI_WORKER.replace("%PORT%", "18503"))
    env = dict(os.environ)
    env["PYTHONPATH"] = "/root/repo:" + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, sp, str(i), lst,
         str(tmp_path / f"mh{i}")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        text=True) for i in range(2)]
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost CLI workers timed out")
        assert p.returncode == 0, f"worker failed: {err[-2000:]}"

    # rank 0 wrote; rank 1 must not have
    assert os.path.exists(str(tmp_path / "mh0.chr.stat.gz"))
    assert not os.path.exists(str(tmp_path / "mh1.chr.stat.gz"))

    from pandepth_jax.cli import main as cli_main

    rc = cli_main(["pandepth", "-i", lst,
                   "-o", str(tmp_path / "single")])
    assert rc == 0
    with gzip.open(str(tmp_path / "mh0.chr.stat.gz"), "rb") as fh:
        a = fh.read()
    with gzip.open(str(tmp_path / "single.chr.stat.gz"), "rb") as fh:
        b = fh.read()
    assert a == b


def test_multihost_site_depth_matches_single(tmp_path):
    """Multihost ``-a``: 2 processes x 2 devices write the SiteDepth
    dump range-sharded (each rank emits its genome ranges' rows, rank
    0 assembles); content must be byte-identical to the single-process
    writer (reference src/PanDepth.cpp:4264-4284)."""
    import gzip

    from tests.fixtures import make_bam

    bam_a = str(tmp_path / "a.bam")
    bam_b = str(tmp_path / "b.bam")
    make_bam(bam_a, n=400, seed=61)
    make_bam(bam_b, n=300, seed=62)
    lst = str(tmp_path / "in.list")
    with open(lst, "w") as fh:
        fh.write(bam_a + "\n" + bam_b + "\n")

    sp = str(tmp_path / "cli_worker.py")
    with open(sp, "w") as fh:
        fh.write(_CLI_WORKER.replace("%PORT%", "18511"))
    env = dict(os.environ)
    env["PYTHONPATH"] = "/root/repo:" + env.get("PYTHONPATH", "")
    # every rank gets the SAME -o (the real deployment shape: one
    # command on a shared filesystem); parts are per-device-row so
    # ranks never collide
    procs = [subprocess.Popen(
        [sys.executable, sp, str(i), lst,
         str(tmp_path / "mh"), "-a"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        text=True) for i in range(2)]
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost -a workers timed out")
        assert p.returncode == 0, f"worker failed: {err[-2000:]}"

    site = str(tmp_path / "mh.SiteDepth.gz")
    assert os.path.exists(site)
    # no leftover part files
    leftovers = [f for f in os.listdir(str(tmp_path))
                 if ".SiteDepth.gz.part" in f]
    assert leftovers == [], leftovers

    from pandepth_jax.cli import main as cli_main

    rc = cli_main(["pandepth", "-i", lst, "-a",
                   "-o", str(tmp_path / "single")])
    assert rc == 0
    with gzip.open(site, "rb") as fh:
        a = fh.read()
    with gzip.open(str(tmp_path / "single.SiteDepth.gz"), "rb") as fh:
        b = fh.read()
    assert a and a == b
