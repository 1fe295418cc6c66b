"""Multi-host execution over the network between hosts.

The reference is a single-process tool; its scale ceiling is one
host's cores (SURVEY.md §2.3). Here hosts join one jax.distributed
job: every process feeds its own read files/batches (read-batch data
parallelism over hosts), the global (dp, gs) mesh spans all chips, and
the same `sharded_coverage_step` runs unchanged — events cross chips
over NVLink within a host and the network across hosts (NCCL), and
the final tables are the same psum.

Typical batch-job usage (one process per host):

    from pandepth_jax.sharding.distributed import init_multihost
    init_multihost(coordinator="host0:8476", num_processes=4,
                   process_id=RANK)
    mesh = make_mesh()          # all devices across all hosts
    step = sharded_coverage_step(mesh, ...)

On a cluster that jax.distributed can detect (e.g. SLURM), call with
no arguments; otherwise pass all three topology arguments.
"""

from __future__ import annotations

from typing import Optional


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   local_device_ids=None) -> None:
    """jax.distributed.initialize with explicit or autodetected
    topology. Safe to call once per process, before any jax op."""
    import jax

    kwargs = {}
    if coordinator is not None:
        kwargs["coordinator_address"] = coordinator
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)


def process_read_shard(paths, process_index: Optional[int] = None,
                       process_count: Optional[int] = None):
    """Deterministic assignment of input files to this host: host i
    takes files i, i+P, i+2P, ... (multi-sample depth is additive, so
    any partition works)."""
    import jax

    pi = jax.process_index() if process_index is None else process_index
    pc = jax.process_count() if process_count is None else process_count
    return [p for k, p in enumerate(paths) if k % pc == pi]
