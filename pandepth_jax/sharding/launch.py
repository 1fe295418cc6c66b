"""Multi-host launcher: ``python -m pandepth_jax.sharding.launch``.

Accepts every pandepth CLI flag plus the multihost topology:

    python -m pandepth_jax.sharding.launch \
        --coordinator host0:8476 --nprocs 4 --rank $RANK \
        -i samples.list -o out

(on a cluster that jax.distributed can detect, e.g. SLURM, the three
topology flags can be omitted). Each process decodes its
modulo shard of the input files (sharding/distributed.py
process_read_shard), events cross the global mesh through the
range-bucketed all_to_all, every process computes identical tables,
and process 0 writes them. The single-process CLI stays
``python -m pandepth_jax.cli``.
"""

from __future__ import annotations

import sys
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv if argv is None else argv)
    coordinator = nprocs = rank = None
    rest: List[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--coordinator":
            coordinator, i = argv[i + 1], i + 2
        elif a == "--nprocs":
            nprocs, i = int(argv[i + 1]), i + 2
        elif a == "--rank":
            rank, i = int(argv[i + 1]), i + 2
        else:
            rest.append(a)
            i += 1

    from pandepth_jax.sharding.distributed import (init_multihost,
                                                   process_read_shard)

    # run.make_engine must pick the multihost engine, never the
    # host-finalize fast path (election is env-only, pre-jax)
    import os

    os.environ["PANDEPTH_MULTIHOST"] = "1"
    init_multihost(coordinator=coordinator, num_processes=nprocs,
                   process_id=rank)

    from pandepth_jax.cli import parse_args
    from pandepth_jax.run import run

    config = parse_args(rest)   # rest[0] is the program name
    if config is None:
        return 1
    config.inputs = process_read_shard(config.inputs)
    return run(config)


if __name__ == "__main__":
    sys.exit(main())
