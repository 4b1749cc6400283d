"""Multi-host coordination over torch.distributed.

The reference has no distributed backend at all — users hand-split the video
list and run one process per GPU, with `.done` markers making concurrent runs
idempotent (reference README.md:11, tools/denseflow.cpp:63-76). The port of
the JAX package's `denseflow_tpu/parallel/distributed.py`:

* `init_distributed()` joins a torch.distributed process group and returns
  (host_id, num_hosts) to feed the video-list shard filter in
  io.reader.expand_jobs;
* `.done` markers live on shared storage, preserving idempotent resume
  across hosts and restarts (the reference's checkpoint granularity);
* `allreduce_counters()` is the run's ONLY collective: a sum of the
  (videos, frames, flows) counters so host 0 can print the global summary.

The backend is always gloo: the one collective is three int64 counters on
the host, and NCCL would tie each process to a card for nothing.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from denseflow_tpu_torch.utils import Counters

# How long a host waits at start-up for the others to join the group.
INIT_TIMEOUT = datetime.timedelta(minutes=5)
# How long a host that has finished its shard waits at the counter
# all-reduce for the last one to finish its own: shards of a list take
# hours, and unevenly, so this is not INIT_TIMEOUT.
COUNTER_TIMEOUT = datetime.timedelta(days=7)

_TOPOLOGY_HELP = (
    "--distributed needs the topology: set DENSEFLOW_NUM_PROCESSES and "
    "DENSEFLOW_PROCESS_ID with --coordinator=HOST:PORT (host 0's address), "
    "or launch under torchrun (WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT)"
)

# the group of the counter all-reduce (COUNTER_TIMEOUT), while
# init_distributed's groups are up; None: the default group, where an
# embedding application made it
_counter_group = None


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Join a gloo process group and return (host_id, num_hosts) for
    video-list sharding.

    Resolution order for the topology:
    1. explicit arguments;
    2. DENSEFLOW_NUM_PROCESSES / DENSEFLOW_PROCESS_ID env vars (the manual
       launch path — the coordinator comes from --coordinator=HOST:PORT,
       a `tcp://` init method; host 0 listens there);
    3. a launcher's environment (torchrun's WORLD_SIZE, RANK, MASTER_ADDR,
       MASTER_PORT) through `env://`.
    With none of them it raises a ValueError that names what to set. One
    process (num_processes <= 1) runs alone, without a group. A second
    call only returns the topology.
    """
    global _counter_group
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if num_processes is None:
        num_processes = _env_int("DENSEFLOW_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("DENSEFLOW_PROCESS_ID")
    if num_processes is None:  # a launcher's environment
        num_processes = _env_int("WORLD_SIZE")
        if process_id is None:
            process_id = _env_int("RANK")
    if num_processes is None:
        raise ValueError(_TOPOLOGY_HELP)
    if num_processes <= 1:
        return 0, 1
    if process_id is None:
        raise ValueError(f"{num_processes} processes but no process id: {_TOPOLOGY_HELP}")
    if coordinator_address:
        init_method = f"tcp://{coordinator_address}"
    elif os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        init_method = "env://"
    else:
        raise ValueError(f"no coordinator address: {_TOPOLOGY_HELP}")
    dist.init_process_group("gloo", init_method=init_method, world_size=num_processes,
                            rank=process_id, timeout=INIT_TIMEOUT)
    _counter_group = dist.new_group(backend="gloo", timeout=COUNTER_TIMEOUT)
    return dist.get_rank(), dist.get_world_size()


def shutdown_distributed() -> None:
    """Leave the groups init_distributed joined, so that their threads end
    before the interpreter does: a process that exits with them up aborts
    now and then ("terminate called without an active exception"). A group
    made by an embedding application is left as it is."""
    global _counter_group
    if _counter_group is not None:
        _counter_group = None
        dist.destroy_process_group()


def allreduce_counters(counters: Counters) -> Tuple[int, int, int]:
    """Global (videos, frames, flows) across all hosts — one sum at end of
    run, mirroring the reference's final summary (src/denseflow_gpu.cpp:492-496)
    but aggregated over every host."""
    local = torch.tensor(
        [counters.total_videos, counters.total_frames, counters.total_flows],
        dtype=torch.int64,
    )
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.all_reduce(local, op=dist.ReduceOp.SUM, group=_counter_group)
    return tuple(int(x) for x in local.tolist())
