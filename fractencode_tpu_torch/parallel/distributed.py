"""Multi-process bring-up (port of ``fractencode_tpu/parallel/distributed.py``).

The mesh's data axis is what crosses processes and hosts.  It carries no
device tensor, only host-side results: each process's share of the batch
(``host_local_batch``) and the reductions of its results (the pod driver's
checksums).  So the processes join a ``torch.distributed`` group on the
gloo backend over CPU tensors, which works as well with two processes on one
card as with one process on each of many hosts.  The search axis stays
inside a process (``mesh.py``): NCCL refuses two ranks on one card, and a
single-card machine could then never run a search axis wider than one.

A failure to join fails loudly, with the coordinator and the process id:
the recovery for a deterministic encoder is to rerun the failed work.
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

__all__ = ["initialize_multihost", "is_multihost", "host_local_batch"]


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         initialization_timeout: float | None = None) -> dict:
    """Join the process group; returns a summary dict.

    ``coordinator_address`` is ``host:port`` of process 0's rendezvous
    (``tcp://``).  The arguments default to torch's own environment
    variables, ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``
    (the JAX package reads JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES and
    JAX_PROCESS_ID, which are JAX's own).  ``initialization_timeout``
    (seconds, default 300, as JAX's) bounds how long a process waits for the
    others before failing.
    """
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    timeout = datetime.timedelta(seconds=300 if initialization_timeout is None
                                 else initialization_timeout)
    try:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("the coordinator address, the process count and the "
                             "process id are all needed (flags, or MASTER_ADDR/"
                             "MASTER_PORT, WORLD_SIZE and RANK)")
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
    except Exception as e:
        raise RuntimeError(
            "multi-host initialization failed "
            f"(coordinator={coordinator_address}, pid={process_id}): {e}. "
            "Each host must run the same program; check that the coordinator "
            "is reachable and every process uses a distinct process_id.") from e
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    total = torch.tensor([cards], dtype=torch.int64)
    dist.all_reduce(total)
    return dict(process_index=dist.get_rank(), process_count=dist.get_world_size(),
                local_devices=cards, global_devices=int(total))


def _process() -> tuple[int, int]:
    """(this process's index, the process count); (0, 1) outside a group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_multihost() -> bool:
    return _process()[1] > 1


def host_local_batch(global_batch: int) -> tuple[int, int]:
    """(per-process batch, offset of this process's slice) for even splits."""
    index, n = _process()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} hosts")
    per = global_batch // n
    return per, per * index
