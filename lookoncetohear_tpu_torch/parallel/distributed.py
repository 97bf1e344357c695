"""Multi-process runtime (counterpart of
`lookoncetohear_tpu/parallel/distributed.py`).

The JAX package joins a `jax.distributed` cluster; the port joins a
`torch.distributed` process group, with NCCL on the card and gloo on
the CPU. Two ways in, both through the environment, so the trainer CLI
keeps its flags:

* **Explicit rendezvous** -- `LOOKONCE_COORDINATOR=host:port`,
  `LOOKONCE_NUM_PROCESSES=N`, `LOOKONCE_PROCESS_ID=i`, as for the JAX
  package (the group forms over `tcp://host:port`).
* **torchrun** -- `LOOKONCE_DIST=auto`: the rank, world size and
  rendezvous come from torchrun's `RANK`, `WORLD_SIZE`, `MASTER_ADDR`
  and `MASTER_PORT`. `launch.py` exports it.

With neither set, nothing happens and the helpers below answer as for
one process without a collective. In a group, of any size, they run
their collectives. Each rank drives one card: `LOCAL_RANK` (set by torchrun;
0 otherwise) picks it (`mesh.rank_device`).
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist


def maybe_initialize(device=None) -> bool:
    """Join the process group the environment asks for; True if this
    call joined one (False with no trigger set, or when this process is
    in a group already). `device` is the trainer's (None: the card):
    NCCL for a card, gloo for the CPU."""
    coord = os.environ.get("LOOKONCE_COORDINATOR")
    auto = os.environ.get("LOOKONCE_DIST") == "auto"
    if not (coord or auto) or dist.is_initialized():
        return False
    from lookoncetohear_tpu_torch.parallel.mesh import rank_device
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if coord:
        num = int(os.environ["LOOKONCE_NUM_PROCESSES"])
        pid = int(os.environ["LOOKONCE_PROCESS_ID"])
        dist.init_process_group(backend, init_method=f"tcp://{coord}",
                                world_size=num, rank=pid)
    else:
        dist.init_process_group(backend, init_method="env://")
    logging.info("torch.distributed (%s): process %d/%d", backend,
                 dist.get_rank(), dist.get_world_size())
    return True


def in_group() -> bool:
    """True once this process is in a process group (of any size)."""
    return dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """Rank 0, which alone writes metrics, checkpoints and tables."""
    return rank() == 0


def barrier() -> None:
    if in_group():
        dist.barrier()


def _reduce(values, op, dtype) -> list:
    """All-reduce a list of numbers over the ranks (on the card under
    NCCL, on the host under gloo)."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor(values, dtype=dtype, device=dev)
    dist.all_reduce(t, op=op)
    return t.tolist()


def agree_count(count: int, reduce: str) -> int:
    """The per-epoch batch count every rank runs: the minimum of the
    ranks' counts for training (at most one tail batch dropped, as a
    DistributedSampler with drop_last), the maximum for evaluation (a
    rank whose shard ran out feeds masked filler, so no item is lost).
    A rank running a step more than its peers would hang the
    collectives."""
    if not in_group():
        return count
    op = dist.ReduceOp.MAX if reduce == "max" else dist.ReduceOp.MIN
    return int(_reduce([count], op, torch.int64)[0])


def sum_over_ranks(values: list) -> list:
    """Float64 sums of `values` over the ranks."""
    if not in_group():
        return [float(v) for v in values]
    return _reduce([float(v) for v in values], dist.ReduceOp.SUM,
                   torch.float64)
