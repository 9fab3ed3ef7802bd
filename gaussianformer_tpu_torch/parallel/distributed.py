"""The process group of a multi-process run and host-level reductions
(gaussianformer_tpu/parallel/distributed.py, reference train.py:33-53 and
misc/metric_util.py:69-73).

A process group is set up whenever the environment names a world: torchrun's
``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK`` with ``MASTER_ADDR`` /
``MASTER_PORT``, or the JAX package's ``NUM_PROCESSES`` / ``PROCESS_ID``
with ``COORDINATOR_ADDRESS`` (host:port). That holds at a world of one too,
so that one process exercises the backend and the DDP wrapper. The
backend is NCCL for CUDA and gloo for the CPU. A group that cannot be set
up raises: there is no quiet fallback to one process.

    torchrun --standalone --nproc_per_node=N \\
        -m gaussianformer_tpu_torch.train --config prob_gs6400 ...
"""
from __future__ import annotations

import logging
import os
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger("gaussianformer_tpu_torch")


def _world_from_env() -> Tuple[int, int] | None:
    env = os.environ
    world = env.get("WORLD_SIZE", env.get("NUM_PROCESSES"))
    if world is None:
        return None
    return int(env.get("RANK", env.get("PROCESS_ID", "0"))), int(world)


def local_rank() -> int:
    """This process's card on its host: ``LOCAL_RANK`` (torchrun), else
    the rank."""
    env = os.environ
    return int(env.get("LOCAL_RANK", env.get("RANK",
                                             env.get("PROCESS_ID", "0"))))


def init_distributed(device="cuda") -> Tuple[int, int]:
    """Join the process group the environment names, once; ``device`` (a
    CUDA device unless the caller runs on the CPU) picks the backend and,
    for CUDA, this process's card becomes ``cuda:LOCAL_RANK``. Returns
    (rank, world size): (0, 1) when the environment names no world."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    world = _world_from_env()
    if world is None:
        return 0, 1
    rank, size = world
    cuda = torch.device(device).type == "cuda"
    backend = "nccl" if cuda else "gloo"
    if "MASTER_ADDR" in os.environ:
        # torchrun's agent may already serve the store at this address
        init_method = "env://"
    elif "COORDINATOR_ADDRESS" in os.environ:
        init_method = f"tcp://{os.environ['COORDINATOR_ADDRESS']}"
    else:
        raise RuntimeError(
            f"a world of {size} process(es) is named but no address: set "
            "MASTER_ADDR and MASTER_PORT (torchrun does) or "
            "COORDINATOR_ADDRESS")
    if cuda:
        torch.cuda.set_device(local_rank())
    try:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=size, rank=rank)
    except Exception as e:
        raise RuntimeError(f"process group init failed ({backend}, "
                           f"{init_method}, rank {rank} of {size}): {e}"
                           ) from e
    logger.info("distributed: rank %d of %d, backend %s", rank, size,
                backend)
    return rank, size


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier():
    """Wait for every process of the group; nothing without one."""
    if dist.is_initialized():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def all_reduce_sum_host(x) -> np.ndarray:
    """Sum a host array over the processes (reference dist.all_reduce of
    the MeanIoU counts); the array itself without a process group."""
    x = np.asarray(x)
    if not dist.is_initialized():
        return x
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t.cpu().numpy()


def shutdown_distributed():
    """Leave the process group, where there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()
