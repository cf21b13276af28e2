"""Multi-process runtime (port of srgan_st_tpu/parallel/distributed.py).

One process per GPU, joined by `torch.distributed`:

  1. every process calls `initialize_distributed()` once at entry (the
     warmup and train loops do);
  2. each process runs on its own GPU, LOCAL_RANK (or its process id)
     modulo the visible GPUs (`core/device.py` `rank_device`);
  3. each process's data source loads only its contiguous slice of every
     global batch (`process_slice`, wired through data/pipeline.py);
  4. the steps average gradients and metrics over the processes, and
     BatchNorm its moments (parallel/mesh.py, models/common.py).

Launch contract: set SRGAN_ST_COORDINATOR=host:port,
SRGAN_ST_NUM_PROCESSES=N and SRGAN_ST_PROCESS_ID=i (or pass them), and
start N identical processes; or start them with `torchrun`, whose
MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK / LOCAL_RANK are read when
the SRGAN_ST_* variables are absent. A single process needs nothing. The
backend is NCCL for CUDA devices and gloo on the CPU; `backend` overrides
it (two processes sharing one GPU need gloo: NCCL refuses a duplicate GPU).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def _int_env(*names: str):
    for name in names:
        v = os.environ.get(name)
        if v not in (None, ""):
            return int(v)
    return None


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device=None, backend: str | None = None) -> bool:
    """Idempotent `torch.distributed.init_process_group` entry hook.

    Arguments default to SRGAN_ST_COORDINATOR / SRGAN_ST_NUM_PROCESSES /
    SRGAN_ST_PROCESS_ID, then to torchrun's variables. Returns True when a
    process group is up (after initializing it), False for a plain
    single-process run (nothing set). `device` (the run's device, "cuda" by
    default) picks the backend: NCCL for CUDA, gloo for the CPU."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get("SRGAN_ST_COORDINATOR")
    # torchrun's variables, when the SRGAN_ST_* ones are absent: its agent
    # hosts the rendezvous store, which env:// joins
    torchrun = coordinator_address is None and bool(os.environ.get("MASTER_ADDR"))
    if num_processes is None:
        num_processes = _int_env("SRGAN_ST_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _int_env("SRGAN_ST_PROCESS_ID", "RANK")
    if coordinator_address is None and not torchrun and num_processes is None:
        return False
    if (coordinator_address is None and not torchrun) or num_processes is None \
            or process_id is None:
        raise ValueError(
            "a multi-process run needs a coordinator address, a process count "
            f"and a process id; got {coordinator_address!r}, {num_processes!r}, "
            f"{process_id!r}")
    dev = torch.device("cuda" if device is None else device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = rank_device(dev, process_id)
    init = "env://" if torchrun else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id, **kwargs)
    return True


def rank_device(device, process_id: int | None = None) -> torch.device:
    """This process's device: an indexed device as given; "cuda" as
    cuda:(LOCAL_RANK or the process id, modulo the visible GPUs); the CPU
    as the CPU. A CUDA device without a GPU raises (core/device.py)."""
    from srgan_st_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = _int_env("LOCAL_RANK")
    if local is None:
        local = process_id if process_id is not None else process_info()[0]
    return torch.device("cuda", local % torch.cuda.device_count())


def process_info(process_index: int | None = None,
                 process_count: int | None = None) -> tuple[int, int]:
    """(process_index, process_count), defaulting to the process group's
    (0, 1 without one). Overridable so the data slicing is testable in one
    process."""
    up = dist.is_initialized()
    if process_index is None:
        process_index = dist.get_rank() if up else 0
    if process_count is None:
        process_count = dist.get_world_size() if up else 1
    return process_index, process_count


def process_slice(global_batch_size: int, process_index: int | None = None,
                  process_count: int | None = None) -> slice:
    """This process's contiguous slice of a global batch: rows
    [i*B/P, (i+1)*B/P). An indivisible batch raises."""
    pi, pc = process_info(process_index, process_count)
    if global_batch_size % pc:
        raise ValueError(f"global batch {global_batch_size} not divisible by {pc} processes")
    local = global_batch_size // pc
    return slice(pi * local, (pi + 1) * local)


def is_coordinator() -> bool:
    """True on the process that writes checkpoints and logs (process 0)."""
    return process_info()[0] == 0
