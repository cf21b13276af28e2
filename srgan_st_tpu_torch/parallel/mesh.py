"""The data-parallel group (port of srgan_st_tpu/parallel/mesh.py).

The JAX package builds a `jax.sharding.Mesh` with a 1-D ('data',) axis:
batches sharded along it, parameters replicated, and the gradient and
BatchNorm reductions either derived by GSPMD from the shardings or, under
`shard_map`, written out as `lax.pmean`. torch has no GSPMD, so the port's
step is always the explicit form: each process holds a replica and its
slice of the global batch, and the step averages gradients, metrics and
BatchNorm moments over the processes with `pmean` (JAX's
`train/steps.py` `_pmean_if_sharded`). `TPU.SHARD_MAP` is therefore no key
of the port, and only the 1-D ('data',) layout over all processes is
accepted.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class DataParallel:
    """The ('data',) group: `world_size` processes, this one `rank`.

    With one process every collective is the identity and costs nothing."""

    def __init__(self, world_size: int = 1, rank: int = 0):
        self.world_size = world_size
        self.rank = rank

    @property
    def active(self) -> bool:
        return self.world_size > 1

    def batch_slice(self, global_batch_size: int) -> slice:
        """This rank's contiguous share of a global batch."""
        from srgan_st_tpu_torch.parallel.distributed import process_slice

        return process_slice(global_batch_size, self.rank, self.world_size)

    @torch.no_grad()
    def broadcast_module(self, module: torch.nn.Module) -> None:
        """Every parameter and buffer of `module` from rank 0 (the JAX
        package's `replicated` device_put of the state)."""
        if self.active:
            for t in [*module.parameters(), *module.buffers()]:
                dist.broadcast(t.data, 0)

    def pmean(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """The mean over the ranks of each tensor (detached), in one
        all-reduce of their concatenation (f32)."""
        if not self.active or not tensors:
            return list(tensors)
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        dist.all_reduce(flat)
        flat /= self.world_size
        out, i = [], 0
        for t in tensors:
            out.append(flat[i:i + t.numel()].view(t.shape).to(t.dtype))
            i += t.numel()
        return out

    def pmean_differentiable(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the ranks on the differentiated path: its backward
        takes the mean of the incoming gradients over the ranks, as
        `lax.pmean`'s transpose does (sync-BN's moments)."""
        return _PMean.apply(t, self.world_size) if self.active else t

    def barrier(self) -> None:
        if self.active:
            dist.barrier()

    def require_capturable(self, key: str) -> None:
        """Raise unless a CUDA graph can hold this group's collectives:
        NCCL's are captured, gloo's (staged through the host) cannot be.
        One process makes none."""
        if self.active and dist.get_backend() != "nccl":
            raise ValueError(
                f"{key}=true: a CUDA graph cannot capture {dist.get_backend()} "
                f"collectives; run with --set {key}=false")


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, world_size):
        ctx.world_size = world_size
        out = t.clone()
        dist.all_reduce(out)
        return out / world_size

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        return grad / ctx.world_size, None


def make_mesh(config=None) -> DataParallel:
    """The data-parallel group over every process of the run (one process
    when no process group is up). TPU.MESH_SHAPE / MESH_AXES are accepted
    only as the 1-D ('data',) layout of that size; anything else raises."""
    from srgan_st_tpu_torch.parallel.distributed import process_info

    rank, world = process_info()
    if config is not None:
        shape, axes = config.TPU.MESH_SHAPE, tuple(config.TPU.MESH_AXES)
        if axes != ("data",) or (shape is not None and tuple(shape) != (world,)):
            raise ValueError(
                f"TPU.MESH_SHAPE={shape!r}, MESH_AXES={axes!r}: the port runs only "
                f"the 1-D ('data',) layout over its {world} process(es)")
    return DataParallel(world, rank)
