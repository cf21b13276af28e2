"""Numerical-sanity utilities (port of srgan_st_tpu/utils/debugging.py).

GAN losses, above all the structure-tensor pipeline with its clamp / eps
guards, are where NaNs appear; these helpers catch them at the step
boundary without slowing the hot path when they are off.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaves(tree, path: str = ""):
    """(key path, leaf) of nested dicts, lists and tuples (a state dict is
    a dict)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def check_finite_tree(tree, name: str = "tree") -> None:
    """Raise FloatingPointError naming the key paths of every non-finite
    floating leaf (tensors, arrays, scalars). Reads the values on the host:
    a sync, so keep it off the hot path (log boundaries, checkpoints)."""
    bad = []
    for path, leaf in _leaves(tree):
        if torch.is_tensor(leaf):
            if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
                bad.append(path)
        else:
            arr = np.asarray(leaf)
            if arr.dtype.kind == "f" and not np.isfinite(arr).all():
                bad.append(path)
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")


def all_finite(metrics: dict) -> torch.Tensor:
    """A 0-dim bool tensor on the metrics' device: every value finite. No
    host sync."""
    return torch.stack([torch.isfinite(v.detach()).all() for v in metrics.values()]).all()


class nan_guard:
    """Wrap a step (or chunk step) whose last output is its metrics dict:
    after each call an all-finite flag of the metrics is formed on the
    device (a few kernels enqueued behind the step, or behind the chunk's
    graph replays) and copied, non-blocking, to pinned host memory; the host reads
    it at the next call (a chunk later, when the copy is long done) or at
    `flush()`, and prints "WARNING: non-finite training metrics" when it is
    false, as the JAX package's jax.debug callback does. On the CPU the
    flag is read at once. No host sync on the GPU."""

    def __init__(self, step_fn):
        self.step_fn = step_fn
        self._pending = None

    def __call__(self, *args, **kwargs):
        self.flush()
        out = self.step_fn(*args, **kwargs)
        flag = all_finite(out[-1])
        if flag.is_cuda:
            host = torch.empty((), dtype=torch.bool, pin_memory=True)
            host.copy_(flag, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            self._pending = (host, done)
        else:
            self._pending = (flag, None)
            self.flush()
        return out

    def flush(self) -> None:
        """Read the pending flag (waiting for its copy) and warn on it."""
        if self._pending is None:
            return
        host, done = self._pending
        self._pending = None
        if done is not None:
            done.synchronize()
        if not bool(host):
            print("WARNING: non-finite training metrics", flush=True)
