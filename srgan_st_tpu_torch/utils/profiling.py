"""Throughput and tracing utilities (port of srgan_st_tpu/utils/profiling.py).

A patches/s-per-device meter (the training metric) and a `torch.profiler`
trace scope for kernel-level inspection.
"""

from __future__ import annotations

import contextlib
import time


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class ThroughputMeter:
    """Steady-state patches/s per device, the first `warmup_steps` steps
    excluded. `n_chips` defaults to the process group's world size (one
    device a process)."""

    def __init__(self, n_chips: int | None = None, warmup_steps: int = 2):
        self.n_chips = n_chips or _world_size()
        self.warmup_steps = warmup_steps
        self.reset()

    def reset(self) -> None:
        self._steps = 0
        self._patches = 0
        self._start = None

    def step(self, n_patches: int) -> None:
        self._steps += 1
        if self._steps == self.warmup_steps:
            self._start = time.perf_counter()
            self._patches = 0
            return
        if self._steps > self.warmup_steps:
            self._patches += n_patches

    @property
    def patches_per_sec_per_chip(self) -> float:
        if self._start is None or self._patches == 0:
            return 0.0
        return self._patches / (time.perf_counter() - self._start) / self.n_chips


@contextlib.contextmanager
def trace_context(log_dir: str | None):
    """A torch.profiler trace (CPU and, where there is one, CUDA activity)
    over the block, exported to `log_dir` as a Chrome trace
    (`trace.json`, open in Perfetto or chrome://tracing); a no-op for
    None."""
    if log_dir is None:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
