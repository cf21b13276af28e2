"""Throughput and tracing utilities (port of srgan_st_tpu/utils/profiling.py).

A patches/s-per-device meter (the training metric) and a `torch.profiler`
trace scope for kernel-level inspection; on a CUDA device, the timers and
the one-call profile that the bench (`tools/bench.py`, `tools/profile_step.py`)
and `chip_smoke.py` measure with, and `device_record`, the card's name and
power limit that every such number is written beside.
"""

from __future__ import annotations

import contextlib
import subprocess
import time

import numpy as np


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


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of fn() over `iters` runs, each between two
    CUDA events, after `warmup` runs."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def profile_once(fn, top: int = 10) -> dict:
    """Device activity over one fn() (torch.profiler, after one warm-up
    call). The device is busy over the union of the operations' spans:
    under programmatic dependent launch a kernel starts before the one it
    waits for ends, so spans overlap and their sum overstates the work.
    By name, the `top` largest as [name, span ms, start-to-start ms, count]:
    start-to-start runs from an operation's start to the next one's (to its
    own end for the last), so those times share out the window without
    overlap. `kernels` counts the kernels, `copies` the copies and memsets;
    the idle share is of the window from the first start to the last end."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # user-annotation ranges on the device timeline (the optimizer's
    # "Optimizer.step#...") span kernels counted on their own
    ops = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False))
    span, s2s, count = {}, {}, {}
    busy, run_end = 0.0, None
    for i, (start, end, name) in enumerate(ops):
        nxt = ops[i + 1][0] if i + 1 < len(ops) else end
        span[name] = span.get(name, 0.0) + (end - start) / 1e3
        s2s[name] = s2s.get(name, 0.0) + (nxt - start) / 1e3
        count[name] = count.get(name, 0) + 1
        lo = start if run_end is None else max(start, run_end)
        busy += max(end - lo, 0) / 1e3
        run_end = end if run_end is None else max(run_end, end)
    window = (run_end - ops[0][0]) / 1e3 if ops else 0.0
    copies = sum(n for name, n in count.items() if name.startswith(("Memcpy", "Memset")))
    ranked = sorted(span, key=lambda name: -span[name])[:top]
    return {"device_busy_ms": busy, "device_window_ms": window,
            "idle_share": 1 - busy / window if window else None,
            "kernels": len(ops) - copies, "copies": copies,
            "top_ms": [[name[:100], span[name], s2s[name], count[name]] for name in ranked]}


def device_ms(fn, calls: int = 20, reps: int = 3) -> float:
    """The device's milliseconds per fn(): median over `reps` of CUDA
    events around `calls` calls queued behind ~10 ms of device sleep, so
    that the host has enqueued every call before the device reaches the
    first and the device runs them back to back. A call that is shorter on
    the device than on the host (one small kernel behind a Python wrapper)
    is timed by its device work, where `cuda_ms` times the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def device_record(device) -> dict:
    """{"name", "power_limit_w"} of the device a measurement ran on: on a
    CUDA device the card as `nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader` gives it (a card may be set below its maximum,
    and then runs slower under load); {"name": "cpu", "power_limit_w": None}
    on the CPU. No nvidia-smi on a CUDA machine raises: a card's number
    without the card's name is not kept."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit_w": None}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60, check=True)
    name, limit = (s.strip() for s in out.stdout.strip().splitlines()[0].rsplit(",", 1))
    try:
        watts = float(limit.split()[0])
    except ValueError:  # "[N/A]": the card reports no limit
        watts = None
    return {"name": name, "power_limit_w": watts}
