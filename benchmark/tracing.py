"""The traced sub-window: `torch.profiler` over whole units of the cell's
work, reduced to the record that the per-layer readers (benchmark/metrics)
read and to the result line's `breakdown`.

The busy and idle arithmetic is that of `profile_once` in
srgan_st_tpu_torch/utils/profiling.py: the device is busy over the union
of its operations' spans (under programmatic dependent launch a kernel
starts before the one it waits for ends, so spans overlap and their sum
overstates the work), and the window runs from the first operation's
start to the last one's end."""

from __future__ import annotations

import bisect

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

TOP = 10


def union(intervals) -> list[tuple[float, float]]:
    """Merged (start, end) intervals of a sorted-or-not iterable."""
    out: list[list[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def covered(intervals) -> float:
    return sum(b - a for a, b in union(intervals))


def _host_at(host, starts, t: float) -> str:
    """The innermost host event running at time t: the latest-starting one
    of those that contain it."""
    i = bisect.bisect_right(starts, t)
    best = None
    for j in range(i - 1, max(i - 4000, 0) - 1, -1):
        s, e, name = host[j]
        if e >= t:
            best = name
            break
    return best or "(no host event)"


def summed(counts: list[dict]) -> dict:
    """Counters of the profiled units added up (the first call of `unit`,
    unprofiled, is not among them)."""
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def profile_units(unit, n: int = 1) -> dict:
    """Run unit() once unprofiled (the profiler's own start-up), then n
    times under torch.profiler; each unit ends synchronized. Returns the
    reduced record: device ops as (name, start s, end s), busy and window
    seconds, the top device ops and idle gaps."""
    unit()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            with record_function("bench.unit"):
                unit()
        torch.cuda.synchronize()
    device, host = [], []
    for e in prof.events():
        if getattr(e, "is_user_annotation", False) and e.device_type == DeviceType.CUDA:
            continue  # annotation ranges on the device timeline span counted kernels
        rng = (e.time_range.start / 1e6, e.time_range.end / 1e6, e.name)
        (device if e.device_type == DeviceType.CUDA else host).append(rng)
    return reduce_events(device, host)


def reduce_events(device, host) -> dict:
    """The record of device ops and host events, both (start s, end s,
    name)."""
    device = sorted(device)
    if not device:
        return {"ops": [], "busy_s": 0.0, "window_s": 0.0, "device_ops": [], "idle_gaps": []}
    busy = union((s, e) for s, e, _ in device)
    t0, t1 = busy[0][0], busy[-1][1]
    by_name: dict[str, float] = {}
    for s, e, name in device:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    host = sorted(host)
    starts = [h[0] for h in host]
    gaps: dict[str, float] = {}
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        name = _host_at(host, starts, 0.5 * (end + nxt))
        gaps[name] = gaps.get(name, 0.0) + (nxt - end)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"ops": device, "busy_s": sum(b - a for a, b in busy), "window_s": t1 - t0,
            "device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": [[n[:120], s] for n, s in idle]}
