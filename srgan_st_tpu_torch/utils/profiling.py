"""Spans, capture maps and traces of the port, and its timers (port of
srgan_st_tpu/utils/profiling.py).

`span(name, args)` marks a region of the program. While a `torch.profiler`
session runs it is a `record_function`, so the region lies on the
profiler's clock beside the device ops it launched; otherwise it is one
shared no-op context. `args` is the training step or the frame number; a
span without it takes its parent's, so every span of a batch or a frame
carries the same one. The open spans form one process-wide stack: G's
backward runs on autograd's device thread while the caller waits inside
`g.backward`, and its spans nest under that one.

The spans (PERF.md lists the metric that reads each):

  train.chunk, train.batch            train/steps.py chunk steps
  graph.copy_in, graph.launch.<kind>  train/graphs.py, a replay (<kind>
                                      warmup, g or gan)
  graph.capture.<kind>                train/graphs.py, the first call
  step.prepare                        _prepare_batch (/255, MATLAB bicubic)
  g.forward: g.stem, g.trunk,         models/generator.py (g.tail: conv3 or
    g.upsample, g.tail                kernel A or B, and the clamp)
  loss.<criterion>                    _criterion_sum (the adversarial term
                                      holds d.forward)
  g.backward, d.step: d.forward,      train/steps.py, models/discriminator.py
    d.backward, optim.d
  step.allreduce                      _pmean_step, with a process group
  optim.g, optim.d                    Adam.step
  kernel.<launch counter name>        kernels/*.py, the library call: the
                                      names of `kernels.launch_counts()`
  serve.frame                         eval/validate.py make_generator_apply

A replay runs no Python, so a replayed op's region comes from its graph's
capture: while a step is captured (`capture_regions`), each span boundary
reads the count of the graph's nodes, which puts down the nodes captured
since the last boundary to the region open meanwhile. `trace_context`
writes a Chrome trace; `tools/profile_step.py` labels its device ops by
these regions.

On a CUDA device, the timers and the one-call profile that the bench
(`tools/bench.py`, `tools/profile_step.py`) and `chip_smoke.py` measure
with, and `device_record`, the card's name and power limit that every such
number is written beside.
"""

from __future__ import annotations

import contextlib
import ctypes
import subprocess

import numpy as np
import torch
from torch.profiler import record_function

# The profiler's switch, read at each span (a C call).
_profiling = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()
# (name, args) of the open spans, process-wide
_stack: list[tuple[str, object]] = []
# the capture map of the graph being captured, if any
_capture: CaptureMap | None = None

# CUgraphNodeType of the nodes a profiler reports as device ops: kernels,
# copies and memsets
_ACTIVITY_NODES = (0, 1, 2)


def span(name: str, args=None):
    """A region of the program named `name` (PERF.md's table): a
    `record_function` while a profiler runs, and a boundary of the capture
    map while a graph is captured; else the shared no-op."""
    if _capture is None and not _profiling():
        return _NULL
    return _Span(name, args)


class _Span:
    __slots__ = ("name", "args", "_entry", "_record")

    def __init__(self, name: str, args):
        self.name, self.args = name, args

    def __enter__(self):
        if self.args is None and _stack:
            self.args = _stack[-1][1]
        if _capture is not None:
            _capture.mark(_path())
        self._entry = (self.name, self.args)
        _stack.append(self._entry)
        self._record = None
        if _profiling():
            self._record = record_function(self.name,
                                           None if self.args is None else str(self.args))
            self._record.__enter__()
        return self

    def __exit__(self, *exc):
        if self._record is not None:
            self._record.__exit__(*exc)
        if _capture is not None:
            _capture.mark(_path())
        assert _stack[-1] is self._entry, "spans closed out of order"
        _stack.pop()
        return False


@contextlib.contextmanager
def spans_off():
    """The program's spans record nothing in the block, even under a
    profiler (a capture still maps its nodes): a traced run without them,
    for their cost (`tools/profile_step.py --spans-cost`)."""
    global _profiling
    _profiling = _never
    try:
        yield
    finally:
        _profiling = torch.autograd._profiler_enabled


def _never() -> bool:
    return False


def _path() -> str:
    """The open spans inside the capture, outermost first."""
    return "/".join(name for name, _ in _stack[_capture.base:])


class CaptureMap:
    """The region path of each node of a graph being captured. `count()`
    gives the graph's node count so far; `mark(path)`, at every span
    boundary, puts down the nodes added since the last boundary to `path`,
    the region that was open while they were captured."""

    def __init__(self, count, base: int):
        self.count, self.base = count, base
        self.first = self.seen = count()
        self.segments: list[tuple[int, str]] = []  # (node count at its end, path)
        self.labels: list[str] = []

    def mark(self, path: str) -> None:
        n = self.count()
        if n > self.seen:
            self.segments.append((n, path))
            self.seen = n

    def close(self, kinds: list[int]) -> list[str]:
        """The path of each activity node (kernel, copy, memset) in capture
        order, given every node's CUgraphNodeType in creation order."""
        self.labels, i = [], self.first
        for end, path in self.segments:
            self.labels += [path for k in kinds[i:end] if k in _ACTIVITY_NODES]
            i = end
        return self.labels


@contextlib.contextmanager
def capture_regions(nodes):
    """Inside a graph's capture: the spans opened in the block mark the
    capture map of `nodes` (`count()`, the node count so far; `kinds()`,
    every node's type in creation order, read at the end). Yields the map,
    whose `labels` the end fills in."""
    global _capture
    if _capture is not None:
        raise RuntimeError("capture_regions: a capture is already being mapped")
    cmap = _capture = CaptureMap(nodes.count, len(_stack))
    try:
        yield cmap
        cmap.mark(_path())
        cmap.close(nodes.kinds())
    finally:
        _capture = None


class GraphNodes:
    """The nodes of the graph being captured on the CUDA stream `stream`
    (a `cudaStream_t` as an int), through the CUDA driver's API by ctypes:
    nothing is built."""

    def __init__(self, stream: int):
        self.lib = _libcuda()
        status, ident = ctypes.c_int(0), ctypes.c_ulonglong(0)
        self.graph = ctypes.c_void_p()
        _cu(self.lib.cuStreamGetCaptureInfo_v2(ctypes.c_void_p(stream), ctypes.byref(status),
                                               ctypes.byref(ident), ctypes.byref(self.graph),
                                               None, None), "cuStreamGetCaptureInfo")
        if status.value != 1:  # CU_STREAM_CAPTURE_STATUS_ACTIVE
            raise RuntimeError("GraphNodes: the stream is not capturing")

    def count(self) -> int:
        n = ctypes.c_size_t(0)
        _cu(self.lib.cuGraphGetNodes(self.graph, None, ctypes.byref(n)), "cuGraphGetNodes")
        return n.value

    def kinds(self) -> list[int]:
        n = ctypes.c_size_t(self.count())
        nodes = (ctypes.c_void_p * n.value)()
        _cu(self.lib.cuGraphGetNodes(self.graph, nodes, ctypes.byref(n)), "cuGraphGetNodes")
        kind, out = ctypes.c_int(0), []
        for node in nodes[:n.value]:
            _cu(self.lib.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
                "cuGraphNodeGetType")
            out.append(kind.value)
        return out


_LIBCUDA: list = []


def _libcuda():
    if not _LIBCUDA:
        lib = ctypes.CDLL("libcuda.so.1")
        p = ctypes.c_void_p
        lib.cuStreamGetCaptureInfo_v2.argtypes = [p, p, p, p, p, p]
        lib.cuGraphGetNodes.argtypes = [p, p, p]
        lib.cuGraphNodeGetType.argtypes = [p, p]
        for fn in (lib.cuStreamGetCaptureInfo_v2, lib.cuGraphGetNodes, lib.cuGraphNodeGetType):
            fn.restype = ctypes.c_int
        _LIBCUDA.append(lib)
    return _LIBCUDA[0]


def _cu(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed with CUresult {err}")


# ---------------------------------------------------------------------------
# traces

def union(intervals) -> list[tuple[float, float]]:
    """Merged (start, end) intervals."""
    out: list[list[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def covered(intervals) -> float:
    return sum(b - a for a, b in union(intervals))


@contextlib.contextmanager
def trace_context(log_dir: str | None):
    """A torch.profiler trace (CPU and, where there is one, CUDA activity)
    over the block, the program's spans in it, exported to `log_dir` as a
    Chrome trace (`trace.json`, open in Perfetto or chrome://tracing).
    Yields the profiler (read its events after the block); a no-op
    yielding None for None."""
    if log_dir is None:
        yield None
        return
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of fn() over `iters` runs, each between two
    CUDA events, after `warmup` runs."""
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
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return device_summary(prof, top)


def device_summary(prof, top: int = 10) -> dict:
    """`profile_once`'s record of a finished torch.profiler profile."""
    from torch.autograd import DeviceType

    # user-annotation ranges on the device timeline (the optimizer's
    # "Optimizer.step#...") span kernels counted on their own
    ops = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False))
    span, s2s, count = {}, {}, {}
    for i, (start, end, name) in enumerate(ops):
        nxt = ops[i + 1][0] if i + 1 < len(ops) else end
        span[name] = span.get(name, 0.0) + (end - start) / 1e3
        s2s[name] = s2s.get(name, 0.0) + (nxt - start) / 1e3
        count[name] = count.get(name, 0) + 1
    busy = covered((start, end) for start, end, _ in ops) / 1e3
    window = (max(end for _, end, _ in ops) - ops[0][0]) / 1e3 if ops else 0.0
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
