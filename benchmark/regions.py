"""The traced sub-window with the program's regions: `torch.profiler` over
whole units, as `tracing.profile_units` runs it, and beside its record the
device seconds under each of the program's spans (srgan_st_tpu_torch/
utils/profiling.py `span`).

The labelling is that of `program_trace` in srgan_st_tpu_torch/tools/
profile_step.py, cut to eager ops (a serving frame launches no graph): a
device op is put down to the innermost span running on the host when its
launch was called, found by the op's correlation with that call. Its
region path holds that span and every span around it; a region's seconds
are the union of the spans of the ops whose path holds it. A program
without spans gives no regions."""

from __future__ import annotations

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import tracing

# the first words of the program's span names (profile_step.py SPAN_PREFIXES)
SPAN_PREFIXES = ("train.", "graph.", "step.", "g.", "loss.", "optim.", "d.", "kernel.",
                 "serve.")


def events(prof) -> tuple[list, list, list, list]:
    """A finished profile's device ops (start s, end s, name, correlation),
    its CUDA API calls (the same fields), the program's spans (start s,
    end s, name) and every host event (start s, end s, name)."""
    ops, calls, spans, host = [], [], [], []
    for e in prof.events():
        start, end, name = e.time_range.start / 1e6, e.time_range.end / 1e6, e.name
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                ops.append((start, end, name, e.id))
            continue
        host.append((start, end, name))
        if name.startswith(SPAN_PREFIXES) and getattr(e, "is_user_annotation", True):
            spans.append((start, end, name))
        elif name.startswith("cu"):
            calls.append((start, end, name, e.id))
    return ops, calls, spans, host


def _tree(spans: list) -> tuple[list, list[str]]:
    """The spans sorted by start (the longer first) and each one's region
    path (the names of the spans that hold it, outermost first)."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    path, stack = [""] * len(spans), []
    for j, (_, end, name) in enumerate(spans):
        while stack and spans[stack[-1]][1] < end:
            stack.pop()
        path[j] = f"{path[stack[-1]]}/{name}" if stack else name
        stack.append(j)
    return spans, path


def _innermost(spans: list, times: list[float]) -> list[int]:
    """For each time, the index of the innermost of `spans` (sorted as
    `_tree` sorts them) that holds it; -1 where none does."""
    out, stack, j = [-1] * len(times), [], 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while j < len(spans) and spans[j][0] <= t:
            while stack and spans[stack[-1]][1] < spans[j][1]:
                stack.pop()
            stack.append(j)
            j += 1
        while stack and spans[stack[-1]][1] < t:
            stack.pop()
        out[q] = stack[-1] if stack else -1
    return out


def label(ops: list, calls: list, spans: list) -> dict:
    """{"regions": {span name: device seconds}, "labelled_share": the
    labelled ops' busy time over all ops' busy time (None without ops)}."""
    ops = sorted(ops)
    spans, path = _tree(spans)
    launch = {c[3]: c for c in calls}
    launched = [i for i, op in enumerate(ops) if op[3] in launch]
    at = _innermost(spans, [launch[ops[i][3]][0] for i in launched])
    by_name: dict[str, list] = {}
    labelled = []
    for i, j in zip(launched, at):
        if j < 0:
            continue
        labelled.append((ops[i][0], ops[i][1]))
        for name in set(path[j].split("/")):
            by_name.setdefault(name, []).append((ops[i][0], ops[i][1]))
    busy = tracing.covered((s, e) for s, e, *_ in ops)
    return {"regions": {name: tracing.covered(iv) for name, iv in sorted(by_name.items())},
            "labelled_share": tracing.covered(labelled) / busy if busy else None}


def profile_units(unit, n: int = 1) -> dict:
    """`tracing.profile_units`' record of n units (unit() run once before,
    unprofiled), with the program's regions in it (`label`)."""
    unit()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            with record_function("bench.unit"):
                unit()
        torch.cuda.synchronize()
    ops, calls, spans, host = events(prof)
    record = tracing.reduce_events([op[:3] for op in ops], host)
    record.update(label(ops, calls, spans))
    return record
