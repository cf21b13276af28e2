"""Training steps captured as CUDA graphs (the counterpart of the JAX
package's jitted, donated `lax.scan` chunk, srgan_st_tpu/train/steps.py:310-390).

A step kind (warmup, G, G + D) is captured once per process and replayed
for every later batch:

  1. its first call runs the step eagerly on a side stream (a real step:
     it initializes the optimizer state, fills the device-constant and
     kernel caches and builds the kernels), on static input buffers;
  2. then the same function is captured on that stream into a graph whose
     memory comes from one pool that every graph of the run shares;
  3. every later call copies the batch and its crop / augmentation draws
     into the static buffers and replays the graph. Its outputs are the
     graph's static outputs, which the next replay of that graph
     overwrites.

The parameters, BatchNorm statistics and optimizer moments are updated in
place by the replays, which is what donation buys in JAX. A replay bumps no
tensor's `_version`, so it advances `kernels.generation`, which the
weight-layout caches key on. Each graph records the kernel launches made
while it was captured; the capture takes them back from the counters
(nothing ran) and each replay adds them (`kernels.add_launch_counts`), so
the counters count executed launches either way. A capture that fails
raises, naming the step and the line of the op that broke it; nothing falls
back to eager steps.
"""

from __future__ import annotations

import gc
import time
import traceback

import torch
from torch.utils import _pytree as pytree


class StepGraphs:
    """The captured steps of one run on one CUDA device, by kind."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        self._steps: dict[str, _CapturedStep] = {}

    def run(self, kind: str, owner, fn, *args):
        """fn(*args) (a pytree of tensors and arrays in, of tensors out):
        eagerly and then captured on the first call of `kind`, replayed on
        later ones. `owner` (the train state) must be the same object on
        every call of a kind: the graph holds its tensors."""
        step = self._steps.get(kind)
        if step is None:
            step = self._steps[kind] = _CapturedStep(self, kind, owner, fn)
        elif step.owner is not owner:
            raise ValueError(f"the {kind} step graph was captured for another train state")
        return step(args)

    def capture_seconds(self) -> dict[str, float]:
        return {kind: s.capture_seconds for kind, s in self._steps.items()}

    def launches_per_replay(self) -> dict[str, dict[str, int]]:
        return {kind: dict(s.launches) for kind, s in self._steps.items()}

    def pool_bytes(self) -> int | None:
        """Bytes of the segments of the graphs' memory pool (None if the
        allocator's snapshot does not name pools)."""
        total, named = 0, False
        for seg in torch.cuda.memory_snapshot():
            if "segment_pool_id" in seg:
                named = True
                if tuple(seg["segment_pool_id"]) == tuple(self.pool):
                    total += seg["total_size"]
        return total if named else None


class _CapturedStep:
    def __init__(self, graphs: StepGraphs, kind: str, owner, fn):
        self.graphs, self.kind, self.owner, self.fn = graphs, kind, owner, fn
        self.graph = None
        self.static_in: list[torch.Tensor] = []
        self.spec = None
        self.out = None
        self.launches: dict[str, int] = {}
        self.capture_seconds = 0.0

    def __call__(self, args):
        flat, spec = pytree.tree_flatten(args)
        flat = [torch.as_tensor(x) for x in flat]
        if self.graph is None:
            return self._warm_up_and_capture(flat, spec)
        if spec != self.spec or any(s.shape != x.shape or s.dtype != x.dtype
                                    for s, x in zip(self.static_in, flat)):
            raise ValueError(f"the {self.kind} step graph was captured for other inputs")
        for dst, src in zip(self.static_in, flat):
            dst.copy_(src, non_blocking=True)
        self.graph.replay()
        from srgan_st_tpu_torch import kernels

        kernels.add_launch_counts(self.launches, replayed=True)
        kernels.generation += 1
        return self.out

    def _warm_up_and_capture(self, flat, spec):
        from srgan_st_tpu_torch import kernels

        dev, stream = self.graphs.device, self.graphs.stream
        self.spec = spec
        self.static_in = [torch.empty(x.shape, dtype=x.dtype, device=dev).copy_(x)
                          for x in flat]
        args = pytree.tree_unflatten(self.static_in, spec)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            out = self.fn(*args)
        torch.cuda.current_stream(dev).wait_stream(stream)

        t0 = time.perf_counter()
        before = kernels.launch_counts()
        graph = torch.cuda.CUDAGraph()
        # A graph of an earlier run (warmup's, when train() captures) that
        # the cyclic collector frees inside this capture destroys its
        # executable there, which invalidates the capture: collect first,
        # and not during the capture.
        collecting = gc.isenabled()
        gc.collect()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.graphs.pool, stream=stream,
                                  capture_error_mode="thread_local"):
                static_out = self.fn(*args)
        except Exception as e:  # noqa: BLE001 — re-raised with the op's place
            raise RuntimeError(f"CUDA graph capture of the {self.kind} step failed at "
                               f"{_where(e)}: {type(e).__name__}: {e}") from e
        finally:
            if collecting:
                gc.enable()
        after = kernels.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        kernels.add_launch_counts({k: -n for k, n in self.launches.items()})
        self.graph, self.out = graph, static_out
        self.capture_seconds = time.perf_counter() - t0
        return out


def _where(e: BaseException) -> str:
    """file:line and source of the deepest frame of the port in e's
    traceback (the op that broke the capture), else the deepest frame."""
    frames = traceback.extract_tb(e.__traceback__)
    ours = [f for f in frames if "srgan_st_tpu_torch" in f.filename
            and not f.filename.endswith("graphs.py")]
    f = (ours or frames)[-1] if frames else None
    return f"{f.filename}:{f.lineno} ({f.line})" if f else "an unknown place"


def step_graphs(config, device, mesh=None) -> StepGraphs | None:
    """The run's StepGraphs when its steps are captured: on CUDA under
    TPU.CUDA_GRAPHS (the default). None on the CPU, which has no graphs,
    and with TPU.CUDA_GRAPHS false. A process group whose collectives a
    graph cannot hold (gloo) raises (parallel/mesh.py)."""
    if torch.device(device).type != "cuda" or not config.TPU.CUDA_GRAPHS:
        return None
    if mesh is not None:
        mesh.require_capturable("TPU.CUDA_GRAPHS")
    return StepGraphs(device)
