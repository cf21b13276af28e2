"""The port's spans and capture maps (srgan_st_tpu_torch/utils/profiling.py)
and the trace labels of tools/profile_step.py, on the CPU: the span helper
with and without a profiler, the capture map's arithmetic on synthetic
node counts, `program_trace` and the readings on a fixed synthetic event
list, and the spans that the eager chunk steps and the serving entry emit
under a CPU profiler. The same on a replayed CUDA graph is in
tests/test_torch_cuda.py."""

import os
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
from srgan_st_tpu_torch.tools import profile_step as T
from srgan_st_tpu_torch.utils import profiling as P

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _profiled_spans(fn) -> list[str]:
    """The region paths of the program's spans that fn() opens under a CPU
    profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    ops, calls, spans = T.trace_events(prof)
    return T._tree(spans)[2]


def test_span_is_the_shared_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    first, second = P.span("train.batch", 3), P.span("g.forward")
    assert first is second is P._NULL
    with first:
        with second:
            assert P._stack == []


def test_span_is_a_record_function_under_a_cpu_profiler(monkeypatch):
    """Names, nesting and args: a span without args takes its parent's."""
    made = []
    real = P.record_function

    def record(name, args=None):
        made.append((name, args))
        return real(name, args)

    monkeypatch.setattr(P, "record_function", record)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.span("train.batch", 7) as outer:
            with P.span("graph.copy_in") as inner:
                torch.ones(4).sum()
                assert P._stack == [("train.batch", 7), ("graph.copy_in", 7)]
    assert outer.args == inner.args == 7 and P._stack == []
    assert made == [("train.batch", "7"), ("graph.copy_in", "7")]
    events = {e.name: e for e in prof.events()}
    assert events["graph.copy_in"].cpu_parent.name == "train.batch"
    assert events["aten::sum"].cpu_parent.name == "graph.copy_in"
    assert T._tree(T.trace_events(prof)[2])[2] == ["train.batch", "train.batch/graph.copy_in"]


class _Nodes:
    """A graph under capture whose node count the test moves; `kinds` the
    CUgraphNodeType of every node in creation order."""

    def __init__(self, kinds):
        self.all, self.n = kinds, 0

    def count(self):
        return self.n

    def kinds(self):
        return self.all[:self.n]


def test_capture_map_puts_each_node_down_to_the_region_open_while_it_was_captured():
    nodes = _Nodes([0] * 9)
    with P.span("graph.capture.g"):  # outside the capture: not in the paths
        with P.capture_regions(nodes) as cmap:
            nodes.n = 1                          # before any span: the root
            with P.span("g.forward"):
                nodes.n = 2
                with P.span("g.trunk"):
                    with P.span("kernel.packed_trunk_fwd"):
                        nodes.n = 5
                nodes.n = 6
            with P.span("loss.Pixel"):
                pass                             # no node: no segment
            with P.span("optim.g"):
                nodes.n = 8
            nodes.n = 9
    assert cmap.labels == ["", "g.forward", "g.forward/g.trunk/kernel.packed_trunk_fwd",
                           "g.forward/g.trunk/kernel.packed_trunk_fwd",
                           "g.forward/g.trunk/kernel.packed_trunk_fwd", "g.forward",
                           "optim.g", "optim.g", ""]
    assert P._capture is None and P._stack == []


def test_capture_map_nests_a_span_opened_on_a_second_thread():
    """G's backward runs on autograd's device thread while the caller
    waits inside `g.backward`: the stack is the process's, not a thread's."""
    nodes = _Nodes([0] * 4)

    def device_thread():
        with P.span("kernel.packed_trunk_bwd"):
            nodes.n = 3

    with P.capture_regions(nodes) as cmap:
        with P.span("g.backward"):
            nodes.n = 1
            worker = threading.Thread(target=device_thread)
            worker.start()
            worker.join(timeout=30)
            assert not worker.is_alive()
            nodes.n = 4
    assert cmap.labels == ["g.backward", "g.backward/kernel.packed_trunk_bwd",
                           "g.backward/kernel.packed_trunk_bwd", "g.backward"]


def test_capture_map_keeps_kernel_copy_and_memset_nodes_only():
    # kernel, event record, memcpy, empty, memset, wait event
    nodes = _Nodes([0, 7, 1, 5, 2, 6])
    with P.capture_regions(nodes) as cmap:
        with P.span("step.prepare"):
            nodes.n = 3
        with P.span("optim.g"):
            nodes.n = 6
    assert cmap.labels == ["step.prepare", "step.prepare", "optim.g"]


def test_capture_regions_refuses_a_second_map_and_clears_on_error():
    nodes = _Nodes([0, 0])
    with pytest.raises(ValueError):
        with P.capture_regions(nodes):
            with pytest.raises(RuntimeError, match="already"):
                with P.capture_regions(nodes):
                    pass
            with P.span("g.forward"):
                raise ValueError("a capture that fails")
    assert P._capture is None and P._stack == []


# A fixed trace: a chunk of two batches, each a copy in and a replay of the
# "g" graph (three activity nodes), a kernel launched from a second thread
# inside g.backward's span, and an op whose launch no span holds.
SPANS = [(0.0, 10.0, "train.chunk", 1), (0.0, 5.0, "train.batch", 1),
         (0.5, 1.0, "graph.copy_in", 1), (1.0, 2.0, "graph.launch.g", 1),
         (5.0, 10.0, "train.batch", 1), (5.5, 6.0, "graph.copy_in", 1),
         (6.0, 7.0, "graph.launch.g", 1),
         (12.0, 14.0, "g.backward", 1), (12.5, 13.0, "kernel.packed_trunk_bwd", 2)]
CALLS = [(0.6, 0.7, "cudaMemcpyAsync", 1), (1.1, 1.9, "cudaGraphLaunch", 2),
         (5.6, 5.7, "cudaMemcpyAsync", 3), (6.1, 6.9, "cudaGraphLaunch", 4),
         (12.6, 12.7, "cudaLaunchKernel", 5), (10.5, 10.55, "cudaLaunchKernel", 6)]
CONV = "void (anonymous namespace)::trunk_conv_wgmma(ConvParams)"
WGRAD = "void (anonymous namespace)::trunk_wgrad_wgmma(WgradParams)"
OPS = [(1.0, 1.5, "Memcpy DtoD", 1),
       (2.0, 3.0, CONV, 2), (3.0, 3.5, WGRAD, 2), (3.6, 3.8, "multi_tensor_apply_kernel", 2),
       (6.0, 6.2, "Memcpy DtoD", 3),
       (7.0, 8.0, CONV, 4), (8.0, 8.5, WGRAD, 4), (8.6, 8.8, "multi_tensor_apply_kernel", 4),
       (10.6, 10.8, "elementwise_kernel", 6), (13.0, 13.4, WGRAD, 5)]
NODES = {"g": ["g.forward/g.trunk/kernel.packed_trunk_fwd",
               "g.backward/kernel.packed_trunk_bwd", "optim.g"]}
BATCH = "train.chunk/train.batch"
REPLAY = f"{BATCH}/graph.launch.g"


def test_program_trace_labels_eager_and_replayed_ops():
    rec = T.program_trace(OPS, CALLS, SPANS, NODES)
    assert rec["labels"] == [
        f"{BATCH}/graph.copy_in",
        f"{REPLAY}/g.forward/g.trunk/kernel.packed_trunk_fwd",
        f"{REPLAY}/g.backward/kernel.packed_trunk_bwd", f"{REPLAY}/optim.g",
        f"{BATCH}/graph.copy_in",
        f"{REPLAY}/g.forward/g.trunk/kernel.packed_trunk_fwd",
        f"{REPLAY}/g.backward/kernel.packed_trunk_bwd", f"{REPLAY}/optim.g",
        None, "g.backward/kernel.packed_trunk_bwd"]
    assert rec["replays"] == [{"kind": "g", "ops": 3, "nodes": 3}] * 2
    names = [(s["name"], s["parent"]) for s in rec["spans"]]
    assert names[:4] == [("train.chunk", -1), ("train.batch", 0),
                         ("graph.copy_in", 1), ("graph.launch.g", 1)]
    assert names[-1] == ("kernel.packed_trunk_bwd", 7)


def test_program_trace_idle_by_span_sums_to_window_minus_busy():
    rec = T.program_trace(OPS, CALLS, SPANS, NODES)
    busy = P.covered((s, e) for s, e, *_ in OPS)
    window = max(e for _, e, *_ in OPS) - min(s for s, *_ in OPS)
    idle = rec["idle_by_span"]
    assert sum(idle.values()) == pytest.approx(window - busy, abs=1e-12)
    assert idle["graph.launch.g"] == pytest.approx(0.5 + 0.8)  # 1.5-2.0, 6.2-7.0
    # 3.5-3.6, 3.8-6.0, 8.5-8.6, 8.8-10.6 (its midpoint before the batch ends)
    assert idle["train.batch"] == pytest.approx(0.1 + 2.2 + 0.1 + 1.8)
    assert idle[T.OUTSIDE] == pytest.approx(2.2)  # 10.8-13.0
    assert set(idle) == {"graph.launch.g", "train.batch", T.OUTSIDE}


def test_program_trace_regions_and_labelled_share():
    rec = T.program_trace(OPS, CALLS, SPANS, NODES)
    busy = P.covered((s, e) for s, e, *_ in OPS)
    assert rec["labelled_share"] == pytest.approx((busy - 0.2) / busy)
    regions = rec["regions"]
    assert regions["graph.copy_in"] == pytest.approx(0.7)
    assert regions["kernel.packed_trunk_fwd"] == pytest.approx(2.0)
    assert regions["kernel.packed_trunk_bwd"] == pytest.approx(1.4)
    assert regions["g.backward"] == pytest.approx(1.4)
    assert regions["optim.g"] == pytest.approx(0.4)
    assert regions["graph.launch.g"] == pytest.approx(3.4)


def test_a_replay_off_its_graph_keeps_only_its_launch_path():
    nodes = {"g": NODES["g"][:2]}
    rec = T.program_trace(OPS, CALLS, SPANS, nodes)
    assert rec["replays"] == [{"kind": "g", "ops": 3, "nodes": 2}] * 2
    assert rec["labels"][1:4] == [REPLAY] * 3
    assert rec["labelled_share"] == pytest.approx(
        T.program_trace(OPS, CALLS, SPANS, NODES)["labelled_share"])


def test_host_children_give_total_and_self_time_a_unit():
    rec = T.program_trace(OPS, CALLS, SPANS, NODES)
    host = T.host_children(rec["spans"], "train.batch")
    assert host["train.batch"] == pytest.approx((10.0, 10.0 - 3.0))
    assert host["graph.copy_in"] == pytest.approx((1.0, 1.0))
    assert host["graph.launch.g"] == pytest.approx((2.0, 2.0))


def test_readings_of_a_training_chunk():
    """A batch is a replay: host time of `train.batch`, Adam's device time,
    and K4's and K5's device time per launch (K5's third op eager)."""
    rec = T.program_trace(OPS, CALLS, SPANS, NODES)
    got = T.readings(OPS, rec, 2, {"packed_trunk_fwd": 2, "packed_trunk_bwd": 3})
    assert got == pytest.approx({
        "host_ms_per_batch": 5e3, "optimizer_ms_per_batch": 200.0,
        "k4_ms_per_launch": 1e3, "k4_launches_per_batch": 1.0,
        "k5_ms_per_launch": 1.4e3 / 3, "k5_launches_per_batch": 1.5})


def test_losses_reading_leaves_out_the_adversarial_terms_d_forward():
    nodes = {"g": ["loss.Pixel", "loss.Adversarial/d.forward", "optim.g"]}
    rec = T.program_trace(OPS, CALLS, SPANS, nodes)
    got = T.readings(OPS, rec, 2, {"packed_trunk_fwd": 2})
    assert got["losses_ms_per_batch"] == pytest.approx(1e3)   # 2.0-3.0, 7.0-8.0
    assert got["loss_d_forward_ms_per_batch"] == pytest.approx(500.0)
    assert "k4_ms_per_launch" not in got  # launched, but no op under its span


def test_readings_of_served_frames_and_none_without_spans():
    spans = [(0.0, 3.0, "serve.frame", 1), (0.5, 2.5, "g.forward", 1), (1.0, 2.0, "g.trunk", 1),
             (3.0, 7.0, "serve.frame", 1), (3.5, 6.5, "g.forward", 1), (4.0, 5.0, "g.trunk", 1)]
    calls = [(1.1, 1.2, "cudaLaunchKernel", 1), (2.1, 2.2, "cudaLaunchKernel", 2),
             (4.1, 4.2, "cudaLaunchKernel", 3), (7.5, 7.6, "cudaLaunchKernel", 4)]
    ops = [(1.2, 1.8, "bn", 1), (2.2, 2.4, "conv", 2), (4.2, 4.6, "bn", 3),
           (7.6, 7.9, "next_lr", 4)]
    rec = T.program_trace(ops, calls, spans)
    assert T.readings(ops, rec, 2, {}) == pytest.approx(
        {"host_ms_per_frame": 3.5e3, "trunk_ms_per_frame": 500.0})
    assert T.readings(ops, T.program_trace(ops, calls, []), 2, {"packed_trunk_fwd": 2}) == {}


def test_spans_off_records_no_span_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with P.spans_off():
            assert P.span("train.batch") is P._NULL
            with P.span("g.forward"):
                torch.ones(4).sum()
        with P.span("train.batch"):
            torch.ones(4).sum()
    assert T._tree(T.trace_events(prof)[2])[2] == ["train.batch"]
    assert P._profiling is torch.autograd._profiler_enabled


def test_program_spans_leave_the_benchmark_record_and_readers_unchanged():
    """The benchmark's trace reduction on the same events with and without
    the program's spans among the host events: the same device ops, busy
    and window, top ops and idle total, and the same reading from every
    reader; only the idle gaps' names may name a span."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import harness, tracing

    device = [(s, e, name) for s, e, name, _ in OPS]
    calls = [(s, e, name) for s, e, name, _ in CALLS]
    spans = [(s, e, name) for s, e, name, _ in SPANS]
    cfg = harness.load_json("configs", "srgan_x4.json")
    recs = []
    for host in (calls + [(0.0, 20.0, "bench.unit")],
                 calls + spans + [(0.0, 20.0, "bench.unit")]):
        rec = tracing.reduce_events(device, host)
        rec.update(kind="train", phase="gan", config=cfg, rate=2000.0, batches=2,
                   launches={"packed_trunk_fwd": 2, "packed_trunk_bwd": 3})
        recs.append(rec)
    bare, spanned = recs
    for key in ("ops", "busy_s", "window_s", "device_ops"):
        assert bare[key] == spanned[key], key
    assert sum(s for _, s in bare["idle_gaps"]) == pytest.approx(
        sum(s for _, s in spanned["idle_gaps"]))
    assert harness.per_layer(bare) == harness.per_layer(spanned)
    assert harness.per_layer(bare)  # the readers read something here


def _tiny_config():
    from srgan_st_tpu_torch.core.config import Config, apply_overrides

    return apply_overrides(Config(), [
        "DATA.BATCH_SIZE=2", "MODEL.G_N_RCB=1", "MODEL.G_N_CHANNEL=8", "MODEL.D_N_CHANNEL=4"])


@pytest.mark.parametrize("kind", ["warmup", "gan"])
def test_eager_chunk_steps_emit_the_spans(kind):
    """A chunk of two batches on the CPU (eager: no graphs) opens the
    documented spans in the documented nesting."""
    from srgan_st_tpu_torch.losses.registry import build_criterions, build_warmup_criterions
    from srgan_st_tpu_torch.models.discriminator import Discriminator
    from srgan_st_tpu_torch.models.generator import Generator
    from srgan_st_tpu_torch.train.steps import (
        create_gan_state, create_generator_state, make_gan_chunk_step, make_warmup_chunk_step,
    )

    cfg = _tiny_config()
    gen = torch.Generator().manual_seed(0)
    chunk = [torch.randint(0, 256, (2, 96, 96, 3), generator=gen, dtype=torch.uint8)
             for _ in range(2)]
    if kind == "warmup":
        state = create_generator_state(cfg, Generator.from_config(cfg), 4, "cpu")
        step = make_warmup_chunk_step(cfg, build_warmup_criterions(cfg))
        paths = _profiled_spans(lambda: step(state, chunk))
    else:
        state = create_gan_state(cfg, Generator.from_config(cfg),
                                 Discriminator.from_config(cfg), 4, "cpu")
        step = make_gan_chunk_step(cfg, build_criterions(cfg))
        paths = _profiled_spans(lambda: step(state, chunk, True))
    batch = "train.chunk/train.batch"
    want = {"train.chunk", batch, f"{batch}/step.prepare", f"{batch}/g.forward",
            *(f"{batch}/g.forward/g.{part}" for part in ("stem", "trunk", "upsample", "tail")),
            f"{batch}/g.backward", f"{batch}/optim.g"}
    want |= {f"{batch}/loss.{name}" for name in (
        cfg.MODEL.G_LOSS.WARMUP_CRITERIONS if kind == "warmup" else cfg.MODEL.G_LOSS.CRITERIONS)}
    if kind == "gan":
        want |= {f"{batch}/loss.Adversarial/d.forward", f"{batch}/d.step",
                 f"{batch}/d.step/step.prepare", f"{batch}/d.step/d.forward",
                 f"{batch}/d.step/d.backward", f"{batch}/d.step/optim.d"}
    assert set(paths) == want
    assert paths.count(batch) == 2 and paths.count("train.chunk") == 1
    assert P._stack == []


def test_serving_entry_opens_a_frame_span_numbered_by_frame():
    from srgan_st_tpu_torch.eval.validate import make_generator_apply
    from srgan_st_tpu_torch.models.generator import random_variables

    cfg = _tiny_config()
    apply_fn = make_generator_apply(cfg, random_variables(0, channels=8, num_rcb=1), "cpu")
    x = torch.rand(1, 6, 8, 3, generator=torch.Generator().manual_seed(1))
    made = []
    real = P._Span.__enter__

    def enter(self):
        out = real(self)
        made.append((self.name, self.args))
        return out

    P._Span.__enter__ = enter
    try:
        paths = _profiled_spans(lambda: [apply_fn(x) for _ in range(2)])
    finally:
        P._Span.__enter__ = real
    frame = "serve.frame/g.forward"
    assert set(paths) == {"serve.frame", frame, *(f"{frame}/g.{part}" for part in (
        "stem", "trunk", "upsample", "tail"))}
    assert [a for name, a in made if name == "serve.frame"] == [0, 1]
    assert {a for name, a in made if name == "g.trunk"} == {0, 1}
