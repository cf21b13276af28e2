"""The kernel E reader (`eval_trunk_roofline.serve`) on canned serving
records: the hand-computed share where the program counted its calls and
the trace holds its kernels, nothing where either is absent (a program
without kernel E)."""

import pytest

from benchmark import harness, tracing

CFG = harness.load_json("configs", "srgan_x4.json")
READER = harness.readers()["eval_trunk_roofline.serve"]
E1 = "void (anonymous namespace)::eval_trunk_conv<1>((anonymous namespace)::EvalParams)"
E0 = "void (anonymous namespace)::eval_trunk_conv<0>((anonymous namespace)::EvalParams)"
A = "void (anonymous namespace)::coarse_conv_wgmma(__nv_bfloat16 const*, float*)"


def serve_record(ops, launches):
    rec = tracing.reduce_events(ops, [(0.0, 1.0, "bench.unit")])
    rec.update(kind="serve", config=CFG, frames_per_s=70.0, lr_size=(540, 960), frames=2,
               launches=launches)
    return rec


# two calls' kernels: the convs overlap under programmatic dependent launch
# (union 3.0 + 3.5 ms), kernel A between them
OPS = [(0.0, 1.5e-3, E0), (1.4e-3, 3.0e-3, E1), (3.0e-3, 4.0e-3, A),
       (4.0e-3, 6.0e-3, E0), (6.0e-3, 7.5e-3, E1)]


def test_reads_the_trunks_bound_over_kernel_e_time():
    # one trunk at 540 x 960: 33 3x3 64 -> 64 convs (16 blocks and the
    # fusion conv), 2 FLOPs a multiply-add; bound by operations
    flops = 2.0 * 540 * 960 * 64 * 64 * 9 * 33
    nbytes = 2 * 2 * 540 * 960 * 64 + 2 * 33 * 9 * 64 * 64
    assert flops / 989e12 > nbytes / 3.35e12
    want = 100 * 2 * (flops / 989e12) / 6.5e-3
    value = READER.read(serve_record(OPS, {"eval_trunk": 2, "coarse_conv_s2d": 2}))
    assert value == pytest.approx(want)
    assert harness.per_layer(serve_record(OPS, {"eval_trunk": 2, "coarse_conv_s2d": 2})
                             )["eval_trunk_roofline.serve"]["value"] == pytest.approx(want)


@pytest.mark.parametrize("ops,launches", [
    (OPS, {"coarse_conv_s2d": 2}),                       # a program without the counter
    (OPS, {"eval_trunk": 0, "coarse_conv_s2d": 2}),      # the counter, no call
    ([(3.0e-3, 4.0e-3, A), (4.5e-3, 30e-3, "cudnn conv")],
     {"eval_trunk": 2, "coarse_conv_s2d": 2}),            # no kernel E op in the trace
])
def test_reads_nothing_without_kernel_e(ops, launches):
    rec = serve_record(ops, launches)
    assert READER.read(rec) is None
    assert "eval_trunk_roofline.serve" not in harness.per_layer(rec)


def test_reads_nothing_in_training():
    rec = serve_record(OPS, {"eval_trunk": 2})
    rec["kind"] = "train"
    assert READER.read(rec) is None


def test_names_its_layer_and_end_to_end_metric():
    assert READER.LAYER == "kernels (csrc/eval_trunk.cu: kernel E)"
    assert READER.UNIT == "%" and READER.MOVES == "serve_hr_mp_per_s"
    entry = next(m for m in harness.load_json("..", "BENCHMARK.json")["per_layer"]
                 if m["name"] == "eval_trunk_roofline.serve")
    assert entry["layer"] == READER.LAYER and entry["workloads"] == ["srgan_x4.serve_4k"]
