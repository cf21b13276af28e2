"""The four trajectory goldens replayed in full through the port's training
steps, on the CPU.

Each golden (tests/goldens/training_trajectory*.npz) holds 20 warmup and 20
GAN steps of the executed reference training loop (torch CPU) on a small
config (a 2 RCB / 16 ch G, a 4 ch D): its initial and final state dicts,
per-step losses, and the same run with a one-ulp input perturbation (the
`p_*` traces, the trajectory's own noise floor). This file replays each
through the port's `make_warmup_step` / `make_gan_steps` from the golden's
weights, on its feed (`make_batches`, seeds 1234 / 5678) and schedule
(`meta`), by srgan_st_tpu_torch/tools/trajectory.py on the CPU (the tool
that replays them on the card), and holds it to tests/test_trajectory.py's
gates: the first 5
steps within 2e-4 (warmup), 2e-3 (G) and 5e-3 (D) relative, the whole
window within max(that, 30x the noise floor), and the final G's and D's
eval outputs on a probe batch within 5e-2 and 5e-1 of the golden's final
models on the same probe.

The recipes: "st" Adversarial + Pixel + ST, "flagship" + PatchwiseST +
ContentDiscriminator (the frozen content D ships as cd0/*), "gram-vgg" +
Gram + ContentVGG (the seed-97 random VGG19 of
tools/crosscheck_training_vs_reference.py `_make_vgg19_stub`, checked
against the golden's digest first), "bb" + BestBuddy.

Beside them: the tool's feed and VGG19 stub against the generator's own,
the st golden through the chunk steps in train()'s chunks, the tool's
command line, and its full-width configuration's trunk resolution.
"""

import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
from srgan_st_tpu_torch.tools import trajectory, trajectory_probe

_GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
_TOOLS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools")
if _TOOLS not in sys.path:
    sys.path.insert(0, _TOOLS)


def _probe_outputs(data, g, d):
    """Eval-mode outputs of the replayed and the golden's final G and D on
    the probe batch (seed 424242): G on its MATLAB-bicubic x1/4 LR, D on
    the [0, 1] GT."""
    from srgan_st_tpu_torch.ops.resize import resize_bicubic

    gt = torch.from_numpy(trajectory.make_batches(1, int(data["meta"][2]), 96,
                                                  seed=424242)[0]).float() / 255.0
    lr = resize_bicubic(gt, 0.25, method="matlab")
    g_ref, d_ref = copy.deepcopy(g), copy.deepcopy(d)
    g_ref.load_state_dict(trajectory.unpack(data, "g_final"))
    d_ref.load_state_dict(trajectory.unpack(data, "d_final"))
    with torch.no_grad():
        return ((g.eval()(lr), g_ref.eval()(lr)),
                (d.eval()(gt, train=False), d_ref.eval()(gt, train=False)))


def _hold_to_golden(got: dict, data) -> None:
    """test_trajectory.py's gates on the three traces (module docstring)."""
    for name, tight in (("warm_losses", 2e-4), ("gan_g_losses", 2e-3),
                        ("gan_d_losses", 5e-3)):
        ref = data[name]
        assert got[name].shape == ref.shape == (20,), name
        head = trajectory.max_rel(ref[:5], got[name][:5])
        assert head < tight, (name, head)
        floor = trajectory.max_rel(ref, data["p_" + name])
        window = trajectory.max_rel(ref, got[name])
        assert window < max(tight, 30.0 * floor), (name, window, floor)


@pytest.mark.parametrize("golden,recipe", [
    ("training_trajectory.npz", "st"),
    ("training_trajectory_flagship.npz", "flagship"),
    ("training_trajectory_gramvgg.npz", "gram-vgg"),
    ("training_trajectory_bb.npz", "bb"),
])
def test_trajectory_replays_in_full(golden, recipe):
    """20 warmup + 20 GAN steps through the port within test_trajectory.py's
    gates (module docstring)."""
    assert trajectory.RECIPES[recipe][0] == golden
    data = trajectory.load_golden(recipe, _GOLDENS)
    assert str(data["recipe"]) == recipe if "recipe" in data else recipe == "st"
    run = trajectory.replay(data, recipe, device="cpu")
    _hold_to_golden(run.losses, data)
    (g_got, g_want), (d_got, d_want) = _probe_outputs(data, run.g, run.d)
    assert float((g_got - g_want).abs().max()) < 5e-2
    assert float((d_got - d_want).abs().max()) < 5e-1


def test_feed_and_vgg_stub_are_the_reference_generators():
    """The tool's feed and seed-97 VGG19 are bit for bit those of
    tools/crosscheck_training_vs_reference.py, which made the goldens, and
    the stub leaves the global RNG state as it found it."""
    from crosscheck_training_vs_reference import _make_vgg19_stub, make_batches

    for n, b, size, seed in ((20, 8, 96, 1234), (3, 2, 16, 5678)):
        np.testing.assert_array_equal(trajectory.make_batches(n, b, size, seed),
                                      make_batches(n, b, size, seed))
    before = torch.random.get_rng_state()
    got = trajectory.vgg19_stub().state_dict()
    assert torch.equal(before, torch.random.get_rng_state())
    want = _make_vgg19_stub()().state_dict()
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_chunk_steps_replay_the_st_golden():
    """The chunk steps in train()'s chunks (resolve_chunk_steps /
    iter_chunks: D at each chunk's batch 0, the lr milestone after an
    epoch) replay the st golden within the same gates: the chunk path's
    schedule and D cadence are the reference's (no graphs on the CPU)."""
    data = trajectory.load_golden("st", _GOLDENS)
    run = trajectory.replay(data, "st", device="cpu", form="chunk")
    _hold_to_golden(run.losses, data)
    assert (run.launches, run.graph_launches) == trajectory.expected_launches(
        data, "st", "cpu", "chunk")


def test_cli_prints_the_jax_tools_record(capsys):
    """`--device cpu --recipes st --bf16`: one JSON line under the JAX
    tool's keys, within its bf16 gates, exit 0."""
    assert trajectory.main(["--device", "cpu", "--recipes", "st", "--bf16",
                            "--goldens", _GOLDENS]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    for key in ("metric", "value", "unit", "config", "device", "detail", "gates", "ok"):
        assert key in rec, key
    assert rec["metric"] == "onchip_trajectory_max_rel_err" and rec["config"] == "st-bf16"
    assert rec["gates"] == trajectory.GATES["bfloat16"] == {
        "warm5": 4e-2, "gan5_g": 1.5e-1, "gan5_d": 3e-1}
    assert rec["ok"] and all(rec["detail"][k] < g for k, g in rec["gates"].items())
    assert rec["device"] == {"name": "cpu", "power_limit_w": None}
    assert rec["launches"] == dict.fromkeys(trajectory.COUNTERS, 0)
    assert "serving_tail" in rec["launches"]
    assert {k: rec[k] for k in ("width", "recipe", "dtype", "form", "plain", "trunk")} == {
        "width": "golden", "recipe": "st", "dtype": "bfloat16", "form": "step",
        "plain": False, "trunk": None}


def test_cli_raises_without_a_gpu(monkeypatch):
    """Without --device the tool runs on CUDA; with no GPU it raises before
    any replay, and it refuses modes that --full fixes."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(trajectory, "golden_window", _never)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trajectory.main(["--recipes", "st"])
    monkeypatch.setattr(trajectory_probe, "spread", _never)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        trajectory_probe.main(["--recipes", "st"])
    with pytest.raises(SystemExit):
        trajectory.main(["--device", "cpu", "--full", "--bf16"])


def _never(*args, **kwargs):
    raise AssertionError("replayed without a device")


@pytest.mark.parametrize("trunk,want", [(None, "packed"), ("fused", "fused")])
def test_full_window_resolves_its_trunks(tmp_path, trunk, want):
    """--full's configuration at the default widths: a bf16 train step's
    trunk on (16, 24, 24, 64) is "packed" under the auto mode and "fused"
    where asked; its f32 plain reference is "unfused" with kernel A and
    the buddy selection off (resolution only: nothing runs at full width
    on the CPU)."""
    from srgan_st_tpu_torch.models.generator import Generator

    data = trajectory.full_data(_GOLDENS)
    assert trajectory.meta(data) == (20, 20, 16, 3, 2, 1)
    assert tuple(data["widths"]) == (16, 64, 64)
    x = torch.zeros(16, 24, 24, 64, dtype=torch.bfloat16)
    cfg = trajectory.make_config(data, "flagship", str(tmp_path), "bfloat16", trunk=trunk)
    assert Generator.from_config(cfg)._trunk_mode(True, x) == want
    ref = trajectory.make_config(data, "flagship", str(tmp_path), plain=True)
    assert Generator.from_config(ref)._trunk_mode(True, x.float()) == "unfused"
    assert ref.TPU.CONV3_INNER == 1
    assert ref.MODEL.G_LOSS.CRITERIONS["PatchwiseST"]["pallas"] is False
    launches, _ = trajectory.expected_launches(data, "flagship", "cuda", "chunk",
                                               "bfloat16", trunk=trunk)
    kernel = {"packed": ("packed_trunk_fwd", "packed_trunk_bwd"), "fused": ("fused_trunk",)}
    assert all(launches[k] == 40 for k in kernel[want])
    assert launches["coarse_conv_s2d"] == 40 and launches["buddy_select"] == 20


@pytest.mark.parametrize("recipe,k7", [("st", 0), ("flagship", 20), ("gram-vgg", 20),
                                       ("bb", 20)])
@pytest.mark.parametrize("form", ["step", "chunk"])
def test_golden_launches_are_those_of_the_path(recipe, k7, form):
    """The launches a golden replay is held to on the card: kernel A once
    per warmup and G step (40), K7 once per G step of a buddy recipe, no
    trunk kernel (C = 16) and no kernel B; the chunk steps replay all but
    each step kind's first call (warmup; G + D and G); nothing on the CPU
    or under `plain`."""
    data = trajectory.load_golden(recipe, _GOLDENS)
    zero = dict.fromkeys(trajectory.COUNTERS, 0)
    want, replayed = trajectory.expected_launches(data, recipe, "cuda", form, "bfloat16")
    assert want == dict(zero, coarse_conv_s2d=40, buddy_select=k7)
    if form == "chunk":
        assert replayed == dict(zero, coarse_conv_s2d=37, buddy_select=k7 and k7 - 2)
    else:
        assert replayed == zero
    assert trajectory.expected_launches(data, recipe, "cpu", form) == (zero, zero)
    assert trajectory.expected_launches(data, recipe, "cuda", form, plain=True) == (zero, zero)


def test_probe_faults_change_what_they_name():
    """trajectory_probe's planted faults, applied to stand-in launch
    functions: K5's faults alter only the outputs they name, in place, and
    K6's swaps each block's two conv weights."""
    def k5(*args, **kwargs):
        return tuple(torch.full((2,), float(i + 1)) for i in range(8))

    base = k5()
    for name, want in (("k5-dx-zero", {0: 0.0}), ("k5-dx-half", {0: 0.5}),
                       ("k5-wgrad-x4", {1: 8.0, 2: 12.0}),
                       ("k5-wgrad-zero", dict.fromkeys(range(1, 8), 0.0))):
        trunk, module, attr, wrap = trajectory_probe.FAULTS[name]
        assert (trunk, module, attr) == (None, "packed_trunk", "_launch_bwd")
        outs = wrap(k5)()
        for i, (got, ref) in enumerate(zip(outs, base)):
            assert torch.equal(got, torch.full((2,), want.get(i, float(ref[0])))), (name, i)
    trunk, module, attr, wrap = trajectory_probe.FAULTS["k6-swapped"]
    assert (trunk, module, attr) == ("fused", "fused_trunk", "_launch_fwd")
    assert wrap(lambda *a, **k: (a, k))("x", "w1", "w2", "g1", eps=1) == (
        ("x", "w2", "w1", "g1"), {"eps": 1})


def test_update_cos_gates_the_full_window_runs():
    """update_cos: per part (head conv, trunk, the rest; running statistics
    left out) the cosine of two runs' warmup updates, blind to a common
    scale, 0 where a run did not move; a full-width record is ok only at
    UPDATE_COS_GATE or above, and carries the cosines and the gate."""
    g0 = {"conv1.0.weight": torch.zeros(4), "trunk.0.rcb.0.weight": torch.zeros(3),
          "trunk.0.rcb.1.running_mean": torch.zeros(3), "conv2.0.weight": torch.zeros(2),
          "conv2.1.num_batches_tracked": torch.tensor(0)}
    step = {"conv1.0.weight": torch.tensor([1.0, 2.0, 0.0, -1.0]),
            "trunk.0.rcb.0.weight": torch.tensor([0.5, -0.5, 1.0]),
            "trunk.0.rcb.1.running_mean": torch.tensor([9.0, 9.0, 9.0]),
            "conv2.0.weight": torch.tensor([1.0, 1.0]),
            "conv2.1.num_batches_tracked": torch.tensor(20)}

    def run(scale, **parts):
        g_warm = {k: scale * v for k, v in step.items()}
        g_warm.update(parts)
        return trajectory.Run({}, None, None, g_warm, {}, {}, 0.0)

    ref = run(1.0)
    assert trajectory.update_cos(run(3.0), ref, g0) == pytest.approx(
        {"conv1": 1.0, "trunk": 1.0, "rest": 1.0})
    bent = trajectory.update_cos(
        run(1.0, **{"trunk.0.rcb.0.weight": torch.tensor([0.5, 0.5, 1.0]),
                    "trunk.0.rcb.1.running_mean": torch.tensor([-9.0, 0.0, 0.0])}), ref, g0)
    assert bent["conv1"] == pytest.approx(1.0) and bent["trunk"] == pytest.approx(2 / 3)
    frozen = run(1.0, **{"trunk.0.rcb.0.weight": torch.zeros(3)})
    assert trajectory.update_cos(frozen, ref, g0)["trunk"] == 0.0

    data = {"meta": np.array([4, 4, 2, 3, 2, 1])}
    losses = {"warm_losses": np.ones(4), "gan_g_losses": np.ones(4),
              "gan_d_losses": np.where(trajectory.d_steps(data), 1.0, np.nan)}
    zero = dict.fromkeys(trajectory.COUNTERS, 0)
    held = trajectory.Run(losses, None, None, {}, zero, zero, 0.0)
    rels = trajectory.rel_errors(losses, losses)
    mode = {"width": "full"}
    for cos, ok in ((None, True), ({"conv1": 0.99, "trunk": trajectory.UPDATE_COS_GATE}, True),
                    ({"conv1": 0.99, "trunk": 0.95}, False)):
        rec = trajectory._record("c", "u", {}, rels, trajectory.GATES["bfloat16"], held,
                                 (zero, zero), data, mode, cos)
        assert rec["ok"] is ok
        assert rec.get("update_cos") == cos
        assert ("update_cos_gate" in rec) is (cos is not None)
