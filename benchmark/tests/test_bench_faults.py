"""The check that decides `correct`, driven through the rest of a run on
the CPU at a small size (the card check skipped), with the cells' own
limits: the sound program comes out correct; each fault the cell can
have, planted in the timed path, and the control (the float8 reference
in the program's place) come out not correct. One chip, so no exchange
between chips can be left out."""

import time

import pytest
import torch

from benchmark import harness
from benchmark.reference.precision import fp8
from benchmark.reference.serve import upscale

TRAIN = ("srgan_x4.gan", "srgan_st_x4.gan", "srgan_x4.warmup")
SERVE = ("srgan_x4.serve_4k",)


def tiny(cell: str) -> harness.Ctx:
    ctx = harness.load_ctx(cell, 2**31 + 12345, 0.2, False, "cpu", time.perf_counter())
    if ctx.traffic["driver"] == "serve_frames":
        ctx.traffic = dict(ctx.traffic, lr_height=24, lr_width=32, warm_frames=1,
                           sample_frames=3, sample_below=4)
    else:
        ctx.config = dict(ctx.config, g_num_rcb=2, batch_size=4, d_channels=8)
        ctx.traffic = dict(ctx.traffic, chunk_batches=2)
    return ctx


def run(ctx, drv=None) -> dict:
    drv = drv or harness.driver(ctx)
    out = drv.run(ctx)
    assert set(out["checks"]) == set(ctx.workload["limits"])
    return out


@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_the_sound_program_is_correct(cell):
    out = run(tiny(cell))
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_returns_its_state_unchanged_is_not_correct(cell, monkeypatch):
    from srgan_st_tpu_torch.train import steps

    monkeypatch.setattr(steps.Adam, "step", lambda self, grads: None)
    assert not run(tiny(cell))["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_half_the_batch_left_out_is_not_correct(cell, monkeypatch):
    from srgan_st_tpu_torch.train import steps

    prepare = steps._prepare_batch
    monkeypatch.setattr(steps, "_prepare_batch",
                        lambda gt, *a, **k: prepare(gt[: len(gt) // 2], *a, **k))
    assert not run(tiny(cell))["correct"]


@pytest.mark.parametrize("cell", TRAIN)
def test_a_fault_in_a_few_leaves_is_not_correct(cell, monkeypatch):
    """The trunk's 3 x 3 weight gradients times 4 (a fault in K5's wgrad
    tiles): the medians cannot see it, the worst tensor leaf does."""
    from srgan_st_tpu_torch.train import steps

    step = steps.Adam.step

    def wgrad_x4(self, grads):
        step(self, [4 * g if tuple(p.shape) == (64, 64, 3, 3) else g
                    for p, g in zip(self.params, grads, strict=True)])

    monkeypatch.setattr(steps.Adam, "step", wgrad_x4)
    out = run(tiny(cell))
    assert not out["correct"] and out["checks"]["grad_gap_tensor"]["value"] > 1


@pytest.mark.parametrize("cell", TRAIN)
def test_the_float8_control_in_the_programs_place_is_not_correct(cell, monkeypatch):
    ctx = tiny(cell)
    drv = harness.driver(ctx)

    def control_steps(self):
        return self.reference([self.pool[i] for i in range(self.mix["first_steps"])], fp8)

    monkeypatch.setattr(drv.Session, "first_steps", control_steps)
    assert not run(ctx, drv)["correct"]


@pytest.mark.parametrize("cell", SERVE)
def test_an_answer_altered_where_it_is_produced_is_not_correct(cell, monkeypatch):
    from srgan_st_tpu_torch.models.generator import Generator

    forward = Generator.forward

    def altered(self, x, train=False):
        out = forward(self, x, train).clone()
        out[:, :16, :16] = 0.0
        return out

    monkeypatch.setattr(Generator, "forward", altered)
    assert not run(tiny(cell))["correct"]


@pytest.mark.parametrize("cell", SERVE)
def test_the_float8_control_in_the_programs_place_serves_not_correct(cell, monkeypatch):
    ctx = tiny(cell)
    drv = harness.driver(ctx)
    init = drv.Session.__init__

    def control(self, ctx):
        init(self, ctx)
        weights = {k: v.to(self.dev) for k, v in self.g_sd.items()}
        self.apply = lambda x: upscale(weights, torch.as_tensor(x), fp8)

    monkeypatch.setattr(drv.Session, "__init__", control)
    assert not run(ctx, drv)["correct"]
