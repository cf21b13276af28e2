"""The four trajectory goldens replayed in full through the port's training
steps, on the CPU.

Each golden (tests/goldens/training_trajectory*.npz) holds 20 warmup and 20
GAN steps of the executed reference training loop (torch CPU) on a small
config (a 2 RCB / 16 ch G, a 4 ch D): its initial and final state dicts,
per-step losses, and the same run with a one-ulp input perturbation (the
`p_*` traces, the trajectory's own noise floor). This file replays each
through the port's `make_warmup_step` / `make_gan_steps` from the golden's
weights, on its feed (`make_batches`, seeds 1234 / 5678) and schedule
(`meta`), and holds it to tests/test_trajectory.py's gates: the first 5
steps within 2e-4 (warmup), 2e-3 (G) and 5e-3 (D) relative, the whole
window within max(that, 30x the noise floor), and the final G's and D's
eval outputs on a probe batch within 5e-2 and 5e-1 of the golden's final
models on the same probe.

The recipes: "st" Adversarial + Pixel + ST, "flagship" + PatchwiseST +
ContentDiscriminator (the frozen content D ships as cd0/*), "gram-vgg" +
Gram + ContentVGG (the seed-97 random VGG19 of
tools/crosscheck_training_vs_reference.py `_make_vgg19_stub`, checked
against the golden's digest first), "bb" + BestBuddy.
"""

import os
import sys

import numpy as np
import pytest
import torch

_GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
_TOOLS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "tools")
if _TOOLS not in sys.path:
    sys.path.insert(0, _TOOLS)

# criteria after Adversarial and Pixel, in the golden's summation order
RECIPES = {
    "st": {"ST": {"kind": "st"}},
    "flagship": {"PatchwiseST": {"kind": "patchwise_st"},
                 "ContentDiscriminator": {"kind": "content_disc"}},
    "gram-vgg": {"Gram": {"kind": "gram"}, "ContentVGG": {"kind": "content_vgg"}},
    "bb": {"BestBuddy": {"kind": "best_buddy"}},
}


def _unpack(data, part):
    return {k[len(part) + 1:]: torch.from_numpy(np.asarray(data[k]))
            for k in data.files if k.startswith(part + "/")}


def _stub_vgg_npz(data, path) -> str:
    """The gram-vgg golden's VGG19 (not stored: rebuilt from the seed-97
    stub and held to the golden's digest, as test_trajectory.py does),
    written in tools/convert_vgg19.py's npz format."""
    from crosscheck_training_vs_reference import _make_vgg19_stub

    vgg0 = {k: v.numpy().copy() for k, v in _make_vgg19_stub()().state_dict().items()}
    w0 = np.concatenate([np.asarray(v, np.float64).ravel() for v in vgg0.values()])
    size, abssum, head = (float(x) for x in data["vgg0_digest"])
    assert w0.size == int(size)
    np.testing.assert_allclose(float(np.abs(w0).sum()), abssum, rtol=1e-12)
    np.testing.assert_allclose(float(w0[:8].sum()), head, rtol=1e-12)
    np.savez(path, **{k: v.transpose(2, 3, 1, 0) if v.ndim == 4 else v
                      for k, v in vgg0.items()})
    return str(path)


def _config(data, recipe, tmp_path):
    from srgan_st_tpu_torch.core.config import Config

    _, _, batch, _, d_int, milestone = (int(v) for v in data["meta"])
    cfg = Config()
    cfg.DATA.BATCH_SIZE = batch
    cfg.SCHEDULER.MILESTONES = [milestone]
    cfg.SOLVER.D_UPDATE_INTERVAL = d_int
    cfg.MODEL.G_N_RCB, cfg.MODEL.G_N_CHANNEL, cfg.MODEL.D_N_CHANNEL = 2, 16, 4
    cfg.MODEL.G_LOSS.CRITERIONS = {"Adversarial": {"kind": "adversarial"},
                                   "Pixel": {"kind": "pixel", "criterion": "mse"},
                                   **RECIPES[recipe]}
    if recipe == "flagship":
        path = str(tmp_path / "cd0.npz")
        np.savez(path, **{k: t.numpy() for k, t in _unpack(data, "cd0").items()})
        cfg.MODEL.G_LOSS.DISC_FEATURES_WEIGHTS = path
    if recipe == "gram-vgg":
        cfg.MODEL.G_LOSS.VGG19_WEIGHTS = _stub_vgg_npz(data, tmp_path / "vgg0.npz")
    return cfg


def _replay(data, cfg):
    """20 warmup steps from g0, then 20 GAN steps from g_warm and d0, on the
    golden's feed and schedule -> (losses, final G, final D)."""
    from crosscheck_training_vs_reference import make_batches

    from srgan_st_tpu_torch.losses.registry import build_criterions, build_warmup_criterions
    from srgan_st_tpu_torch.models.discriminator import Discriminator
    from srgan_st_tpu_torch.models.generator import Generator
    from srgan_st_tpu_torch.train.steps import (
        GANTrainState, make_d_optimizer, make_g_optimizer, make_gan_steps, make_warmup_step,
    )

    warm_n, gan_n, batch, spe, d_int, _ = (int(v) for v in data["meta"])
    losses = {"warm_losses": [], "gan_g_losses": [], "gan_d_losses": []}

    g = Generator.from_config(cfg)
    g.load_state_dict(_unpack(data, "g0"))
    state = GANTrainState(g_model=g, g_opt=make_g_optimizer(cfg, g.parameters(), spe,
                                                            milestones=False))
    warm_step = make_warmup_step(cfg, build_warmup_criterions(cfg))
    for gt in make_batches(warm_n, batch, 96, seed=1234):
        state, m = warm_step(state, gt)
        losses["warm_losses"].append(float(m["G_Loss"]))

    # the GAN phase from the golden's post-warmup G: each window carries
    # only its own divergence (test_trajectory.py)
    g, d = Generator.from_config(cfg), Discriminator.from_config(cfg)
    g.load_state_dict(_unpack(data, "g_warm"))
    d.load_state_dict(_unpack(data, "d0"))
    state = GANTrainState(g_model=g, g_opt=make_g_optimizer(cfg, g.parameters(), spe),
                          d_model=d, d_opt=make_d_optimizer(cfg, d.parameters(), spe))
    g_step, d_step = make_gan_steps(cfg, build_criterions(cfg))
    for step, gt in enumerate(make_batches(gan_n, batch, 96, seed=5678)):
        state, sr, m = g_step(state, gt)
        losses["gan_g_losses"].append(float(m["G_Loss"]))
        if (step % spe) % d_int == 0:
            state, dm = d_step(state, gt, sr)
            losses["gan_d_losses"].append(float(dm["D_Loss"]))
        else:
            losses["gan_d_losses"].append(np.nan)
    return {k: np.asarray(v, np.float64) for k, v in losses.items()}, g, d


def _probe_outputs(cfg, data, g, d):
    """Eval-mode outputs of the replayed and the golden's final G and D on
    the probe batch (seed 424242): G on its MATLAB-bicubic x1/4 LR, D on
    the [0, 1] GT."""
    from crosscheck_training_vs_reference import make_batches

    from srgan_st_tpu_torch.models.discriminator import Discriminator
    from srgan_st_tpu_torch.models.generator import Generator
    from srgan_st_tpu_torch.ops.resize import resize_bicubic

    gt = torch.from_numpy(make_batches(1, int(data["meta"][2]), 96, seed=424242)[0]).float() / 255.0
    lr = resize_bicubic(gt, 0.25, method="matlab")
    g_ref, d_ref = Generator.from_config(cfg), Discriminator.from_config(cfg)
    g_ref.load_state_dict(_unpack(data, "g_final"))
    d_ref.load_state_dict(_unpack(data, "d_final"))
    with torch.no_grad():
        return ((g.eval()(lr), g_ref.eval()(lr)),
                (d.eval()(gt, train=False), d_ref.eval()(gt, train=False)))


def _max_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    mask = ~np.isnan(a)
    assert (mask == ~np.isnan(b)).all()
    a, b = a[mask], b[mask]
    return float(np.max(np.abs(a - b) / np.maximum(np.maximum(np.abs(a), np.abs(b)), 1e-12)))


@pytest.mark.parametrize("golden,recipe", [
    ("training_trajectory.npz", "st"),
    ("training_trajectory_flagship.npz", "flagship"),
    ("training_trajectory_gramvgg.npz", "gram-vgg"),
    ("training_trajectory_bb.npz", "bb"),
])
def test_trajectory_replays_in_full(tmp_path, golden, recipe):
    """20 warmup + 20 GAN steps through the port within test_trajectory.py's
    gates (module docstring)."""
    data = np.load(os.path.join(_GOLDENS, golden))
    assert str(data["recipe"]) == recipe if "recipe" in data.files else recipe == "st"
    cfg = _config(data, recipe, tmp_path)
    got, g, d = _replay(data, cfg)
    for name, tight in (("warm_losses", 2e-4), ("gan_g_losses", 2e-3),
                        ("gan_d_losses", 5e-3)):
        ref = data[name]
        assert got[name].shape == ref.shape == (20,), name
        head = _max_rel(ref[:5], got[name][:5])
        assert head < tight, (name, head)
        floor = _max_rel(ref, data["p_" + name])
        window = _max_rel(ref, got[name])
        assert window < max(tight, 30.0 * floor), (name, window, floor)
    (g_got, g_want), (d_got, d_want) = _probe_outputs(cfg, data, g, d)
    assert float((g_got - g_want).abs().max()) < 5e-2
    assert float((d_got - d_want).abs().max()) < 5e-1
