"""benchmark/reference agrees with srgan_st_tpu_torch at a small size, in
float32 on the CPU: the degradation, G and D forwards, the criteria, and
a whole GAN step with Adam."""

import functools

import pytest
import torch

from benchmark import harness, seeded
from benchmark.harness import program_config
from benchmark.reference import losses, models, resize, serve, train

CFG = dict(harness.load_json("configs", "srgan_st_x4.json"), g_channels=16, g_num_rcb=2,
           d_channels=8, batch_size=2, compute_dtype="float32")


def program_models(cfg, g_sd, d_sd=None):
    from srgan_st_tpu_torch.models.discriminator import Discriminator
    from srgan_st_tpu_torch.models.generator import Generator

    config = program_config(cfg)
    g = Generator.from_config(config)
    g.load_state_dict(g_sd)
    d = None
    if d_sd is not None:
        d = Discriminator.from_config(config)
        d.load_state_dict(d_sd)
    return config, g, d


@pytest.fixture(scope="module")
def states():
    gen = seeded.generator_for(7, "cpu")
    return (seeded.generator_state(CFG, gen, "cpu"), seeded.discriminator_state(CFG, gen, "cpu"),
            seeded.patch_pool(gen, 2, 2, 96, "cpu"))


def test_degradation_matches_the_programs(states):
    from srgan_st_tpu_torch.train.steps import _prepare_batch

    gt_u8 = states[2][0]
    gt_p, lr_p = _prepare_batch(gt_u8, program_config(CFG), "cpu")
    gt_r, lr_r = resize.degrade(gt_u8, 4)
    assert torch.equal(gt_p, gt_r)
    diff = (lr_p - lr_r).abs()
    assert float(diff.max()) <= 1 / 255 + 1e-6  # a rounding tie of round(255 x) may fall apart
    assert float(diff.mean()) < 1e-4


@pytest.mark.parametrize("train_mode", [True, False])
def test_generator_matches(states, train_mode):
    g_sd = seeded.generator_state(CFG, seeded.generator_for(3, "cpu"), "cpu", serving=True)
    _, g, _ = program_models(CFG, g_sd)
    lr = torch.rand(2, 12, 16, 3, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = g(lr, train=train_mode)
        want = (models.generator({k: v for k, v in g_sd.items()}, lr, True) if train_mode
                else serve.upscale(g_sd, lr))
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-4)


def test_discriminator_and_its_taps_match(states):
    g_sd, d_sd, pool = states
    _, _, d = program_models(CFG, g_sd, d_sd)
    x = pool[0].float() / 255
    with torch.no_grad():
        taps = ("features.4", "features.10")
        got = d(x, train=False, taps=taps)  # before a train-mode call moves the statistics
        want = models.discriminator(d_sd, x, False, taps)
        for t in taps:
            torch.testing.assert_close(got[t].permute(0, 3, 1, 2), want[t], atol=1e-5,
                                       rtol=1e-4)
        torch.testing.assert_close(d(x, train=True), models.discriminator(d_sd, x, True),
                                   atol=1e-4, rtol=1e-4)


def test_criteria_match(states):
    from srgan_st_tpu_torch.losses import functions as F
    from srgan_st_tpu_torch.losses.functions import adversarial_loss

    g_sd, d_sd, pool = states
    gen = torch.Generator().manual_seed(1)
    gt = pool[0].float() / 255
    sr = (gt + 0.05 * torch.randn(gt.shape, generator=gen)).clamp(0, 1)
    torch.testing.assert_close(F.pixel_loss(sr, gt), losses.mse(sr, gt))
    logits = torch.randn(4, 1, generator=gen)
    torch.testing.assert_close(adversarial_loss(logits, 0.9), losses.bce_logits(logits, 0.9))
    torch.testing.assert_close(F.patchwise_st_loss(sr, gt), losses.patchwise_st(sr, gt),
                               atol=1e-5, rtol=1e-5)
    _, _, d = program_models(CFG, g_sd, d_sd)
    d.eval()
    taps = CFG["content_disc_taps"]
    d_apply = functools.partial(d, train=False, taps=tuple(taps))
    torch.testing.assert_close(
        F.content_loss_discriminator(sr, gt, d_apply, taps),
        losses.content_discriminator(sr, gt, d_sd, taps), atol=1e-6, rtol=1e-4)


def test_a_gan_step_with_adam_matches(states):
    from srgan_st_tpu_torch.losses.registry import build_criterions
    from srgan_st_tpu_torch.train.steps import GANTrainState, make_d_optimizer, \
        make_g_optimizer, make_gan_steps

    g_sd, d_sd, pool = states
    cfg = dict(CFG, criteria={"Adversarial": {"kind": "adversarial", "weight": 0.001},
                              "Pixel": {"kind": "pixel", "weight": 1.0}})
    config, g, d = program_models(cfg, g_sd, d_sd)
    state = GANTrainState(g, make_g_optimizer(config, g.parameters(), 1, milestones=False), d,
                          make_d_optimizer(config, d.parameters(), 1))
    g_step, d_step = make_gan_steps(config, build_criterions(config))
    _, sr, g_metrics = g_step(state, pool[0])
    _, d_metrics = d_step(state, pool[0], sr)
    ref = train.run_steps(cfg, "gan", g_sd, d_sd, [pool[0]])
    assert abs(float(g_metrics["G_Loss"]) - ref["loss"][0]["G"]) < 1e-5
    assert abs(float(d_metrics["D_Loss"]) - ref["loss"][0]["D"]) < 1e-5
    for model, params in ((g, ref["g_params"]), (d, ref["d_params"])):
        for name, p in model.named_parameters():
            # Adam's first update moves a weight by lr whatever the size of
            # its gradient: a rounding-size gradient may flip its sign
            assert float((p.detach() - params[name]).abs().max()) <= 2.01e-4, name
        agree = [float((p.detach() - params[name]).abs().max()) < 1e-6
                 for name, p in model.named_parameters()]
        assert sum(agree) > 0.9 * len(agree)
