"""The work counts against figures worked out by hand."""

import pytest

from benchmark import harness, work

CFG = harness.load_json("configs", "srgan_x4.json")
ST = harness.load_json("configs", "srgan_st_x4.json")


def close(value, expected, digits):
    return round(value / 10 ** digits) == round(expected / 10 ** digits)


def test_generator_forward_of_a_96px_patch_and_of_a_4k_frame():
    assert close(work.generator_fwd_flops(24, 24, CFG), 2.555e9, 6)
    assert close(work.generator_fwd_flops(540, 960, CFG), 2.30e12, 10)


D_FWD = 2 * ((96 * 96 * 3 * 64 + 48 * 48 * 64 * 64 + 48 * 48 * 64 * 128 + 24 * 24 * 128 * 128
               + 24 * 24 * 128 * 256 + 12 * 12 * 256 * 256 + 12 * 12 * 256 * 512
               + 6 * 6 * 512 * 512) * 9 + 18432 * 1024 + 1024)


def test_discriminator_forward_and_its_taps():
    assert work.discriminator_fwd_flops(CFG) == D_FWD
    assert close(D_FWD, 1.768e9, 6)
    # conv0, conv1 (s2), conv2, conv3 (s2): up to features.10
    taps = 2 * (96 * 96 * 3 * 64 + 48 * 48 * 64 * 64 + 48 * 48 * 64 * 128
                + 24 * 24 * 128 * 128) * 9
    assert work.discriminator_fwd_flops(CFG, 10) == taps


def test_kernel_a_at_4k_and_the_trunk_kernels_at_the_training_shape():
    flops, nbytes = work.coarse_tail(1, 1080, 1920, 256, 3)
    assert close(flops, 258.0e9, 8)
    assert nbytes == 2 * (1080 * 1920 * 256 + 2160 * 3840 * 3 + 81 * 64 * 3)
    t = work.trunk(16, 24, 24, 64, 16)
    assert close(t["fwd"][0], 21.7e9, 8)
    assert close(t["bwd"][0], 43.5e9, 8)
    assert work.bound_seconds(*t["fwd"]) == t["fwd"][0] / work.PEAK_BF16_FLOPS


def test_buddy_selection_at_its_bank_shapes():
    n, m, d = work.st_bank_rows(ST)
    assert (n, m, d) == (1024, 1344, 27)
    flops, _ = work.buddy_selection(16, n, m, d)
    assert close(flops, 2.38e9, 7)


@pytest.mark.parametrize("cfg,phase,expected", [
    (CFG, "warmup", 3 * 2.555e9),
    (CFG, "gan", 3 * 2.555e9 + 2 * D_FWD + 6 * D_FWD / 100),
])
def test_recipe_flops_a_patch(cfg, phase, expected):
    assert abs(work.train_flops_per_patch(cfg, phase) / expected - 1) < 1e-3


def test_recipe_of_the_st_study_counts_its_taps_and_selection():
    gan = work.train_flops_per_patch(CFG, "gan")
    st = work.train_flops_per_patch(ST, "gan")
    taps = 3 * work.discriminator_fwd_flops(ST, 10)
    sel = work.buddy_selection(1, 1024, 1344, 27)[0]
    # ST has no Pixel term (0 FLOPs) and adds the content D's taps and the selection
    assert abs(st - (gan + taps + sel)) < 1.0


def test_an_uncounted_criterion_gives_no_count():
    cfg = dict(CFG, criteria={"ContentVGG": {"kind": "content_vgg", "weight": 1.0}})
    assert work.train_flops_per_patch(cfg, "gan") is None
