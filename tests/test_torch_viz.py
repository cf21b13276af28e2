"""The port's figure tools (srgan_st_tpu_torch/viz) against the JAX
package's (srgan_st_tpu/viz), on the CPU.

The same seeded images go through both; weights are carried from the JAX
models (the generator as a JAX-format g_best.npz, the discriminator as its
variables tree, VGG19 as a seeded npz both packages load). Sizes are those
of the trajectory goldens: a 2 RCB / 16 ch G, a 4 ch D. Files the JAX tools
write with PIL and the port's (zlib alone) are decoded with PIL and
compared as arrays.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
from srgan_st_tpu_torch.core.config import Config, apply_overrides
from srgan_st_tpu_torch.models.generator import random_variables

G_SETS = ["MODEL.G_N_RCB=2", "MODEL.G_N_CHANNEL=16", "MODEL.D_N_CHANNEL=4"]


def _configs(sets=()):
    from srgan_st_tpu.core.config import Config as JaxConfig

    cfg = apply_overrides(Config(), G_SETS + list(sets))
    jcfg = JaxConfig()
    for group in ("DATA", "MODEL", "TPU"):
        for key, value in getattr(cfg, group).items():
            if key in getattr(jcfg, group) and type(value).__name__ != "dotdict":
                getattr(jcfg, group)[key] = value
    return jcfg, cfg


def _read(path):
    with Image.open(path) as im:
        return im.mode, np.asarray(im)


def _save_png(path, arr_u8):
    Image.fromarray(arr_u8).save(path)


# ---------------------------------------------------------------------------
# save_image_patch

@pytest.fixture(scope="module")
def patch_set(tmp_path_factory):
    """A 192x192 GT, its [::4, ::4] LR (the JAX test's construction) and an
    experiment's g_best.npz."""
    from srgan_st_tpu_torch.train.checkpoint import save_variables_npz

    root = tmp_path_factory.mktemp("patch")
    gt = np.random.default_rng(0).integers(0, 256, (192, 192, 3), np.uint8)
    for name, img in (("gt", gt), ("lr", gt[::4, ::4])):
        os.makedirs(root / name)
        _save_png(root / name / "im.png", img)
    save_variables_npz(str(root / "results" / "exp1" / "g_best.npz"),
                       random_variables(0, channels=16, num_rcb=2, upscale=4))
    return root, gt


@pytest.mark.parametrize("tail", [None, "fused"])
def test_save_image_patch_matches_jax(patch_set, tail):
    """The boxed GT and the gt / bicubic / nearest crops decode to JAX's
    arrays exactly; the experiment's crop lies within one uint8 level of
    JAX's, its SR before the rounding within 1e-5 of max|SR|; under both
    tail modes (the fused one runs kernel B's plain version here)."""
    from srgan_st_tpu.eval.validate import make_generator_apply as jax_apply
    from srgan_st_tpu.train.checkpoint import load_params_npz as jax_load
    from srgan_st_tpu.viz.save_image_patch import save_image_patch as jax_save
    from srgan_st_tpu_torch.viz.save_image_patch import make_upscaler, save_image_patch

    root, gt = patch_set
    jcfg, cfg = _configs([f"TPU.TAIL_MODE={tail}"])
    for c in (jcfg, cfg):
        c.DATA.TEST_GT_IMAGES_DIR, c.DATA.TEST_LR_IMAGES_DIR = str(root / "gt"), str(root / "lr")
    names = ["gt", "bicubic", "nearest", "exp1"]
    kw = dict(y=10, x=20, patch_size=64, results_root=str(root / "results"))
    want = jax_save(jcfg, names, "im.png", out_dir=str(root / f"jax{tail}"), **kw)
    got = save_image_patch(cfg, names, "im.png", out_dir=str(root / f"port{tail}"),
                           device="cpu", **kw)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == [
        "im_gt_box.png", "im_gt.png", "im_bicubic.png", "im_nearest.png", "im_exp1.png"]
    for g, w in zip(got, want):
        (gm, ga), (wm, wa) = _read(g), _read(w)
        assert gm == wm == "RGB" and ga.shape == wa.shape
        if g.endswith("exp1.png"):
            assert np.abs(ga.astype(int) - wa.astype(int)).max() <= 1
        else:
            np.testing.assert_array_equal(ga, wa, err_msg=g)
    np.testing.assert_array_equal(_read(got[1])[1], gt[10:74, 20:84])
    lr = gt[::4, ::4].astype(np.float32)[None] / 255.0
    sr = make_upscaler(cfg, "exp1", str(root / "results"), "cpu")(lr).numpy()
    ref = np.asarray(jax_apply(jcfg, jax_load(str(root / "results" / "exp1" / "g_best.npz")))(lr))
    assert np.abs(sr - ref).max() <= 1e-5 * np.abs(ref).max()


def test_comparison_crops_is_the_served_frame(patch_set):
    """The array core's experiment crop is the same crop of a direct
    make_generator_apply call, rounded to uint8, bit for bit (the smoke's
    gate on the card)."""
    from srgan_st_tpu_torch.eval.validate import make_generator_apply
    from srgan_st_tpu_torch.train.checkpoint import load_params_npz
    from srgan_st_tpu_torch.viz.save_image_patch import comparison_crops

    root, gt = patch_set
    _, cfg = _configs()
    lr = gt[::4, ::4].astype(np.float32) / 255.0
    boxed, crops = comparison_crops(cfg, ["exp1", "gt"], gt, lr, 100, 30, 48,
                                    str(root / "results"), device="cpu")
    apply_fn = make_generator_apply(
        cfg, load_params_npz(str(root / "results" / "exp1" / "g_best.npz")), device="cpu")
    sr = np.clip(np.round(apply_fn(lr[None]).numpy()[0] * 255), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(crops["exp1"], sr[100:148, 30:78])
    assert list(crops) == ["exp1", "gt"] and boxed.shape == gt.shape
    assert (boxed[100:148, 30:33] == (255, 0, 0)).all()


# ---------------------------------------------------------------------------
# feature maps

def _jax_disc_variables(jcfg, h, w):
    """The JAX tool's own discriminator init at the image's size
    (srgan_st_tpu/viz/feature_maps.py:63-70)."""
    import jax
    import jax.numpy as jnp

    from srgan_st_tpu.models.discriminator import Discriminator

    model = Discriminator.from_config(jcfg)
    return jax.device_get(model.init(jax.random.key(0), jnp.zeros((1, h, w, 3)), train=False))


def _jax_feats(jcfg, extractor, img, variables):
    import jax.numpy as jnp

    from srgan_st_tpu.ops.color import imagenet_normalize

    x = imagenet_normalize(jnp.asarray(img[None]))
    if extractor == "vgg":
        from srgan_st_tpu.models.vgg import VGG19Features, load_vgg19_npz

        taps = tuple(jcfg.MODEL.G_LOSS.VGG19_LAYERS)
        return VGG19Features(taps=taps).apply(
            load_vgg19_npz(jcfg.MODEL.G_LOSS.VGG19_WEIGHTS, taps), x)
    from srgan_st_tpu.models.discriminator import Discriminator

    return Discriminator.from_config(jcfg).apply(
        variables, x, train=False, taps=tuple(jcfg.MODEL.G_LOSS.DISC_FEATURES_LOSS_LAYERS))


@pytest.mark.parametrize("extractor,hw", [("disc", (96, 96)), ("disc", (64, 80)),
                                          ("vgg", (48, 48))])
def test_feature_maps_match_jax(tmp_path, extractor, hw):
    """Activations per tap within 1e-5 of max|act| of the JAX models' on
    the same weights (the discriminator's at a size other than 96 too: its
    taps stop before the classifier, whose shape alone depends on the
    size); render_feature_maps writes grey PNGs whose grids lie within one
    uint8 level of the JAX tool's."""
    from srgan_st_tpu.viz.feature_maps import render_feature_maps as jax_render
    from srgan_st_tpu_torch.viz.feature_maps import feature_maps, render_feature_maps

    from tests.test_torch_vgg import write_vgg_npz

    vgg = write_vgg_npz(tmp_path / "vgg19.npz")
    jcfg, cfg = _configs()
    jcfg.MODEL.G_LOSS.VGG19_WEIGHTS = cfg.MODEL.G_LOSS.VGG19_WEIGHTS = vgg
    img_u8 = np.random.default_rng(1).integers(0, 256, (*hw, 3), np.uint8)
    img = img_u8.astype(np.float32) / 255.0
    variables = _jax_disc_variables(jcfg, *hw) if extractor == "disc" else None
    got = feature_maps(cfg, img, extractor, variables, device="cpu")
    want = _jax_feats(jcfg, extractor, img, variables)
    assert list(got) == list(want)
    for tap, w in want.items():
        w = np.asarray(w)
        assert got[tap].shape == w.shape, tap
        assert np.abs(got[tap].numpy() - w).max() <= 1e-5 * np.abs(w).max(), tap
    path = str(tmp_path / "im.png")
    _save_png(path, img_u8)
    jfiles = jax_render(jcfg, path, extractor, str(tmp_path / "jax"))
    pfiles = render_feature_maps(cfg, path, extractor, str(tmp_path / "port"), device="cpu",
                                 variables=variables)
    assert [os.path.basename(p) for p in pfiles] == [os.path.basename(p) for p in jfiles]
    for p, j in zip(pfiles, jfiles):
        (pm, pa), (jm, ja) = _read(p), _read(j)
        assert pm == jm == "L" and pa.shape == ja.shape
        assert np.abs(pa.astype(int) - ja.astype(int)).max() <= 1


def test_activation_grid_matches_jax():
    from srgan_st_tpu.viz.feature_maps import _activation_grid as jax_grid
    from srgan_st_tpu_torch.viz.feature_maps import _activation_grid

    rng = np.random.default_rng(2)
    for shape in ((5, 7, 3), (4, 4, 64), (3, 6, 80)):
        act = rng.standard_normal(shape).astype(np.float32)
        act[..., 0] = 1.5  # a constant map
        np.testing.assert_array_equal(_activation_grid(act), jax_grid(act))


@pytest.mark.parametrize("extractor", ["vgg", "disc"])
def test_random_init_is_torch_seeded(tmp_path, extractor):
    """Pinned divergence (ROADMAP.md Queue C): with no VGG19 file, and for
    the discriminator without given weights, the tool's random weights are
    drawn from a torch generator seeded with 0 (the JAX tool draws from
    jax.random.key(0), other numbers): the activations are those of the
    port's models so initialized."""
    from srgan_st_tpu_torch.models.common import init_weights
    from srgan_st_tpu_torch.models.discriminator import Discriminator
    from srgan_st_tpu_torch.models.vgg import VGG19Features, init_vgg19
    from srgan_st_tpu_torch.ops.color import imagenet_normalize
    from srgan_st_tpu_torch.viz.feature_maps import feature_maps

    _, cfg = _configs()
    cfg.MODEL.G_LOSS.VGG19_WEIGHTS = str(tmp_path / "absent.npz")
    img = np.random.default_rng(3).random((32, 32, 3), np.float32)
    got = feature_maps(cfg, img, extractor, device="cpu")
    x = imagenet_normalize(torch.from_numpy(img[None]))
    with torch.no_grad():
        if extractor == "vgg":
            model = VGG19Features(tuple(cfg.MODEL.G_LOSS.VGG19_LAYERS))
            init_vgg19(model, torch.Generator().manual_seed(0))
            want = model(x)
        else:
            model = Discriminator.from_config(cfg)
            init_weights(model, torch.Generator().manual_seed(0))
            want = model.eval()(x, taps=tuple(cfg.MODEL.G_LOSS.DISC_FEATURES_LOSS_LAYERS))
    assert list(got) == list(want)
    for tap in want:
        torch.testing.assert_close(got[tap], want[tap], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# best buddies

def _buddy_image(seed, hw, dup=False):
    img = np.random.default_rng(seed).integers(0, 256, (*hw, 3), np.uint8)
    if dup:
        img[15:30, 30:45] = img[0:15, 0:15]  # grid (1, 2) == grid (0, 0): the JAX test's
    return img


@pytest.mark.parametrize("case", ["duplicate", "flat_target", "l1"])
def test_buddy_illustration_matches_jax(tmp_path, case):
    """The same metadata as the JAX tool (target, grid, ksize, and per
    buddy its bank index, scale, row and column), scores within 1e-5
    relative (an exact duplicate's ~1e-5 rounding residue: both below 1e-3,
    the JAX test's bound), and, where the indices agree, the same written
    files: target crop, buddy crops and the marked image, pixel for
    pixel."""
    from srgan_st_tpu.viz.buddy_illustration import buddy_illustration as jax_buddy
    from srgan_st_tpu_torch.viz.buddy_illustration import buddy_illustration

    hw, target, kw = {"duplicate": ((60, 75), (0, 0), dict(k=3)),
                      "flat_target": ((64, 97), 13, dict(k=6)),
                      "l1": ((45, 62), (1, 2), dict(k=4, dist_norm="l1", alpha=0.5))}[case]
    path = str(tmp_path / "im.png")
    _save_png(path, _buddy_image(4, hw, dup=case == "duplicate"))
    want = jax_buddy(path, target, out_dir=str(tmp_path / "jax"), **kw)
    got = buddy_illustration(path, target, out_dir=str(tmp_path / "port"), device="cpu", **kw)
    for key in ("target", "grid", "ksize"):
        assert got[key] == want[key], key
    assert len(got["buddies"]) == len(want["buddies"]) == kw["k"]
    for g, w in zip(got["buddies"], want["buddies"]):
        assert {k: g[k] for k in g if k != "score"} == {k: w[k] for k in w if k != "score"}
        assert (abs(g["score"] - w["score"]) <= 1e-5 * abs(w["score"])
                or max(g["score"], w["score"]) < 1e-3), (g, w)
    if case == "duplicate":
        assert (got["buddies"][0]["scale"], got["buddies"][0]["row"],
                got["buddies"][0]["col"]) == (1.0, 1, 2)
    assert [os.path.basename(p) for p in got["written"]] == [
        os.path.basename(p) for p in want["written"]]
    for g, w in zip(got["written"], want["written"]):
        (gm, ga), (wm, wa) = _read(g), _read(w)
        assert gm == wm == "RGB"
        np.testing.assert_array_equal(ga, wa, err_msg=g)


def test_buddy_scores_rank_ties_stably():
    """rank_buddies excludes the target and breaks equal scores toward the
    lower bank index (the stable argsort of the JAX tool): a bank with
    copies of the target's best buddy."""
    from srgan_st_tpu_torch.viz.buddy_illustration import rank_buddies

    row = np.array([0.0, 3.0, 1.0, 1.0, 2.0, 1.0], np.float32)
    order, masked = rank_buddies(row, 0, 4)
    assert order.tolist() == [2, 3, 5, 4] and masked[0] == np.inf and row[0] == 0.0


# ---------------------------------------------------------------------------
# training curves

def _write_scalars(log_dir, jsonl, monkeypatch):
    """A run's scalars through the port's ExperimentWriter: tensorboardX
    events, or (tensorboardX hidden) the JSONL fallback."""
    import sys

    from srgan_st_tpu_torch.train.logging import ExperimentWriter

    if jsonl:
        monkeypatch.setitem(sys.modules, "tensorboardX", None)
    writer = ExperimentWriter(Config(), log_dir=str(log_dir))
    for step, (p, s) in enumerate([(25.0, 0.71), (27.5, 0.74), (28.25, 0.78)], start=1):
        writer.add_scalar("Test/PSNR", p, step)
        writer.add_scalar("Test/SSIM", s, step)
    writer.add_scalar("Train/G_Loss", 0.5, 100)
    writer.close()
    assert os.path.exists(log_dir / "scalars.jsonl") == jsonl


@pytest.mark.parametrize("fmt", ["jsonl", "events"])
def test_load_scalars_reads_the_port_logs(tmp_path, monkeypatch, fmt):
    """load_scalars gives the JAX tool's series for a directory the port's
    ExperimentWriter wrote: its JSONL fallback, and tensorboardX event
    files (read by TensorBoard's EventAccumulator)."""
    if fmt == "events":
        pytest.importorskip("tensorboardX")
    from srgan_st_tpu.viz.training_curves import load_scalars as jax_load
    from srgan_st_tpu_torch.viz.training_curves import load_scalars

    log_dir = tmp_path / "tensorboard" / "exp1"
    _write_scalars(log_dir, fmt == "jsonl", monkeypatch)
    got = load_scalars(str(log_dir))
    assert got == jax_load(str(log_dir))
    assert [s for s, _ in got["Test/PSNR"]] == [1, 2, 3]
    np.testing.assert_allclose([v for _, v in got["Test/SSIM"]], [0.71, 0.74, 0.78], rtol=1e-7)
    assert got["Train/G_Loss"] == [(100, 0.5)]


def test_plot_curves_matches_jax_pixel_for_pixel(tmp_path):
    """The same series give JAX's figure pixel for pixel (figure size,
    24-32 dB PSNR limits, labels, 150 dpi), two experiments, two tags."""
    from srgan_st_tpu.viz.training_curves import plot_curves as jax_plot
    from srgan_st_tpu_torch.viz.training_curves import plot_curves

    tb = tmp_path / "tensorboard"
    rng = np.random.default_rng(5)
    for exp in ("a", "b"):
        os.makedirs(tb / exp)
        with open(tb / exp / "scalars.jsonl", "w") as f:
            for step in range(1, 9):
                for tag, v in (("Test/PSNR", 24 + 7 * rng.random()), ("Test/SSIM", rng.random())):
                    f.write(json.dumps({"ts": 0, "tag": tag, "value": v, "step": step}) + "\n")
    args = (["a", "b"], ["Test/PSNR", "Test/SSIM"])
    got = plot_curves(*args, str(tmp_path / "port.png"), tb_root=str(tb))
    want = jax_plot(*args, str(tmp_path / "jax.png"), tb_root=str(tb))
    (gm, ga), (wm, wa) = _read(got), _read(want)
    assert gm == wm and ga.shape == wa.shape == (675, 1800, 4)
    np.testing.assert_array_equal(ga, wa)


# ---------------------------------------------------------------------------
# the command line

def _cli_inputs(tmp_path):
    img = str(tmp_path / "im.png")
    _save_png(img, _buddy_image(6, (45, 60)))
    log = tmp_path / "tensorboard" / "e"
    os.makedirs(log)
    (log / "scalars.jsonl").write_text(json.dumps(
        {"ts": 0, "tag": "Test/PSNR", "value": 26.0, "step": 1}) + "\n")
    return {"curves": ["curves", "--experiments", "e", "--tags", "Test/PSNR",
                       "--tb_root", str(tmp_path / "tensorboard"),
                       "--out", str(tmp_path / "figs" / "c.png")],
            "feature-maps": ["feature-maps", "--image", img, "--extractor", "disc",
                             "--out", str(tmp_path / "figs")],
            "buddy-viz": ["buddy-viz", "--image", img, "--patch", "1,2", "--k", "2",
                          "--out", str(tmp_path / "figs")]}


@pytest.mark.parametrize("command", ["curves", "feature-maps", "buddy-viz"])
def test_cli_commands_run_on_the_cpu(tmp_path, capsys, command):
    """`python -m srgan_st_tpu_torch curves | feature-maps --device cpu |
    buddy-viz --device cpu` write their figures."""
    from srgan_st_tpu_torch.__main__ import main

    argv = _cli_inputs(tmp_path)[command]
    main(argv + ([] if command == "curves" else ["--device", "cpu"]))
    written = [ln.split(" ", 1)[1] for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("wrote ")]
    assert written and all(os.path.exists(p) for p in written)
    assert len(written) == {"curves": 1, "feature-maps": 2, "buddy-viz": 4}[command]


@pytest.mark.parametrize("command", ["feature-maps", "buddy-viz"])
def test_cli_commands_do_not_fall_back_to_the_cpu(tmp_path, monkeypatch, command):
    """Without --device the tools run on CUDA: with no GPU they raise, and
    nothing falls back to the CPU."""
    from srgan_st_tpu_torch.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(_cli_inputs(tmp_path)[command])
    assert not os.path.exists(tmp_path / "figs") or not os.listdir(tmp_path / "figs")
