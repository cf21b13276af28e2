"""The port's serving path against the JAX package, on the CPU.

Checkpoints are JAX-format npz files of seeded weights; the port serves
them with device="cpu", where its kernel wrappers run their plain
versions. Also: the metric helpers, the entry points' device rule, and
that no module of the port imports JAX or the JAX package.
"""

import ast
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from srgan_st_tpu_torch.kernels import launch_counts
from srgan_st_tpu_torch.models.generator import random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "srgan_st_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "srgan_st_tpu")


@pytest.fixture
def gpath(tmp_path):
    """A JAX-format g_best.npz: 16 channels, 2 RCBs, x4."""
    from srgan_st_tpu_torch.train.checkpoint import save_variables_npz

    path = str(tmp_path / "g_best.npz")
    save_variables_npz(path, random_variables(0, channels=16, num_rcb=2, upscale=4))
    return path


def _configs():
    from srgan_st_tpu.core.config import Config as JaxConfig
    from srgan_st_tpu_torch.core.config import Config

    return JaxConfig(), Config()


def _write_png(path, arr01):
    from PIL import Image

    Image.fromarray(np.rint(arr01 * 255).astype(np.uint8)).save(path)


def test_config_defaults_match_jax():
    jcfg, cfg = _configs()
    for section in ("EXP", "DATA", "MODEL", "TPU"):
        for key, value in getattr(cfg, section).items():
            assert getattr(jcfg, section)[key] == value, (section, key)


@pytest.mark.parametrize("hw", [(9, 11), (10, 7), (8, 8)])
def test_upscale_image_matches_jax(gpath, hw):
    """Odd LR sizes are edge-padded to even and cropped back, as in the
    JAX package; atol 1e-4: conv accumulation order."""
    from srgan_st_tpu.eval import infer as jinfer
    from srgan_st_tpu_torch.eval import infer

    jcfg, cfg = _configs()
    lr = np.random.default_rng(1).random((*hw, 3), np.float32)
    want = jinfer.upscale_image(jinfer.make_infer_fn(jcfg, gpath=gpath), lr, 4)
    before = launch_counts()
    apply_fn = infer.make_infer_fn(cfg, gpath=gpath, device="cpu")
    got = infer.upscale_image(apply_fn, lr, 4)
    assert launch_counts() == before
    assert got.shape == want.shape == (hw[0] * 4, hw[1] * 4, 3)
    assert (cfg.MODEL.G_N_CHANNEL, cfg.MODEL.G_N_RCB) == (16, 2)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_tiled_equals_whole_image(gpath):
    """TILED_EVAL: tiles slide inward at the borders and get >= halo px of
    context, so the stitched output is the whole-image output. atol 1e-5:
    the same convs on other batch shapes may sum in another order."""
    from srgan_st_tpu_torch.eval import infer
    from srgan_st_tpu_torch.eval.tiled import TiledApplier, generator_halo

    _, cfg = _configs()
    whole = infer.make_infer_fn(cfg, gpath=gpath, device="cpu")
    cfg.TPU.TILED_EVAL = True
    tiled = infer.make_infer_fn(cfg, gpath=gpath, device="cpu")
    assert isinstance(tiled, TiledApplier)
    assert tiled.halo == generator_halo(2, 4) == 12
    tiled.tile, tiled.tile_batch = 16, 4  # 3 x 4 tiles of 40 x 40 in 3 batches
    lr = np.random.default_rng(2).random((1, 48, 56, 3), np.float32)
    got = tiled(lr)
    assert isinstance(got, np.ndarray) and got.shape == (1, 192, 224, 3)
    np.testing.assert_allclose(got, whole(lr).numpy(), atol=1e-5)


def test_generator_halo_matches_jax():
    from srgan_st_tpu.eval.tiled import generator_halo as jax_halo
    from srgan_st_tpu_torch.eval.tiled import generator_halo

    for nrcb, up in [(16, 4), (2, 2), (4, 3), (16, 8)]:
        assert generator_halo(nrcb, up) == jax_halo(nrcb, up)


def test_derive_arch_matches_jax():
    from srgan_st_tpu.eval.export import derive_arch as jax_derive
    from srgan_st_tpu_torch.eval.export import derive_arch

    for ch, nrcb, up in [(16, 2, 4), (64, 16, 4), (32, 3, 3), (8, 1, 8)]:
        v = random_variables(0, channels=ch, num_rcb=nrcb, upscale=up)
        assert derive_arch(v) == jax_derive(v) == {
            "channels": ch, "num_rcb": nrcb, "upscale": up}


def test_infer_main_writes_pngs(gpath, tmp_path):
    """`infer` on a directory of PNGs writes <stem>_x4.png per input, the
    same images the JAX CLI writes (uint8 rounding of outputs that agree
    to 1e-4 may differ by one level)."""
    from srgan_st_tpu.eval import infer as jinfer
    from srgan_st_tpu_torch.eval import infer

    src = tmp_path / "in"
    src.mkdir()
    rng = np.random.default_rng(3)
    _write_png(src / "a.png", rng.random((9, 12, 3)))
    _write_png(src / "b.png", rng.random((8, 10, 3)))
    (src / "notes.txt").write_text("not an image")
    infer.main(["--input", str(src), "--output", str(tmp_path / "port"),
                "--gpath", gpath, "--device", "cpu"])
    jinfer.main(["--input", str(src), "--output", str(tmp_path / "jax"),
                 "--gpath", gpath])
    from PIL import Image

    assert sorted(os.listdir(tmp_path / "port")) == ["a_x4.png", "b_x4.png"]
    for name, size in (("a_x4.png", (48, 36)), ("b_x4.png", (40, 32))):
        got = np.asarray(Image.open(tmp_path / "port" / name), np.int16)
        want = np.asarray(Image.open(tmp_path / "jax" / name), np.int16)
        assert Image.open(tmp_path / "port" / name).size == size
        assert np.abs(got - want).max() <= 1


def test_validate_matches_jax(gpath, tmp_path):
    """validate() returns the JAX package's (PSNR, SSIM) on a tiny pair
    set read from GT/LR directories by TestPairSource."""
    from srgan_st_tpu.data.pipeline import TestPairSource as JaxPairs
    from srgan_st_tpu.train.checkpoint import load_params_npz as jax_load
    from srgan_st_tpu_torch.data.pipeline import TestPairSource
    from srgan_st_tpu_torch.eval import validate
    from srgan_st_tpu_torch.train.checkpoint import load_params_npz

    jval = importlib.import_module("srgan_st_tpu.eval.validate")
    rng = np.random.default_rng(4)
    gt_dir, lr_dir = tmp_path / "GTmod12", tmp_path / "LRbicx4"
    gt_dir.mkdir()
    lr_dir.mkdir()
    for i in range(3):
        hr = rng.random((32, 40, 3))
        _write_png(gt_dir / f"{i}.png", hr)
        _write_png(lr_dir / f"{i}.png", hr.reshape(8, 4, 10, 4, 3).mean((1, 3)))
    pairs, jpairs = TestPairSource(str(gt_dir), str(lr_dir)), JaxPairs(str(gt_dir), str(lr_dir))
    assert len(pairs) == len(jpairs) == 3
    for (g1, l1), (g2, l2) in zip(pairs, jpairs):
        np.testing.assert_array_equal(g1, g2)
        np.testing.assert_array_equal(l1, l2)

    jcfg, cfg = _configs()
    for c in (jcfg, cfg):
        c.DATA.TEST_SR_IMAGES_DIR = str(tmp_path / "out")
        c.MODEL.G_N_CHANNEL, c.MODEL.G_N_RCB = 16, 2
    want = jval.validate(jval.make_generator_apply(jcfg, jax_load(gpath)), jpairs, jcfg)
    got = validate.validate(
        validate.make_generator_apply(cfg, load_params_npz(gpath), device="cpu"),
        pairs, cfg, save_images=True, save_metrics=True)
    np.testing.assert_allclose(got, want, atol=1e-3)
    out = tmp_path / "out" / cfg.EXP.NAME
    assert sorted(os.listdir(out)) == ["0.png", "1.png", "2.png", "_metrics.txt"]
    assert validate.confidence_interval([1.0, 2.0, 4.0]) == pytest.approx(
        jval.confidence_interval([1.0, 2.0, 4.0]))


def test_metrics_match_jax():
    from srgan_st_tpu.ops import color as jcolor
    from srgan_st_tpu.ops import metrics as jmetrics
    from srgan_st_tpu_torch.ops import color, metrics

    rng = np.random.default_rng(5)
    a = rng.random((1, 24, 20, 3), np.float32)
    b = np.clip(a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), 0, 1)
    ia, ib = metrics.tensor2img(a), metrics.tensor2img(torch.from_numpy(b))
    np.testing.assert_array_equal(ia, jmetrics.tensor2img(a))
    np.testing.assert_array_equal(ib, jmetrics.tensor2img(b))
    for img in (ia, ia.astype(np.float32) / 255.0):
        for only_y in (True, False):
            np.testing.assert_array_equal(color.bgr2ycbcr(img, only_y),
                                          jcolor.bgr2ycbcr(img, only_y))
    ya = color.bgr2ycbcr(ia.astype(np.float32) / 255.0) * 255
    yb = color.bgr2ycbcr(ib.astype(np.float32) / 255.0) * 255
    assert metrics.psnr(ya, yb) == pytest.approx(jmetrics.psnr(ya, yb), abs=1e-9)
    assert metrics.ssim(ya, yb) == pytest.approx(jmetrics.ssim(ya, yb), abs=1e-9)
    assert metrics.psnr(ya, ya) == float("inf")


def test_entry_points_need_cuda_unless_cpu(gpath, monkeypatch, tmp_path):
    """With no GPU, an entry point raises unless the caller asks for the
    CPU; nothing falls back to the CPU quietly."""
    from srgan_st_tpu_torch.core.device import resolve_device
    from srgan_st_tpu_torch.eval import infer
    from srgan_st_tpu_torch.train.checkpoint import load_params_npz

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _configs()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer.make_infer_fn(cfg, gpath=gpath)
    from srgan_st_tpu_torch.eval.validate import make_generator_apply

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_generator_apply(cfg, load_params_npz(gpath))
    _write_png(tmp_path / "x.png", np.zeros((4, 4, 3)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer.main(["--input", str(tmp_path / "x.png"), "--output",
                    str(tmp_path / "o"), "--gpath", gpath])
    assert resolve_device("cpu") == torch.device("cpu")
    before = launch_counts()
    apply_fn = infer.make_infer_fn(cfg, gpath=gpath, device="cpu")
    assert apply_fn.device == torch.device("cpu")
    assert apply_fn(np.zeros((1, 8, 8, 3), np.float32)).device.type == "cpu"
    assert launch_counts() == before


def test_unported_options_raise(gpath, tmp_path):
    from srgan_st_tpu_torch.eval import infer
    from srgan_st_tpu_torch.eval.validate import make_generator_apply
    from srgan_st_tpu_torch.train.checkpoint import load_params_npz

    base = ["--input", str(tmp_path), "--output", str(tmp_path / "o"),
            "--gpath", gpath, "--device", "cpu"]
    _write_png(tmp_path / "x.png", np.zeros((4, 4, 3)))
    for extra in (["--artifact", "m.srganx"], ["--ensemble"],
                  ["--exp_name", "bicubic"], ["--exp_name", "nearest"]):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            infer.main(base + extra)
    _, cfg = _configs()
    cfg.TPU.SELF_ENSEMBLE = True
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_generator_apply(cfg, load_params_npz(gpath), device="cpu")


def test_cli_dispatch(capsys):
    from srgan_st_tpu_torch.__main__ import main

    main([])
    assert "infer" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:
        main(["train"])
    assert e.value.code == 2


def _port_sources():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_no_jax():
    """No module of the port, and not chip_smoke.py, imports JAX, flax or
    the JAX package: every import statement, lazy ones included, and
    every module actually imported in a fresh interpreter."""
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)
    code = (
        "import importlib, pkgutil, sys\n"
        "import srgan_st_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'srgan_st_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "assert 'PIL' not in sys.modules\n"
        "print(len([m for m in sys.modules if m.startswith('srgan_st_tpu_torch')]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
