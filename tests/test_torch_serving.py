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

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
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
    """Every key of the port's config (nested groups key by key: the port's
    MODEL.G_LOSS holds only the criterion keys it reads) has the JAX
    package's default, but for the port's own keys: TPU.CUDA_GRAPHS (the
    step's captured CUDA graphs, which JAX's jit has no switch for),
    MODEL.G_ARCH, MODEL.G_N_GROW (the port's second generator, RRDBNet) and
    SwinIR's seven keys (its third)."""
    jcfg, cfg = _configs()
    port_only = {("TPU", "CUDA_GRAPHS"), ("MODEL", "G_ARCH"), ("MODEL", "G_N_GROW"),
                 *(("MODEL", k) for k in ("G_EMBED_DIM", "G_N_RSTB", "G_RSTB_DEPTH", "G_N_HEADS",
                                          "G_WINDOW", "G_MLP_RATIO", "G_HR_CHANNEL"))}
    for section in ("EXP", "DATA", "MODEL", "TPU", "SOLVER", "SCHEDULER"):
        for key, value in getattr(cfg, section).items():
            if (section, key) in port_only:
                assert key not in getattr(jcfg, section), (section, key)
                continue
            want = getattr(jcfg, section)[key]
            if type(value).__name__ == "dotdict":
                for sub, v in value.items():
                    assert want[sub] == v, (section, key, sub)
            else:
                assert want == value, (section, key)
    for key in ("LOG_TRAIN_PERIOD", "LOG_VALIDATION_PERIOD", "D_CHECKPOINT_INTERVAL",
                "G_CHECKPOINT_INTERVAL"):
        assert getattr(jcfg, key) == getattr(cfg, key), key


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
    """Every serving option of the JAX CLI is ported (the x8 ensemble, the
    baselines, artifacts); what raises is what the JAX CLI refuses: flags
    that reconfigure a live model beside --artifact, and --ensemble on a
    non-square fixed-shape artifact; a file that is not an artifact of the
    port raises too."""
    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.eval import infer
    from srgan_st_tpu_torch.eval.export import export_generator, load_runner, save_artifact
    from srgan_st_tpu_torch.train.checkpoint import load_params_npz

    cfg = Config()
    cfg.MODEL.G_N_CHANNEL, cfg.MODEL.G_N_RCB = 16, 2
    art = str(tmp_path / "m.srganx")
    save_artifact(art, *export_generator(cfg, load_params_npz(gpath), fixed_shape=(1, 4, 6),
                                         device="cpu"))
    _write_png(tmp_path / "x.png", np.zeros((4, 6, 3)))
    base = ["--input", str(tmp_path / "x.png"), "--output", str(tmp_path / "o"),
            "--device", "cpu", "--artifact", art]
    for extra, match in ((["--gpath", gpath], "--gpath does not apply"),
                         (["--tiled"], "--tiled does not apply"),
                         (["--bf16"], "--bf16 does not apply"),
                         (["--ensemble"], "must be square")):
        with pytest.raises(SystemExit, match=match):
            infer.main(base + extra)
    with pytest.raises(ValueError, match="not a srgan-st-tpu export artifact"):
        load_runner(gpath, device="cpu")


def test_cli_dispatch(capsys):
    from srgan_st_tpu_torch.__main__ import main

    main([])
    usage = capsys.readouterr().out
    assert all(cmd in usage for cmd in ("infer", "validate", "warmup", "train", "run",
                                        "export"))
    with pytest.raises(SystemExit) as e:
        main(["bench"])  # a command of the JAX package not ported yet
    assert e.value.code == 2


# ---------------------------------------------------------------------------
# the x8 self-ensemble, the baselines and the exported artifacts

def test_dihedral_round_trips_match_jax():
    """dihedral / dihedral_inverse are the JAX functions on a non-square
    batch, and each inverse undoes its transform."""
    from srgan_st_tpu.eval import ensemble as jens
    from srgan_st_tpu_torch.eval import ensemble

    x = np.random.default_rng(6).random((2, 5, 7, 3), np.float32)
    for k in range(4):
        for flip in (False, True):
            y = ensemble.dihedral(x, k, flip)
            np.testing.assert_array_equal(y, jens.dihedral(x, k, flip))
            np.testing.assert_array_equal(ensemble.dihedral_inverse(y, k, flip), x)


def test_self_ensemble_matches_jax(gpath):
    """The x8 ensemble of the port's generator against the JAX package's
    ensemble of its generator on the same weights and an odd, non-square
    batch: within 1e-4 (the generators' f32 parity), and the port's
    generator ran 8 times."""
    from srgan_st_tpu.eval.ensemble import self_ensemble as jax_ensemble
    from srgan_st_tpu.eval.validate import make_generator_apply as jax_apply
    from srgan_st_tpu.train.checkpoint import load_params_npz as jax_load
    from srgan_st_tpu_torch.eval.ensemble import self_ensemble
    from srgan_st_tpu_torch.eval.validate import make_generator_apply
    from srgan_st_tpu_torch.train.checkpoint import load_params_npz

    jcfg, cfg = _configs()
    for c in (jcfg, cfg):
        c.MODEL.G_N_CHANNEL, c.MODEL.G_N_RCB = 16, 2
    lr = np.random.default_rng(7).random((1, 7, 9, 3), np.float32)
    want = np.asarray(jax_ensemble(jax_apply(jcfg, jax_load(gpath)))(lr))
    live = make_generator_apply(cfg, load_params_npz(gpath), device="cpu")
    shapes = []
    got = self_ensemble(lambda x: shapes.append(x.shape) or live(x))(lr)
    assert got.dtype == np.float32 and got.shape == want.shape == (1, 28, 36, 3)
    assert sorted(set(shapes)) == [(1, 7, 9, 3), (1, 9, 7, 3)] and len(shapes) == 8
    np.testing.assert_allclose(got, want, atol=1e-4)
    cfg.TPU.SELF_ENSEMBLE = True
    np.testing.assert_array_equal(
        make_generator_apply(cfg, load_params_npz(gpath), device="cpu")(lr), got)


@pytest.mark.parametrize("name", ["bicubic", "nearest"])
def test_baselines_match_jax(name):
    """BicubicUpscaler (MATLAB bicubic x4 with its quantization) and
    NearestNeighbourUpscaler equal the JAX baselines bit for bit on a
    uint8-valued odd batch."""
    from srgan_st_tpu.models import baselines as jb
    from srgan_st_tpu_torch.models import baselines

    cls = {"bicubic": "BicubicUpscaler", "nearest": "NearestNeighbourUpscaler"}[name]
    lr = np.random.default_rng(8).integers(0, 256, (2, 9, 11, 3)).astype(np.float32) / 255
    want = np.asarray(getattr(jb, cls)(4)(jnp_asarray(lr)))
    got = getattr(baselines, cls)(4, device="cpu")(lr)
    assert got.device.type == "cpu" and got.shape == (2, 36, 44, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def jnp_asarray(x):
    import jax.numpy as jnp

    return jnp.asarray(x)


def test_validate_baseline_matches_jax(tmp_path):
    """test() with EXP.NAME "bicubic" scores the baseline on the pair set,
    as the JAX package's test() does: (PSNR, SSIM) within 1e-6."""
    from srgan_st_tpu_torch.eval import validate

    jval = importlib.import_module("srgan_st_tpu.eval.validate")
    rng = np.random.default_rng(9)
    gt_dir, lr_dir = tmp_path / "GTmod12", tmp_path / "LRbicx4"
    gt_dir.mkdir()
    lr_dir.mkdir()
    for i in range(2):
        hr = rng.random((32, 40, 3))
        _write_png(gt_dir / f"{i}.png", hr)
        _write_png(lr_dir / f"{i}.png", hr.reshape(8, 4, 10, 4, 3).mean((1, 3)))
    jcfg, cfg = _configs()
    for c in (jcfg, cfg):
        c.EXP.NAME = "bicubic"
        c.DATA.TEST_GT_IMAGES_DIR, c.DATA.TEST_LR_IMAGES_DIR = str(gt_dir), str(lr_dir)
        c.DATA.TEST_SR_IMAGES_DIR = str(tmp_path / "out")
    want = jval.test(jcfg, save_images=False)
    got = validate.test(cfg, save_images=True, device="cpu")
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert "_metrics.txt" in os.listdir(tmp_path / "out" / "bicubic")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_round_trip_is_bit_exact(gpath, tmp_path, dtype):
    """A dynamic-shape artifact, saved and loaded, equals the live plain
    generator bit for bit at two sizes (one odd) and two batch sizes; a
    fixed-shape one at its shape; the header carries the JAX header's
    fields with `torch_version` and `devices` in place of `jax_version` and
    `platforms`."""
    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.eval import export as ex
    from srgan_st_tpu_torch.train.checkpoint import load_params_npz

    cfg = Config()
    cfg.MODEL.G_N_CHANNEL, cfg.MODEL.G_N_RCB = 16, 2
    cfg.TPU.COMPUTE_DTYPE = dtype
    variables = load_params_npz(gpath)
    rng = np.random.default_rng(10)
    for fixed, sizes in ((None, [(1, 8, 10), (2, 7, 9)]), ((1, 6, 8), [(1, 6, 8)])):
        path = str(tmp_path / f"g{fixed is None}.srganx")
        ex.save_artifact(path, *ex.export_generator(cfg, variables, fixed_shape=fixed,
                                                    device="cpu"))
        meta = ex.inspect_artifact(path)
        assert meta["format"] == "srgan-st-tpu-torch/torch.export"
        assert (meta["upscale"], meta["channels"], meta["num_rcb"]) == (4, 16, 2)
        assert meta["compute_dtype"] == dtype and meta["devices"] == ["cpu"]
        assert meta["fixed_shape"] == (list(fixed) if fixed else None)
        assert meta["torch_version"] == torch.__version__ and meta["n_params"] > 0
        run = ex.load_runner(path, device="cpu")
        assert run.meta == meta
        live = ex.plain_eval_generator(cfg, variables, fixed is None, "cpu")
        for b, h, w in sizes:
            lr = torch.from_numpy(rng.random((b, h, w, 3), np.float32))
            with torch.inference_mode():
                want = live(lr)
            got = run(lr.numpy())
            assert got.dtype == torch.float32 and got.shape == (b, 4 * h, 4 * w, 3)
            assert torch.equal(got, want), (fixed, (b, h, w))


def test_infer_cli_serves_artifact_ensemble_and_bicubic(gpath, tmp_path):
    """`export` then `infer --artifact` writes the live generator's PNG;
    `--ensemble` and `--exp_name bicubic` write theirs, each the image the
    JAX CLI writes from the same input within one level (the generators
    agree to 1e-4; the baseline bit for bit)."""
    from PIL import Image

    from srgan_st_tpu.eval import infer as jinfer
    from srgan_st_tpu_torch.__main__ import main

    img = tmp_path / "a.png"
    _write_png(img, np.random.default_rng(11).random((7, 9, 3)))
    art = str(tmp_path / "g.srganx")
    main(["export", "--gpath", gpath, "--out", art, "--device", "cpu"])
    runs = {"live": ["--gpath", gpath], "artifact": ["--artifact", art],
            "ensemble": ["--gpath", gpath, "--ensemble"],
            "bicubic": ["--exp_name", "bicubic"]}
    out = {}
    for name, extra in runs.items():
        main(["infer", "--input", str(img), "--output", str(tmp_path / name),
              "--device", "cpu", *extra])
        out[name] = np.asarray(Image.open(tmp_path / name / "a_x4.png"), np.int16)
        assert out[name].shape == (28, 36, 3)
    np.testing.assert_array_equal(out["artifact"], out["live"])
    for name in ("ensemble", "bicubic"):
        jinfer.main(["--input", str(img), "--output", str(tmp_path / f"jax-{name}"),
                     *runs[name]])
        want = np.asarray(Image.open(tmp_path / f"jax-{name}" / "a_x4.png"), np.int16)
        assert np.abs(out[name] - want).max() <= (0 if name == "bicubic" else 1), name


def test_validate_cli_ensemble_and_baseline(tmp_path, monkeypatch, capsys):
    """`validate --ensemble` (the default-width generator, as the CLI
    builds it) and `validate --exp_name nearest` run on a Set5-style layout
    and write their metrics."""
    from srgan_st_tpu_torch.__main__ import main
    from srgan_st_tpu_torch.train.checkpoint import save_variables_npz

    monkeypatch.chdir(tmp_path)
    gpath = str(tmp_path / "g.npz")
    save_variables_npz(gpath, random_variables(0))
    rng = np.random.default_rng(12)
    for sub, size in (("GTmod12", (16, 20)), ("LRbicx4", (4, 5))):
        d = tmp_path / "data" / "Tiny" / sub
        d.mkdir(parents=True)
        _write_png(d / "0.png", rng.random((*size, 3)))
    base = ["validate", "--test_set", "Tiny", "--data_root", "data", "--device", "cpu"]
    main(base + ["--exp_name", "g", "--gpath", gpath, "--ensemble"])
    main(base + ["--exp_name", "nearest"])
    assert capsys.readouterr().out.count("[Test]") == 2
    for name in ("g", "nearest"):
        assert (tmp_path / "results" / "_test" / "Tiny" / name / "_metrics.txt").exists()


def _port_sources():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(REPO, "chip_smoke.py")


# the data and multi-GPU modules, which keep their own copies of the JAX
# package's pure-Python ones (data/volumes.py, data/prepare_dataset.py),
# the figure tools (viz/training_curves.py is one such copy), and the soak,
# the loss study, the per-op profile, the trajectory replay and its probe
# (tools/)
NEW_MODULES = ("srgan_st_tpu_torch.parallel.distributed", "srgan_st_tpu_torch.parallel.mesh",
               "srgan_st_tpu_torch.data.prepare_dataset", "srgan_st_tpu_torch.data.volumes",
               "srgan_st_tpu_torch.viz.save_image_patch", "srgan_st_tpu_torch.viz.feature_maps",
               "srgan_st_tpu_torch.viz.buddy_illustration",
               "srgan_st_tpu_torch.viz.training_curves", "srgan_st_tpu_torch.tools.soak",
               "srgan_st_tpu_torch.tools.loss_study", "srgan_st_tpu_torch.tools.profile_step",
               "srgan_st_tpu_torch.tools.trajectory", "srgan_st_tpu_torch.tools.trajectory_probe")
# the JAX package's tools/ scripts (crosscheck_training_vs_reference,
# onchip_trajectory_smoke, ...), which the port keeps its own copies of
TOOLS = ("tools", *sorted(f[:-3] for f in os.listdir(os.path.join(REPO, "tools"))
                          if f.endswith(".py")))


def test_port_imports_no_jax():
    """No module of the port (viz/ and tools/ included), and not
    chip_smoke.py, imports JAX, flax, the JAX package or
    a script of the repo's tools/ (the trajectory tool keeps its own feed
    and VGG19 stub): every import statement, lazy ones included, and every
    module actually imported in a fresh interpreter, where importing them
    all imports no PIL, matplotlib or TensorBoard either (the card machine
    has none)."""
    assert {"crosscheck_training_vs_reference", "onchip_trajectory_smoke"} <= set(TOOLS)
    sources = list(_port_sources())
    assert os.path.join(PORT, "tools", "trajectory.py") in sources and len(sources) >= 70
    checked = dict.fromkeys(sources, 0)  # import statements read, per file
    for path in sources:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                # a relative import (`from .tools import x`) is the port's own
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN + TOOLS, (path, name)
                checked[path] += 1
    assert checked[os.path.join(PORT, "tools", "trajectory.py")] >= 10
    assert checked[os.path.join(PORT, "tools", "trajectory_probe.py")] >= 8
    assert sum(checked.values()) >= 500, sum(checked.values())
    code = (
        "import importlib, pkgutil, sys\n"
        "import srgan_st_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'srgan_st_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN + TOOLS!r}]\n"
        "assert not bad, bad\n"
        "assert not [m for m in ('PIL', 'matplotlib', 'tensorboard') if m in sys.modules]\n"
        "print(len([m for m in sys.modules if m.startswith('srgan_st_tpu_torch')]))\n"
        "print(all(m in sys.modules for m in " + repr(NEW_MODULES) + "))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, new = out.stdout.split()
    assert int(count) >= 20 and new == "True"
