"""The RRDB generator (Real-ESRGAN x4plus, srgan_st_tpu_torch/models/rrdb.py)
on the CPU against the benchmark's plain reference
(benchmark/reference/rrdb.py) at a small size, its published state-dict
layout, the serving entry's dispatch with its spans and counter, `infer`
on a release-layout checkpoint, the refusals (training, export) and tiled
eval at the exact halo. Imports no JAX; the JAX package has no RRDB
generator to hold it to."""

import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
from srgan_st_tpu_torch.models.rrdb import RRDBNet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import seeded, seeded_rrdb  # noqa: E402
from benchmark.reference import rrdb as ref  # noqa: E402

SMALL = dict(num_in_ch=3, num_out_ch=3, num_feat=16, num_block=2, num_grow_ch=8, scale=4,
             dense_weight_gain=2.0, conv_last_scale=8.0)  # a frame of std ~0.1 at this size


def _weights(cfg=SMALL, seed=2**31 + 7):
    return seeded_rrdb.state(cfg, seeded.generator_for(seed, "cpu"), "cpu")


def _model(cfg=SMALL, dtype=torch.float32):
    m = RRDBNet(channels=cfg["num_feat"], num_block=cfg["num_block"],
                growth=cfg["num_grow_ch"], dtype=dtype)
    m.load_state_dict(_weights(cfg))
    return m.eval()


def _lr(h=12, w=10, seed=3):
    return torch.rand(1, h, w, 3, generator=torch.Generator().manual_seed(seed))


def _config(dtype="float32", **model):
    from srgan_st_tpu_torch.core.config import Config

    c = Config()
    c.MODEL.G_ARCH = "rrdb"
    c.MODEL.G_N_CHANNEL, c.MODEL.G_N_RCB, c.MODEL.G_N_GROW = (
        SMALL["num_feat"], SMALL["num_block"], SMALL["num_grow_ch"])
    for key, value in model.items():
        c.MODEL[key] = value
    c.TPU.COMPUTE_DTYPE = dtype
    return c


def test_rrdbnet_matches_the_plain_reference_in_float32():
    x = _lr()
    with torch.no_grad():
        got = _model()(x)
    want = ref.upscale(_weights(), x)
    assert got.shape == want.shape == (1, 48, 40, 3) and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert float(want.std()) > 0.05  # the frame is not flat


def test_rrdbnet_in_bfloat16_within_twice_the_references_own_envelope():
    """bf16 against the f32 reference: within 2x the gap of the reference
    itself computed in bf16 (its parameters and input cast), a fixed
    epsilon being wrong for a net this deep."""
    x = _lr()
    want = ref.upscale(_weights(), x)
    p16 = {k: v.bfloat16() for k, v in _weights().items()}
    with torch.no_grad():
        own = ref.generator(p16, x.bfloat16()).float()
        got = _model(dtype=torch.bfloat16)(x)
    envelope = float((own - want).abs().max())
    assert 0 < envelope and float((got - want).abs().max()) <= 2 * envelope


def _basicsr_shapes(nf=64, nb=23, gc=32):
    """RRDBNet(num_in_ch=3, num_out_ch=3, num_feat=nf, num_block=nb,
    num_grow_ch=gc) of basicsr's rrdbnet_arch.py, written out."""
    out = {"conv_first.weight": (nf, 3, 3, 3), "conv_first.bias": (nf,)}
    for i in range(nb):
        for j in (1, 2, 3):
            for k, (cin, cout) in enumerate(((nf, gc), (nf + gc, gc), (nf + 2 * gc, gc),
                                             (nf + 3 * gc, gc), (nf + 4 * gc, nf)), 1):
                out[f"body.{i}.rdb{j}.conv{k}.weight"] = (cout, cin, 3, 3)
                out[f"body.{i}.rdb{j}.conv{k}.bias"] = (cout,)
    for name in ("conv_body", "conv_up1", "conv_up2", "conv_hr"):
        out[f"{name}.weight"], out[f"{name}.bias"] = (nf, nf, 3, 3), (nf,)
    out["conv_last.weight"], out["conv_last.bias"] = (3, nf, 3, 3), (3,)
    return out


def test_the_published_configuration_has_basicsrs_state_dict():
    from benchmark import harness

    m = RRDBNet()
    want = _basicsr_shapes()
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == want
    assert list(m.state_dict()) == list(want)  # the same order: a release loads as is
    assert sum(p.numel() for p in m.parameters()) == 16_697_987
    cfg = harness.load_json("configs", "realesrgan_x4plus.json")
    assert {f"{n}.weight": s for n, s in seeded_rrdb.shapes(cfg)} == {
        k: v for k, v in want.items() if k.endswith("weight")}


def test_rrdbnet_init_is_basicsrs():
    """The dense blocks' convs kaiming-normal x 0.1 (std 0.1 sqrt(2 /
    fan_in)) with zero biases; the others torch's default."""
    torch.manual_seed(0)
    m = RRDBNet(channels=64, num_block=2)
    w = m.body[1].rdb2.conv5.weight.detach()
    assert float(w.std()) == pytest.approx(0.1 * (2 / (192 * 9)) ** 0.5, rel=0.05)
    assert float(m.body[1].rdb2.conv5.bias.detach().abs().max()) == 0.0
    bound = 1 / (64 * 9) ** 0.5
    assert float(m.conv_hr.weight.detach().abs().max()) <= bound
    assert float(m.conv_hr.bias.detach().abs().max()) > 0


def _paths(fn) -> list[str]:
    from srgan_st_tpu_torch.tools import profile_step as T

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return T._tree(T.trace_events(prof)[2])[2]


def test_the_serving_entry_dispatches_on_the_architecture():
    """make_generator_apply under G_ARCH "rrdb" builds RRDBNet from its
    state dict (tensors or arrays); a call opens the generator's regions
    under `serve.frame` and counts one trunk call and no kernel launch."""
    from srgan_st_tpu_torch import kernels
    from srgan_st_tpu_torch.eval.validate import make_generator_apply

    sd = _weights()
    fn = make_generator_apply(_config(), {k: v.numpy() for k, v in sd.items()}, "cpu")
    assert isinstance(fn.model, RRDBNet)
    x = _lr()
    kernels.reset_launch_counts()
    paths = _paths(lambda: fn(x))
    counts = kernels.launch_counts()
    assert counts.pop("rrdb_trunk") == 1 and set(counts.values()) == {0}
    frame = "serve.frame/g.forward"
    assert set(paths) == {"serve.frame", frame,
                          *(f"{frame}/g.{part}" for part in ("stem", "trunk", "upsample", "tail"))}
    assert float((fn(x) - ref.upscale(sd, x)).abs().max()) <= 1e-5
    kernels.reset_launch_counts()
    assert kernels.launch_counts()["rrdb_trunk"] == 0


def test_srresnet_stays_the_default_generator():
    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.models.generator import Generator, build_generator

    cfg = Config()
    assert cfg.MODEL.G_ARCH == "srresnet" and cfg.MODEL.G_N_GROW == 32
    assert type(build_generator(cfg)) is Generator
    cfg.MODEL.G_ARCH = "esrgan"
    with pytest.raises(ValueError, match="G_ARCH"):
        build_generator(cfg)


@pytest.mark.parametrize("layout", ["params_ema", "params", "bare", "npz"])
def test_infer_loads_a_release_checkpoint_and_derives_the_architecture(tmp_path, layout):
    """A `.pth` as Real-ESRGAN releases it ({"params_ema": sd}), or
    {"params": sd}, a bare state dict, or an npz of its names: the keys
    pick RRDBNet, the shapes its widths and depth."""
    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.eval.infer import make_infer_fn, upscale_image

    sd = _weights()
    if layout == "npz":
        path = str(tmp_path / "g.npz")
        np.savez(path, **{k: v.numpy() for k, v in sd.items()})
    else:
        path = str(tmp_path / "RealESRGAN_x4plus.pth")
        torch.save(sd if layout == "bare" else {layout: sd}, path)
    cfg = Config()
    fn = make_infer_fn(cfg, gpath=path, device="cpu")
    assert isinstance(fn.model, RRDBNet)
    assert (cfg.MODEL.G_ARCH, cfg.MODEL.G_N_CHANNEL, cfg.MODEL.G_N_RCB, cfg.MODEL.G_N_GROW,
            cfg.DATA.UPSCALE_FACTOR) == ("rrdb", 16, 2, 8, 4)
    lr = _lr(9, 11).numpy()[0]
    sr = upscale_image(fn, lr, 4)
    want = ref.upscale(sd, torch.from_numpy(np.pad(lr, ((0, 1), (0, 1), (0, 0)), mode="edge"))[
        None])[0, :36, :44].numpy()
    assert sr.shape == (36, 44, 3) and np.abs(sr - want).max() <= 1e-5


@pytest.mark.parametrize("entry", ["warmup", "train"])
def test_training_the_rrdb_generator_raises_at_set_up(entry):
    import importlib

    fn = getattr(importlib.import_module(f"srgan_st_tpu_torch.train.{entry}"), entry)
    cfg = _config()
    cfg.DATA.SYNTHETIC = True
    with pytest.raises(ValueError, match="eval only"):
        fn(cfg, device="cpu")


def test_export_refuses_the_rrdb_generator():
    from srgan_st_tpu_torch.eval.export import derive_arch, plain_eval_generator

    with pytest.raises(ValueError, match="SRResNet generators only"):
        derive_arch(_weights())
    with pytest.raises(ValueError, match="SRResNet generators only"):
        plain_eval_generator(_config(), {}, device="cpu")


def test_tiled_eval_equals_the_whole_frame_at_the_exact_halo():
    """The halo of `generator_halo(n, 4, "rrdb")`: 15 LR px an RRDB, 2 for
    conv_first and conv_body, 2 for the HR stage (349 at 23 blocks); tiled
    at it, a frame equals the whole frame; at a third of it, it does not."""
    from srgan_st_tpu_torch.eval.tiled import TiledApplier, generator_halo
    from srgan_st_tpu_torch.eval.validate import make_generator_apply

    assert generator_halo(23, 4, "rrdb") == 349 and generator_halo(16, 4) == 40
    cfg = dict(SMALL, num_block=1)
    halo = generator_halo(1, 4, "rrdb")
    assert halo == 19
    fn = make_generator_apply(_config(G_N_RCB=1), _weights(cfg), "cpu")
    x = _lr(52, 60, seed=5)
    whole = fn(x).numpy()
    tiled = TiledApplier(fn, upscale=4, tile=8, halo=halo, tile_batch=8)(x)
    assert tiled.shape == whole.shape and np.abs(tiled - whole).max() <= 1e-5
    short = TiledApplier(fn, upscale=4, tile=8, halo=halo // 3, tile_batch=8)(x)
    assert np.abs(short - whole).max() > 1e-3


def test_tiled_config_takes_the_rrdb_halo(monkeypatch):
    from srgan_st_tpu_torch.eval import tiled
    from srgan_st_tpu_torch.eval.validate import make_generator_apply

    cfg = _config(G_N_RCB=1)
    cfg.TPU.TILED_EVAL = True
    fn = make_generator_apply(cfg, _weights(dict(SMALL, num_block=1)), "cpu")
    assert isinstance(fn, tiled.TiledApplier) and fn.halo == 19
