"""The port's VGG19 feature extractor and ContentVGG criterion against the
JAX package's, on the CPU.

The weights are a seeded random VGG19 written in tools/convert_vgg19.py's
npz format (HWIO kernels under torchvision's `features.{i}.*` keys): no
pretrained artifact is needed, and both packages load the same file. The
inputs are drawn from a numpy seed and compared in f32, where exact ReLU
zeros and max-pool ties (on which torch's and JAX's gradients may route
differently) have measure zero. Each test states its tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
from srgan_st_tpu_torch.models import vgg as pv

TAPS = ("features.17", "features.26", "features.35")


def write_vgg_npz(path, seed=0):
    """A seeded random VGG19 in the converter's npz format: He-normal HWIO
    kernels (activations keep their scale through the 16 convs), small
    biases."""
    rng = np.random.default_rng(seed)
    arrs = {}
    for key, shape in pv.expected_torch_shapes().items():
        if key.endswith(".weight"):
            o, i, kh, kw = shape
            arrs[key] = (rng.standard_normal((kh, kw, i, o)) * np.sqrt(2 / (9 * i))).astype(np.float32)
        else:
            arrs[key] = (0.01 * rng.standard_normal(shape)).astype(np.float32)
    np.savez(path, **arrs)
    return str(path)


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    return write_vgg_npz(tmp_path_factory.mktemp("vgg") / "vgg19.npz")


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(1)
    return rng.random((2, 48, 48, 3), np.float32), rng.random((2, 48, 48, 3), np.float32)


def _config(npz, dtype="float32"):
    from srgan_st_tpu_torch.core.config import Config

    cfg = Config()
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.MODEL.G_LOSS.VGG19_WEIGHTS = npz
    return cfg


def test_layout_matches_jax():
    """The layout, the torch indices and the manifest shapes are the JAX
    module's."""
    from srgan_st_tpu.models import vgg as jv

    assert pv.VGG19_LAYOUT == jv.VGG19_LAYOUT
    assert pv._torch_indices() == jv._torch_indices()
    assert pv.expected_torch_shapes() == jv.expected_torch_shapes()


def test_taps_match_jax(npz, images):
    """Taps 17 / 26 / 35 of VGG19Features against the JAX module on the same
    npz at (2, 48, 48, 3) in f32: within 1e-5 relative to max|ref|."""
    from srgan_st_tpu.models import vgg as jv

    x = images[0]
    want = jv.VGG19Features(taps=TAPS).apply(jv.load_vgg19_npz(npz, TAPS), jnp.asarray(x))
    model = pv.VGG19Features(TAPS)
    model.load_state_dict(pv.load_vgg19_npz(npz, TAPS))
    got = model(torch.from_numpy(x))
    assert set(got) == set(TAPS)
    for tap in TAPS:
        w, g = np.asarray(want[tap]), got[tap].numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), tap
    assert not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("path", ["two_forward", "remat", "pair"])
def test_content_loss_vgg_matches_jax(npz, images, path):
    """ContentVGG built by each registry on the same npz: the value within
    1e-5 relative and the gradient in sr within 1e-4 of max|ref| of
    jax.value_and_grad, on the two-forward, remat and pair paths."""
    from srgan_st_tpu.core.config import Config as JaxConfig
    from srgan_st_tpu.losses.registry import _build_content_vgg as jax_build
    from srgan_st_tpu_torch.losses.registry import build_one

    spec = {"kind": "content_vgg", "weights": npz, "remat": path == "remat",
            "pair": path == "pair"}
    sr, gt = images
    jax_fn = jax_build(JaxConfig(), dict(spec))
    want, want_grad = jax.value_and_grad(lambda s: jax_fn(s, jnp.asarray(gt)))(jnp.asarray(sr))
    fn = build_one(_config(npz), "ContentVGG", spec)
    srt = torch.from_numpy(sr).requires_grad_()
    got = fn(srt, torch.from_numpy(gt))
    (grad,) = torch.autograd.grad(got, srt)
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * abs(float(want))
    want_grad = np.asarray(want_grad)
    assert np.abs(grad.numpy() - want_grad).max() <= 1e-4 * np.abs(want_grad).max()


def test_pair_gradient_equals_two_forward(npz, images):
    """The frozen pair's hand-written backward against autograd of two
    forwards, with both images requiring grad: the sr gradients within
    1e-5 of max|ref|, and gt gets exactly zero (the frozen-pair contract)."""
    model = pv.VGG19Features(TAPS)
    model.load_state_dict(pv.load_vgg19_npz(npz, TAPS))
    pair = pv.make_vgg19_frozen_pair(model)
    sr, gt = (torch.from_numpy(a) for a in images)
    weights = {"features.17": 1.0, "features.26": 0.5, "features.35": 2.0}

    def loss(fs, fg):
        return sum(w * ((fs[t] - fg[t]) ** 2).mean() for t, w in weights.items())

    s1, g1 = sr.clone().requires_grad_(), gt.clone().requires_grad_()
    ds1, dg1 = torch.autograd.grad(loss(*pair(s1, g1)), (s1, g1))
    s2 = sr.clone().requires_grad_()
    with torch.no_grad():
        fg = model(gt)
    (ds2,) = torch.autograd.grad(loss(model(s2), fg), s2)
    assert torch.equal(dg1, torch.zeros_like(gt))
    assert float((ds1 - ds2).abs().max()) <= 1e-5 * float(ds2.abs().max())
    fs, fg2 = pair(sr, gt)
    for t in TAPS:
        assert torch.allclose(fg2[t], fg[t], atol=1e-5 * float(fg[t].abs().max()))


def test_npz_errors_match_jax(tmp_path, npz):
    """A missing key and a mis-shaped (OIHW instead of HWIO) kernel raise
    the JAX loader's ValueErrors; taps that need only the first block
    read only its convs."""
    from srgan_st_tpu.models import vgg as jv

    with np.load(npz) as data:
        arrs = dict(data)
    missing = tmp_path / "missing.npz"
    np.savez(missing, **{k: v for k, v in arrs.items() if k != "features.10.weight"})
    bad = tmp_path / "bad.npz"
    np.savez(bad, **{**arrs, "features.2.weight": arrs["features.2.weight"].transpose(3, 2, 0, 1)})
    for path, match in ((missing, "is missing features.10.weight"), (bad, "expected HWIO")):
        for load in (pv.load_vgg19_npz, jv.load_vgg19_npz):
            with pytest.raises(ValueError, match=match):
                load(str(path), TAPS)
    assert set(pv.load_vgg19_npz(str(missing), ("features.3",))) == {
        "features.0.weight", "features.0.bias", "features.2.weight", "features.2.bias"}


def test_state_dict_loader_takes_the_golden_stub():
    """The seed-97 VGG19 of the gram-vgg trajectory golden (a torch
    `features.*` state dict, OIHW) loads as it is: the port's taps equal the
    stub's own Sequential at those nodes within 1e-5 of max|ref|; a
    transposed kernel raises."""
    from crosscheck_training_vs_reference import _make_vgg19_stub

    stub = _make_vgg19_stub()()
    model = pv.VGG19Features(TAPS)
    model.load_state_dict(pv.load_vgg19_state_dict(stub.state_dict(), TAPS))
    x = torch.from_numpy(np.random.default_rng(2).random((1, 32, 32, 3), np.float32))
    got = model(x)
    h = x.permute(0, 3, 1, 2)
    with torch.no_grad():
        for i, layer in enumerate(stub.features[:36]):
            h = layer(h)
            if f"features.{i}" in TAPS:
                want = h.permute(0, 2, 3, 1)
                assert float((got[f"features.{i}"] - want).abs().max()) <= 1e-5 * float(want.abs().max())
    sd = dict(stub.state_dict())
    sd["features.0.weight"] = sd["features.0.weight"].permute(2, 3, 1, 0)
    with pytest.raises(ValueError, match="expected OIHW"):
        pv.load_vgg19_state_dict(sd, TAPS)


def test_missing_weights_and_seeded_random_init(tmp_path):
    """A missing file raises FileNotFoundError with the JAX message unless
    spec["allow_random_init"]; then the fresh VGG19 is drawn from a torch
    generator seeded with 0 (a deliberate divergence from jax.random.key(0),
    ROADMAP.md Queue C): two builds have equal weights, lecun-normal in
    scale, frozen, at the compute dtype."""
    from srgan_st_tpu_torch.losses.registry import build_one, content_vgg

    cfg = _config(str(tmp_path / "absent.npz"), "bfloat16")
    with pytest.raises(FileNotFoundError, match="tools/convert_vgg19.py"):
        build_one(cfg, "ContentVGG", {"kind": "content_vgg"})
    a = content_vgg(cfg, {"allow_random_init": True})
    b = content_vgg(cfg, {"allow_random_init": True})
    for (ka, ta), (kb, tb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(ta, tb)
    w = a.features[10].weight
    assert abs(float(w.std()) - (1 / (128 * 9)) ** 0.5) < 0.1 * (1 / (128 * 9)) ** 0.5
    assert a.dtype == torch.bfloat16 and not any(p.requires_grad for p in a.parameters())
    fn = build_one(cfg, "ContentVGG", {"kind": "content_vgg", "allow_random_init": True})
    sr = torch.rand(1, 16, 16, 3, requires_grad=True)
    loss = fn(sr, torch.rand(1, 16, 16, 3))
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert torch.isfinite(torch.autograd.grad(loss, sr)[0]).all()
