"""The port's loss zoo against the JAX package and the stored goldens, on
the CPU.

Seeded numpy inputs go through both packages: the ops (patches, pairwise
distances, structure tensors), the buddy selection's plain version against
the JAX Pallas kernel in interpret mode, each criterion, the
discriminator's feature taps, the registry, the first GAN steps of the
flagship and ST trajectory goldens, and the `run` entry point. Each test
states its tolerance.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
from srgan_st_tpu_torch.kernels import buddy_select as bs
from srgan_st_tpu_torch.kernels._checks import near_tie_agrees
from srgan_st_tpu_torch.losses import functions as T
from tests.test_torch_vgg import write_vgg_npz

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
GOLD = np.load(os.path.join(GOLDENS, "reference_goldens.npz"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _nhwc(x):
    return np.ascontiguousarray(x.transpose(0, 2, 3, 1))


# ---------------------------------------------------------------------------
# ops

@pytest.mark.parametrize("shape,ksize,stride,pad", [
    ((2, 12, 12, 3), 3, 3, 0),   # the non-overlapping reshape path
    ((1, 10, 10, 3), 3, 2, 0),   # the general (unfold) path
    ((2, 9, 11, 3), 3, 3, 1),    # padding, sizes that do not divide
])
def test_extract_patches_matches_jax(rng, shape, ksize, stride, pad):
    """Both paths, exactly (a relayout)."""
    from srgan_st_tpu.ops.patches import extract_patches as jax_patches
    from srgan_st_tpu_torch.ops.patches import extract_patches

    x = rng.random(shape, dtype=np.float32)
    want = np.asarray(jax_patches(jnp.asarray(x), ksize, stride, pad))
    np.testing.assert_array_equal(extract_patches(_t(x), ksize, stride, pad).numpy(), want)


def test_extract_patch_grids_matches_jax(rng):
    from srgan_st_tpu.ops.patches import extract_patch_grids as jax_grids
    from srgan_st_tpu_torch.ops.patches import extract_patch_grids

    x = rng.random((2, 12, 9, 3), dtype=np.float32)
    np.testing.assert_array_equal(extract_patch_grids(_t(x), 3).numpy(),
                                  np.asarray(jax_grids(jnp.asarray(x), 3)))
    with pytest.raises(ValueError, match="divisible"):
        extract_patch_grids(_t(x[:, :10]), 3)


@pytest.mark.parametrize("norm", ["l1", "l2"])
@pytest.mark.parametrize("with_y", [True, False])
def test_pairwise_matches_jax_and_golden(norm, with_y):
    """The stored reference distances at test_ops.py's tolerance (rtol and
    atol 1e-5), and the JAX package's to 1e-5."""
    from srgan_st_tpu.ops.pairwise import batch_pairwise_distance as jax_pd
    from srgan_st_tpu_torch.ops.pairwise import batch_pairwise_distance

    key = f"pairwise_{norm}_{'y' if with_y else 'noy'}"
    x, y = GOLD[key + "_x"], GOLD[key + "_y"] if with_y else None
    got = batch_pairwise_distance(_t(x), _t(y) if with_y else None, norm).numpy()
    np.testing.assert_allclose(got, GOLD[key + "_out"], rtol=1e-5, atol=1e-5)
    want = np.asarray(jax_pd(jnp.asarray(x), jnp.asarray(y) if with_y else None, norm))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if not with_y:
        assert (np.diagonal(got, axis1=1, axis2=2) == 0).all()


@pytest.mark.parametrize("sigma,rho", [(0.5, 2.0), (1.0, 10.0)])
def test_structure_tensor_matches_jax_and_golden(sigma, rho):
    """Whole-image structure tensor: the golden at atol 1e-5
    (test_ops.py:64-68), JAX's to 1e-6."""
    from srgan_st_tpu.ops.structure_tensor import structure_tensor as jax_st
    from srgan_st_tpu_torch.ops.structure_tensor import structure_tensor

    im = GOLD[f"st_in_{sigma}_{rho}"][None]
    got = structure_tensor(_t(im), sigma, rho).numpy()[0]
    np.testing.assert_allclose(got, GOLD[f"st_out_{sigma}_{rho}"], atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax_st(jnp.asarray(im), sigma, rho))[0],
                               atol=1e-6)


def test_structure_tensor_patches_matches_jax_and_golden():
    """The banded-matrix patch path: the golden at atol 1e-5, JAX's to 1e-6."""
    from srgan_st_tpu.ops.structure_tensor import structure_tensor_patches as jax_stp
    from srgan_st_tpu_torch.ops.structure_tensor import structure_tensor_patches

    p = GOLD["st_patches_in"]
    got = structure_tensor_patches(_t(p), sigma=0.5, rho=2.0).numpy()
    np.testing.assert_allclose(got, GOLD["st_patches_out"], atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jax_stp(jnp.asarray(p), 0.5, 2.0)), atol=1e-6)


def test_st_pipeline_matches_jax_and_golden():
    """normalize -> inv(S1) S2 -> eigenvalues -> distance: the goldens at
    test_ops.py:76-88's rtol 2e-5 / atol 1e-6, and the Gaussian taps."""
    import importlib

    J = importlib.import_module("srgan_st_tpu.ops.structure_tensor")
    S = importlib.import_module("srgan_st_tpu_torch.ops.structure_tensor")

    s1, s2 = GOLD["stpipe_s1"], GOLD["stpipe_s2"]
    m = S.inv_s1_x_s2(_t(s1), _t(s2), True)
    lam = S.eigenvalues_2x2(m)
    d = S.riemannian_distance(lam)
    tol = dict(rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(m.numpy(), GOLD["stpipe_m"], **tol)
    np.testing.assert_allclose(lam.numpy(), GOLD["stpipe_lam"].transpose(1, 0, 2), **tol)
    np.testing.assert_allclose(d.numpy(), GOLD["stpipe_d"], **tol)
    np.testing.assert_allclose(S.st_distance(_t(s1), _t(s2)).numpy(),
                               np.asarray(J.st_distance(jnp.asarray(s1), jnp.asarray(s2))),
                               **tol)
    g, dg = S.gaussian_kernel(0.5, also_dg=True)
    np.testing.assert_allclose(g, GOLD["gauss_05"], atol=1e-7)
    np.testing.assert_allclose(dg, GOLD["gauss_05_dg"], atol=1e-6)


def test_color_helpers_match_jax(rng):
    from srgan_st_tpu.ops.color import imagenet_normalize as jn, rgb_to_grayscale as jg
    from srgan_st_tpu_torch.ops.color import imagenet_normalize, rgb_to_grayscale

    x = rng.random((2, 3, 5, 5), dtype=np.float32)
    np.testing.assert_allclose(rgb_to_grayscale(_t(x), channel_axis=1).numpy(),
                               np.asarray(jg(jnp.asarray(x), channel_axis=1)), atol=1e-7)
    xh = _nhwc(x)
    np.testing.assert_allclose(imagenet_normalize(_t(xh)).numpy(),
                               np.asarray(jn(jnp.asarray(xh))), atol=1e-6)


# ---------------------------------------------------------------------------
# the buddy selection (K7's plain version)

def _f64_scores(p1, p2, bank, dist_norm, alpha=1.0, beta=1.0):
    p1, p2, bank = (np.asarray(a, np.float64) for a in (p1, p2, bank))

    def s(p):
        if dist_norm == "l1":
            return np.abs(p[:, :, None] - bank[:, None]).sum(-1)
        return np.clip((p**2).sum(-1)[:, :, None] + (bank**2).sum(-1)[:, None]
                       - 2 * np.einsum("bnd,bmd->bnm", p, bank), 0, None)

    return alpha * s(p1) + beta * s(p2)


def assert_selection_agrees(got, want, scores):
    """Gate (a) of kernels/_checks.py on the numpy f64 ground truth: each
    index equal, or the chosen entry's f64 score within 1e-6 relative of
    the f64 minimum (a near-tie that f32 rounding may split)."""
    ok = near_tie_agrees(_t(got), _t(want), _t(scores)).numpy()
    assert ok.all(), (int((~ok).sum()), np.asarray(got)[~ok], np.asarray(want)[~ok])


def _jax_index(p1, p2, bank, dist_norm, dtype, **kw):
    from srgan_st_tpu.kernels.buddy_select import buddy_select as jax_buddy

    j = [jnp.asarray(a, dtype) for a in (p1, p2, bank)]
    _, idx = jax_buddy(*j, dist_norm=dist_norm, interpret=True, return_index=True, **kw)
    return np.asarray(idx)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("dist_norm", ["l2", "l1"])
@pytest.mark.parametrize("n,m,n_tile,m_tile", [
    (16, 24, None, None),  # one tile
    (16, 24, 8, 8),        # test_kernels.py:31-34's tilings: several merges,
    (17, 23, 8, 8),        # padded final N and M tiles,
    (16, 24, 16, 7),       # M padding only,
    (5, 3, 8, 8),          # one tile larger than the problem
])
def test_buddy_reference_matches_jax_kernel(rng, dtype_name, dist_norm, n, m, n_tile, m_tile):
    """buddy_select_reference against JAX's Pallas kernel in interpret mode
    at every tiling of test_kernels.py:15-48, f32 and bf16 inputs: gate (a)
    of each index against JAX's and the f64 ground truth of the same
    (rounded) inputs; the gathered rows are bank rows bit for bit."""
    dt = jnp.dtype(dtype_name)
    p1, p2, bank = (np.asarray(jnp.asarray(rng.random(s, dtype=np.float32), dt)
                               .astype(jnp.float32))
                    for s in ((2, n, 27), (2, n, 27), (2, m, 27)))
    want = _jax_index(p1, p2, bank, dist_norm, dt, n_tile=n_tile, m_tile=m_tile)
    tt = getattr(torch, dtype_name)
    sel, idx = bs.buddy_select(*(_t(a).to(tt) for a in (p1, p2, bank)),
                               dist_norm=dist_norm, return_index=True)
    assert idx.dtype == torch.int32 and idx.shape == (2, n)
    assert_selection_agrees(idx.numpy(), want, _f64_scores(p1, p2, bank, dist_norm))
    np.testing.assert_array_equal(
        sel.float().numpy(), np.take_along_axis(bank, idx.numpy()[..., None].astype(int), 1))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_buddy_first_occurrence_on_duplicate_heavy_bank(rng, dtype_name):
    """Gate (b): on test_kernels.py:66-102's duplicate-heavy bank (values on
    a 1/255 grid, the second half a copy of the first) the indices equal
    the f64 first-occurrence argmin and JAX's exactly, and never pick the
    later duplicate."""
    b, n, m, d = 2, 40, 70, 27

    def grid(*s):
        return np.round(rng.standard_normal(s) * 32).astype(np.float32) / 255

    p1, p2, bank = grid(b, n, d), grid(b, n, d), grid(b, m, d)
    bank[:, m // 2:] = bank[:, : m - m // 2]
    dt = jnp.dtype(dtype_name)
    p1, p2, bank = (np.asarray(jnp.asarray(a, dt).astype(jnp.float32)) for a in (p1, p2, bank))
    ref = np.argmin(_f64_scores(p1, p2, bank, "l2"), axis=2)
    want = _jax_index(p1, p2, bank, "l2", dt, n_tile=16, m_tile=32)
    tt = getattr(torch, dtype_name)
    idx = bs.buddy_select_index(*(_t(a).to(tt) for a in (p1, p2, bank))).numpy()
    np.testing.assert_array_equal(idx, ref)
    np.testing.assert_array_equal(idx, want)
    assert (idx < m // 2).all()


def test_buddy_cross_tile_ties_and_alpha_beta(rng):
    """test_kernels.py:51-63 (a bank of 3 rows repeated 4 times: every
    argmin a tie) and :105-112 (alpha 0.3, beta 2): the same rows as JAX's
    XLA path (pallas=False), exactly."""
    from srgan_st_tpu.losses.functions import _buddy_select as jax_select

    p1, p2 = rng.random((1, 4, 9), dtype=np.float32), rng.random((1, 4, 9), dtype=np.float32)
    bank = np.tile(rng.random((1, 3, 9), dtype=np.float32), (1, 4, 1))
    for args in ((1.0, 1.0), (0.3, 2.0)):
        want = np.asarray(jax_select(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(bank),
                                     *args, "l2", pallas=False))
        got = T._buddy_select(_t(p1), _t(p2), _t(bank), *args, "l2")
        np.testing.assert_array_equal(got.numpy(), want)


def test_buddy_kernel_not_launched_on_cpu(rng):
    before = bs.launches
    x = _t(rng.random((1, 4, 9), dtype=np.float32))
    bs.buddy_select(x, x, x)
    assert bs.launches == before


# ---------------------------------------------------------------------------
# criteria

def _jax_losses():
    from srgan_st_tpu.losses import functions as J

    return J


@pytest.mark.parametrize("name,gold_key,kwargs,tol", [
    ("best_buddy_loss", "bb_l2_l1", {}, 1e-5),
    ("best_buddy_loss", "bb_l1_mse", {"dist_norm": "l1", "criterion": "mse"}, 1e-5),
    ("gram_loss", "gram", {}, 1e-5),
    ("patchwise_st_loss", "pst", {}, 2e-4),
])
def test_buddy_losses_match_golden_and_jax(name, gold_key, kwargs, tol):
    """Each buddy loss on the stored (sr, gt) pair: the reference's value at
    test_losses.py:53-73's tolerance (2e-4 relative for PatchwiseST, 1e-5
    absolute else), and JAX's f32 XLA path (pallas=False) to the same."""
    sr, gt = _nhwc(GOLD["loss_sr24"]), _nhwc(GOLD["loss_gt24"])
    golden = float(GOLD[gold_key])
    want = float(getattr(_jax_losses(), name)(jnp.asarray(sr), jnp.asarray(gt), pallas=False,
                                               **kwargs))
    for pallas in (None, False):
        got = float(getattr(T, name)(_t(sr), _t(gt), pallas=pallas, **kwargs))
        scale = max(abs(golden), 1.0) if name == "patchwise_st_loss" else 1.0
        assert abs(got - golden) < tol * scale, (got, golden)
        assert abs(got - want) < tol * scale, (got, want)


def test_st_loss_matches_golden_and_jax(rng):
    """Whole-image ST loss: the golden within 1e-4 (test_losses.py:76-81),
    JAX's within 1e-5; near 0 for identical images."""
    sr, gt = _nhwc(GOLD["loss_sr32"]), _nhwc(GOLD["loss_gt32"])
    got = float(T.st_loss(_t(sr), _t(gt)))
    assert abs(got - float(GOLD["st_loss"])) < 1e-4
    assert abs(got - float(_jax_losses().st_loss(jnp.asarray(sr), jnp.asarray(gt)))) < 1e-5
    assert float(T.st_loss(_t(gt), _t(gt))) < 1e-4


@pytest.mark.parametrize("name", ["best_buddy_loss", "gram_loss", "patchwise_st_loss",
                                  "st_loss"])
def test_losses_bf16_match_jax(name, monkeypatch):
    """With dtype="bfloat16" (the bf16 step's loss pipeline) against JAX's
    path with its Pallas selection kernel (interpret mode), which also
    scores bf16 features in f32: within 2e-2 relative (bf16 rounds in other
    places in the two frameworks' structure-tensor pipelines; 1.2%
    measured for PatchwiseST, 1e-7 for the others)."""
    import functools
    import importlib

    kb = importlib.import_module("srgan_st_tpu.kernels.buddy_select")
    monkeypatch.setattr(kb, "buddy_select", functools.partial(kb.buddy_select, interpret=True))
    sr, gt = _nhwc(GOLD["loss_sr24"]), _nhwc(GOLD["loss_gt24"])
    kw = {} if name == "st_loss" else {"pallas": True}
    want = float(getattr(_jax_losses(), name)(jnp.asarray(sr), jnp.asarray(gt),
                                               dtype="bfloat16", **kw))
    got = float(getattr(T, name)(_t(sr), _t(gt), dtype="bfloat16"))
    assert abs(got - want) <= 2e-2 * abs(want), (got, want)


def test_loss_gradients_reach_sr(rng):
    """The buddy and ST criteria are differentiable in sr (the selection
    carries none) and give the gradients of the plain composition."""
    sr = _t(rng.random((1, 24, 24, 3), dtype=np.float32)).requires_grad_()
    gt = _t(rng.random((1, 24, 24, 3), dtype=np.float32))
    for fn in (T.patchwise_st_loss, T.st_loss, T.best_buddy_loss, T.gram_loss):
        (g,) = torch.autograd.grad(fn(sr, gt), sr)
        assert torch.isfinite(g).all() and float(g.abs().max()) > 0


# ---------------------------------------------------------------------------
# discriminator taps and ContentDiscriminator

def _jax_d(channels, seed=0):
    from srgan_st_tpu.models.discriminator import Discriminator as JaxD

    d = JaxD(channels=channels)
    v = d.init(jax.random.key(seed), jnp.zeros((1, 96, 96, 3)), train=False)
    v = jax.tree_util.tree_map(np.asarray, jax.device_get(v))
    r = np.random.default_rng(seed)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (a + r.uniform(0.1, 0.5, a.shape)).astype(np.float32), v["batch_stats"])
    return d, v


def _port_d(v, channels):
    from srgan_st_tpu_torch.models.discriminator import Discriminator
    from srgan_st_tpu_torch.train.checkpoint import discriminator_state_dict_from_variables

    d = Discriminator(channels=channels)
    d.load_state_dict(discriminator_state_dict_from_variables(v))
    return d


@pytest.mark.parametrize("taps", [("features.4", "features.10"), ("features.1",),
                                  ("features.22",)])
def test_discriminator_taps_match_jax(rng, taps):
    """D's tap activations (eval mode) against the JAX D's `taps` output,
    NHWC, the same keys, atol 1e-5."""
    jd, v = _jax_d(8)
    x = rng.random((2, 96, 96, 3), dtype=np.float32)
    want = jd.apply(v, jnp.asarray(x), train=False, taps=taps)
    got = _port_d(v, 8)(_t(x), train=False, taps=taps)
    assert set(got) == set(want) == set(taps)
    for k in taps:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), atol=1e-5)


@pytest.mark.parametrize("fmt", ["jax", "torch"])
def test_content_disc_matches_jax(rng, tmp_path, fmt):
    """ContentDiscriminator built from the config with D weights in an npz:
    the JAX package's variables, or the reference's state-dict keys (as the
    flagship golden ships its `cd0/*`). Against JAX's content_disc on the
    same weights within 1e-5 relative (f32 convs summed in another order;
    1.1e-6 measured); 0 for identical images."""
    from srgan_st_tpu.core.config import Config as JaxConfig
    from srgan_st_tpu.losses.registry import build_criterions as jax_build
    from srgan_st_tpu.train.checkpoint import save_variables_npz as jax_save
    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.losses.registry import build_criterions

    _, v = _jax_d(8, seed=1)
    path = str(tmp_path / "cd.npz")
    jpath = str(tmp_path / "cd_jax.npz")
    jax_save(jpath, v)
    if fmt == "torch":
        np.savez(path, **{k: t.numpy() for k, t in _port_d(v, 8).state_dict().items()})
    else:
        path = jpath
    cfgs = JaxConfig(), Config()
    for c, p in zip(cfgs, (jpath, path)):
        c.MODEL.D_N_CHANNEL = 8
        c.MODEL.G_LOSS.DISC_FEATURES_WEIGHTS = p
        c.MODEL.G_LOSS.CRITERIONS = {"ContentDiscriminator": {"kind": "content_disc"}}
    jfn, jw = jax_build(cfgs[0])["ContentDiscriminator"]
    fn, w = build_criterions(cfgs[1])["ContentDiscriminator"]
    assert w == jw == 2000.0
    sr, gt = rng.random((2, 96, 96, 3), dtype=np.float32), rng.random((2, 96, 96, 3), dtype=np.float32)
    want = float(jfn(jnp.asarray(sr), jnp.asarray(gt)))
    got = fn(_t(sr), _t(gt))
    assert abs(float(got) - want) <= 1e-5 * abs(want)
    assert float(fn(_t(gt), _t(gt))) == 0.0


def test_content_disc_fresh_d_is_seeded():
    """Without weights the content D is a fresh D from a torch generator
    seeded with 0: two builds give the same loss, in eval mode, frozen."""
    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.losses.registry import content_discriminator

    cfg = Config()
    cfg.MODEL.D_N_CHANNEL = 4
    a, b = content_discriminator(cfg, {}), content_discriminator(cfg, {})
    for (ka, ta), (kb, tb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(ta, tb)
    assert not a.training and not any(p.requires_grad for p in a.parameters())


# ---------------------------------------------------------------------------
# the registry and the experiment configs

def test_registry_builds_every_kind_but_content_vgg(tmp_path):
    """Every kind of the JAX registry builds, with the same weights and the
    step's compute dtype in the spec; content_vgg, the last kind ported,
    builds from its VGG19 npz and raises FileNotFoundError without one."""
    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.losses.registry import build_criterions

    cfg = Config()
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.MODEL.D_N_CHANNEL = 4
    for name in ("Pixel", "BestBuddy", "Gram", "PatchwiseST", "ST", "ContentDiscriminator"):
        cfg.add_g_criterion(name, {},
                            cfg.MODEL.G_LOSS.CRITERION_WEIGHTS[name])
    crits = build_criterions(cfg)
    assert crits["Adversarial"] == (None, 0.001)
    assert crits["PatchwiseST"][1] == 100.0 and crits["ContentDiscriminator"][1] == 2000.0
    assert crits["PatchwiseST"][0].keywords["dtype"] == "bfloat16"
    cfg.remove_g_criterion("ST")
    assert "ST" not in cfg.MODEL.G_LOSS.CRITERIONS
    cfg.add_g_criterion("ContentVGG", {"kind": "content_vgg"})
    cfg.MODEL.G_LOSS.VGG19_WEIGHTS = str(tmp_path / "absent.npz")
    with pytest.raises(FileNotFoundError, match="VGG19 weights not found"):
        build_criterions(cfg)
    cfg.MODEL.G_LOSS.VGG19_WEIGHTS = write_vgg_npz(tmp_path / "vgg19.npz")
    crits = build_criterions(cfg)
    assert crits["ContentVGG"][1] == 1.0
    assert crits["ContentVGG"][0].keywords["layer_weights"] == dict(
        cfg.MODEL.G_LOSS.VGG19_LAYERS)


@pytest.mark.parametrize("job", range(5))
def test_st_experiment_matches_jax(job, monkeypatch):
    """st_experiment gives every job the JAX package's name, criteria and
    weights; get_jobindex reads the scheduler's variable."""
    from srgan_st_tpu.core.config import Config as JaxConfig
    from srgan_st_tpu.main import st_experiment as jax_exp
    from srgan_st_tpu_torch.core.config import Config, get_jobindex
    from srgan_st_tpu_torch.main import st_experiment

    want, got = jax_exp(JaxConfig(), job), st_experiment(Config(), job)
    assert got.EXP.NAME == want.EXP.NAME
    assert got.MODEL.G_LOSS.CRITERIONS == want.MODEL.G_LOSS.CRITERIONS
    assert got.MODEL.G_LOSS.CRITERION_WEIGHTS == want.MODEL.G_LOSS.CRITERION_WEIGHTS
    monkeypatch.setenv("job_index", str(job))
    assert get_jobindex() == job


# ---------------------------------------------------------------------------
# the trajectory goldens' first GAN steps

def _unpack(data, part):
    return {k[len(part) + 1:]: torch.from_numpy(np.asarray(data[k]))
            for k in data.files if k.startswith(part + "/")}


@pytest.mark.parametrize("golden,criteria", [
    ("training_trajectory_flagship.npz", {"PatchwiseST": {"kind": "patchwise_st"},
                                          "ContentDiscriminator": {"kind": "content_disc"}}),
    ("training_trajectory.npz", {"ST": {"kind": "st"}}),
])
def test_gan_golden_first_steps(tmp_path, golden, criteria):
    """The first 5 GAN steps of the executed reference loop (torch CPU),
    from the golden's post-warmup G (`g_warm`), D (`d0`) and, for the
    flagship, frozen content D (`cd0`), all in reference state-dict keys,
    through the port's g_step / d_step on the golden's feed and schedule:
    G losses within 2e-3 and D losses within 5e-3 relative, the golden
    test's head tolerances (test_trajectory.py:124-128)."""
    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.losses.registry import build_criterions
    from srgan_st_tpu_torch.models.discriminator import Discriminator
    from srgan_st_tpu_torch.models.generator import Generator
    from srgan_st_tpu_torch.train.steps import (
        GANTrainState, make_d_optimizer, make_g_optimizer, make_gan_steps,
    )

    data = np.load(os.path.join(GOLDENS, golden))
    _, gan_n, batch, spe, d_int, milestone = (int(v) for v in data["meta"])
    cfg = Config()
    cfg.DATA.BATCH_SIZE = batch
    cfg.SCHEDULER.MILESTONES = [milestone]
    cfg.SOLVER.D_UPDATE_INTERVAL = d_int
    cfg.MODEL.G_N_RCB, cfg.MODEL.G_N_CHANNEL, cfg.MODEL.D_N_CHANNEL = 2, 16, 4
    cfg.MODEL.G_LOSS.CRITERIONS = {"Adversarial": {"kind": "adversarial"},
                                   "Pixel": {"kind": "pixel", "criterion": "mse"},
                                   **criteria}
    if "cd0/features.0.weight" in data.files:
        path = str(tmp_path / "cd0.npz")
        np.savez(path, **{k: t.numpy() for k, t in _unpack(data, "cd0").items()})
        cfg.MODEL.G_LOSS.DISC_FEATURES_WEIGHTS = path
    g, d = Generator.from_config(cfg), Discriminator.from_config(cfg)
    g.load_state_dict(_unpack(data, "g_warm"))
    d.load_state_dict(_unpack(data, "d0"))
    state = GANTrainState(g_model=g, g_opt=make_g_optimizer(cfg, g.parameters(), spe),
                          d_model=d, d_opt=make_d_optimizer(cfg, d.parameters(), spe))
    g_step, d_step = make_gan_steps(cfg, build_criterions(cfg))
    feed = np.random.default_rng(5678).integers(0, 256, (gan_n, batch, 96, 96, 3),
                                                dtype=np.uint8)
    for step in range(5):
        state, sr, m = g_step(state, feed[step])
        want = float(data["gan_g_losses"][step])
        assert abs(float(m["G_Loss"]) - want) <= 2e-3 * abs(want), (step, float(m["G_Loss"]), want)
        if (step % spe) % d_int == 0:
            state, dm = d_step(state, feed[step], sr)
            want = float(data["gan_d_losses"][step])
            assert abs(float(dm["D_Loss"]) - want) <= 5e-3 * abs(want), (step, want)


# ---------------------------------------------------------------------------
# the run entry point

@pytest.mark.parametrize("job", [1, 3, 4, 0, 2])
def test_run_command_on_cpu(tmp_path, monkeypatch, capsys, job):
    """`run --job_index j` at tiny width on the CPU: every job trains, then
    tests on the synthetic pairs and writes the experiment's checkpoints,
    images and metrics: 1 (PatchwiseST + ContentDiscriminator), 3 (ST +
    ContentDiscriminator), 4 (the pixel baseline), and 0 and 2 (ContentVGG)
    on a seeded VGG19 npz."""
    from srgan_st_tpu_torch.main import VARIANTS

    from srgan_st_tpu_torch.__main__ import main

    monkeypatch.chdir(tmp_path)
    argv = ["run", "--job_index", str(job), "--device", "cpu"]
    for s in ("DATA.SYNTHETIC=true", "DATA.SYNTHETIC_N_BATCHES=2", "DATA.BATCH_SIZE=2",
              "MODEL.G_N_RCB=1", "MODEL.G_N_CHANNEL=8", "MODEL.D_N_CHANNEL=4",
              "SOLVER.D_UPDATE_INTERVAL=2", "EXP.N_EPOCHS=1"):
        argv += ["--set", s]
    name = VARIANTS[job][0]
    if job in (0, 2):
        argv += ["--set", f"MODEL.G_LOSS.VGG19_WEIGHTS={write_vgg_npz(tmp_path / 'vgg19.npz')}"]
    main(argv)
    out = capsys.readouterr().out
    assert f"Running job: {job}" in out and f"Finished job: {job}" in out and "[Test]" in out
    files = set(os.listdir(tmp_path / "results" / name))
    assert {"g_last.npz", "d_last.npz", "g_best.npz"} <= files
    shots = set(os.listdir(tmp_path / "results" / "_test" / name))
    assert {"0.png", "_metrics.txt"} <= shots
