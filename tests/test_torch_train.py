"""The port's training slice against the JAX package, on the CPU.

Seeded numpy inputs go through both packages; the port's kernel wrappers
take their plain versions on CPU tensors, and the JAX package runs its
Pallas trunk kernels (K4/K5) in interpret mode. Each test states its
tolerance. The JAX Generator takes its packed trunk only on one device
(generator.py:180-181), while tests/conftest.py gives the JAX package
eight CPU devices: the tests that hold the port against JAX's packed
Generator pin `jax.device_count` to 1 for that call.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
from srgan_st_tpu_torch.kernels import packed_trunk as pt

LR = 1e-4  # the default G and D learning rate


def _trunk_args(rng, n, c):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(n, 3, 3, c, c) * 0.05, f(n, 3, 3, c, c) * 0.05, 1 + 0.1 * f(n, c),
            0.1 * f(n, c), 1 + 0.1 * f(n, c), 0.1 * f(n, c), 0.25 + 0.01 * f(n))


@functools.lru_cache(maxsize=None)
def _trunk_case(shape, n, dtype_name):
    """Seeded inputs and JAX packed_trunk (interpret mode) outputs: y,
    stats and the 8 gradients of sum(y^2), for x in `dtype_name` and, on
    the same (rounded) inputs, in f32."""
    from srgan_st_tpu.kernels.packed_trunk import packed_trunk as jax_trunk

    rng = np.random.default_rng(0)
    args = _trunk_args(rng, n, shape[-1])
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype_name == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))

    def run(dt):
        xj = jnp.asarray(x, dt)
        ja = tuple(jnp.asarray(a) for a in args)
        y, st = jax_trunk(xj, *ja, 1e-5, True)
        grads = jax.grad(
            lambda *a: jnp.sum(jax_trunk(*a, 1e-5, True)[0].astype(jnp.float32) ** 2),
            argnums=tuple(range(8)))(xj, *ja)
        return [np.asarray(t, np.float32) for t in (y, st, *grads)]

    ref = run(jnp.dtype(dtype_name))
    ref32 = run(jnp.float32) if dtype_name == "bfloat16" else ref
    return x, args, ref, ref32


def _port_trunk(fn, x, args, dtype):
    xt = torch.tensor(x, dtype=dtype, requires_grad=True)
    at = [torch.from_numpy(a).requires_grad_() for a in args]
    y, st = fn(xt, *at)
    (y.float() ** 2).sum().backward()
    return [t.detach().float().numpy() for t in (y, st, xt.grad, *(a.grad for a in at))]


TRUNKS = {"packed": pt.packed_trunk, "reference": pt.packed_trunk_reference,
          "hybrid": pt.hybrid_trunk}


@pytest.mark.parametrize("name", list(TRUNKS))
def test_trunk_f32_matches_jax(name):
    """(2, 8, 8, 32), n = 2, f32: y and stats within atol 1e-5 of JAX's
    packed_trunk in interpret mode, and all 8 gradients of sum(y^2) within
    1e-4 of max|ref| (the bounds of test_kernels.py:363-387)."""
    x, args, ref, _ = _trunk_case((2, 8, 8, 32), 2, "float32")
    got = _port_trunk(TRUNKS[name], x, args, torch.float32)
    np.testing.assert_allclose(got[0], ref[0], atol=1e-5)
    np.testing.assert_allclose(got[1], ref[1], atol=1e-5)
    for g, r in zip(got[2:], ref[2:]):
        assert g.shape == r.shape
        assert np.abs(g - r).max() / (np.abs(r).max() + 1e-9) < 1e-4


@pytest.mark.parametrize("name", list(TRUNKS))
def test_trunk_bf16_within_envelope(name):
    """(2, 8, 8, 64), n = 2, bf16: y, stats and every gradient within 2x
    JAX's own bf16-vs-f32 envelope on the same inputs."""
    x, args, ref16, ref32 = _trunk_case((2, 8, 8, 64), 2, "bfloat16")
    got = _port_trunk(TRUNKS[name], x, args, torch.bfloat16)
    for i, (g, r16, r32) in enumerate(zip(got, ref16, ref32)):
        env = np.abs(r16 - r32).max()
        assert 0 < env, i
        assert np.abs(g - r32).max() <= 2 * env, (i, np.abs(g - r32).max(), env)


def test_trunk_odd_width_raises():
    """The even-W gate of the JAX package's packed_trunk (:450-451)."""
    args = [torch.from_numpy(a) for a in _trunk_args(np.random.default_rng(1), 1, 32)]
    y, _ = pt.packed_trunk(torch.zeros(1, 4, 6, 32), *args)
    assert y.shape == (1, 4, 6, 32)
    with pytest.raises(ValueError, match="even"):
        pt.packed_trunk(torch.zeros(1, 4, 7, 32), *args)


def test_trunk_kernels_not_launched_on_cpu():
    before = (pt.fwd_launches, pt.bwd_launches)
    _port_trunk(pt.packed_trunk, *_trunk_case((2, 8, 8, 32), 2, "float32")[:2],
                torch.float32)
    assert (pt.fwd_launches, pt.bwd_launches) == before


# ---------------------------------------------------------------------------
# models

def _single_device(monkeypatch):
    monkeypatch.setattr(jax, "device_count", lambda *a, **k: 1)


@pytest.mark.parametrize("dtype_name,mode,out_atol,stat_atol", [
    ("bfloat16", "packed", 0.06, 2e-2),   # test_kernels.py:401-428's bounds
    ("bfloat16", "hybrid", 0.06, 2e-2),
    ("float32", "unfused", 1e-5, 1e-5),
])
def test_generator_train_matches_jax(monkeypatch, dtype_name, mode, out_atol, stat_atol):
    """Train-mode forward of a 64-channel, 2-RCB generator against the JAX
    Generator (trunk "packed_interpret" for the kernel modes, on one
    device): output, batch-stat EMA, and the same variable tree."""
    from srgan_st_tpu.models.generator import Generator as JaxGenerator
    from srgan_st_tpu_torch.models.generator import Generator, random_variables
    from srgan_st_tpu_torch.train.checkpoint import (
        generator_state_dict_from_variables,
        variables_from_generator_state_dict,
    )

    _single_device(monkeypatch)
    variables = random_variables(0, channels=64, num_rcb=2)
    lr = np.random.default_rng(1).random((2, 8, 10, 3), np.float32)
    jax_mode = "unfused" if mode == "unfused" else "packed_interpret"
    jg = JaxGenerator(channels=64, num_rcb=2, dtype=jnp.dtype(dtype_name),
                      trunk_mode=jax_mode)
    want, mut = jg.apply(variables, jnp.asarray(lr), train=True, mutable=["batch_stats"])
    g = Generator(channels=64, num_rcb=2, dtype=getattr(torch, dtype_name),
                  trunk_mode=mode)
    g.load_state_dict(generator_state_dict_from_variables(variables))
    got = g(torch.from_numpy(lr), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=out_atol)
    stats = variables_from_generator_state_dict(g.state_dict())["batch_stats"]
    want_stats = jax.device_get(mut["batch_stats"])
    assert jax.tree_util.tree_structure(stats) == jax.tree_util.tree_structure(want_stats)
    for a, b in zip(jax.tree_util.tree_leaves(stats), jax.tree_util.tree_leaves(want_stats)):
        np.testing.assert_allclose(a, np.asarray(b), atol=stat_atol)


def test_packed_gate_falls_back(monkeypatch):
    """trunk_mode="packed" outside the gate (f32; or eval) runs the unfused
    blocks, bit-identical to them, and calls no trunk kernel wrapper."""
    from srgan_st_tpu_torch.models.generator import Generator, random_variables
    from srgan_st_tpu_torch.train.checkpoint import generator_state_dict_from_variables

    calls = []
    monkeypatch.setattr(pt, "packed_trunk", lambda *a: calls.append(1))
    sd = generator_state_dict_from_variables(random_variables(2, channels=64, num_rcb=1))
    lr = torch.rand(2, 8, 8, 3, generator=torch.Generator().manual_seed(0))
    outs = []
    for mode in ("unfused", "packed"):
        g = Generator(channels=64, num_rcb=1, trunk_mode=mode)
        g.load_state_dict(sd)
        outs.append(g(lr, train=True))
        g16 = Generator(channels=64, num_rcb=1, dtype=torch.bfloat16, trunk_mode=mode)
        g16.load_state_dict(sd)
        outs.append(g16(lr, train=False))
    assert calls == []
    assert torch.equal(outs[0], outs[2]) and torch.equal(outs[1], outs[3])


def test_auto_trunk_is_packed_in_bf16_training(monkeypatch):
    """TRUNK_MODE None in a bf16 train step runs the K4/K5 trunk inside its
    gate (C a multiple of 64, even W): the JAX package's auto there is
    "xpack", a TPU lane packing of the same function, and paired on the
    H100 a packed GAN step took 0.52 (Adversarial) and 0.70 (run job 0) of
    an unfused one (ROADMAP.md Queue C). Outside the gate, in f32 training
    and in eval, the unfused blocks run."""
    from srgan_st_tpu_torch.models.generator import Generator

    calls = []
    real = pt.packed_trunk
    monkeypatch.setattr(pt, "packed_trunk", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(pt, "hybrid_trunk", lambda *a: calls.append("hybrid"))
    g = Generator(channels=64, num_rcb=1, dtype=torch.bfloat16)
    out = g(torch.rand(2, 8, 8, 3), train=True)
    assert calls == [1] and out.shape == (2, 32, 32, 3)
    g.eval()(torch.rand(1, 8, 8, 3))
    Generator(channels=64, num_rcb=1)(torch.rand(2, 8, 8, 3), train=True)
    Generator(channels=16, num_rcb=1, dtype=torch.bfloat16)(torch.rand(2, 8, 8, 3), train=True)
    assert calls == [1]


def test_packed_gate_has_no_vmem_cap():
    """The JAX gate's VMEM cap (generator.py:185-189: 8 activation blocks
    within 96 MB) is a TPU budget: a batch-64 96x96 trunk input, beyond
    it, stays in the port's gate (ROADMAP.md Queue C)."""
    from srgan_st_tpu_torch.models.generator import Generator

    b, h, w, c = 64, 96, 96, 64
    wp = -(-(w // 2 + 1) // 16) * 16
    assert 8 * b * (h + 2) * wp * 2 * c * 2 > 96 * 1024 * 1024  # over the JAX cap
    g = Generator(channels=c, num_rcb=1, dtype=torch.bfloat16, trunk_mode="packed")
    assert g._packed_ok(torch.empty(b, h, w, c, dtype=torch.bfloat16, device="meta"))
    assert not g._packed_ok(torch.empty(b, h, w + 1, c, dtype=torch.bfloat16, device="meta"))
    assert not g._packed_ok(torch.empty(b, h, w, c, device="meta"))


def test_parameter_counts():
    """The default config's models (reference model.py:193-194)."""
    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.models.discriminator import Discriminator
    from srgan_st_tpu_torch.models.generator import Generator

    cfg = Config()
    count = lambda m: sum(p.numel() for p in m.parameters())  # noqa: E731
    assert count(Generator.from_config(cfg)) == 1_547_350
    assert count(Discriminator.from_config(cfg)) == 23_563_649
    assert all(p.dtype == torch.float32 for p in Generator(dtype=torch.bfloat16).parameters())


def _jax_d_variables(channels, seed=0):
    from srgan_st_tpu.models.discriminator import Discriminator as JaxD

    v = JaxD(channels=channels).init(jax.random.key(seed), jnp.zeros((1, 96, 96, 3)),
                                     train=False)
    v = jax.tree_util.tree_map(np.asarray, jax.device_get(v))
    rng = np.random.default_rng(seed)
    v["batch_stats"] = jax.tree_util.tree_map(
        lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32), v["batch_stats"])
    return v


def test_discriminator_train_matches_jax():
    """JAX D variables carried across give the same train-mode logits and
    the same updated running statistics: f32, atol 1e-5."""
    from srgan_st_tpu.models.discriminator import Discriminator as JaxD
    from srgan_st_tpu_torch.models.discriminator import Discriminator
    from srgan_st_tpu_torch.train.checkpoint import (
        discriminator_state_dict_from_variables,
        variables_from_discriminator_state_dict,
    )

    v = _jax_d_variables(8)
    x = np.random.default_rng(2).random((3, 96, 96, 3), np.float32)
    want, mut = JaxD(channels=8).apply(v, jnp.asarray(x), train=True,
                                       mutable=["batch_stats"])
    d = Discriminator(channels=8)
    d.load_state_dict(discriminator_state_dict_from_variables(v))
    got = d(torch.from_numpy(x), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    stats = variables_from_discriminator_state_dict(d.state_dict())["batch_stats"]
    for a, b in zip(jax.tree_util.tree_leaves(stats),
                    jax.tree_util.tree_leaves(jax.device_get(mut["batch_stats"]))):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)


def test_discriminator_round_trip_is_exact():
    """JAX D variables -> port state_dict -> JAX variables is the identity
    (the fc1 row permutation included), with no key left over."""
    from srgan_st_tpu_torch.models.discriminator import Discriminator
    from srgan_st_tpu_torch.train.checkpoint import (
        discriminator_state_dict_from_variables,
        variables_from_discriminator_state_dict,
    )

    v = _jax_d_variables(4, seed=3)
    sd = discriminator_state_dict_from_variables(v)
    d = Discriminator(channels=4)
    assert set(d.state_dict()) == set(sd)
    d.load_state_dict(sd)
    back = variables_from_discriminator_state_dict(d.state_dict())
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(v)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(v)):
        np.testing.assert_array_equal(a, b)


def test_discriminator_flatten_matches_reference_torch_model():
    """The port's D is the reference's torch module: same state_dict keys,
    same logits (its (C, H, W) flatten included); atol 1e-5."""
    from srgan_st_tpu_torch.models.discriminator import Discriminator
    from tests.reference_impls import TorchSRGANDiscriminator

    ref = TorchSRGANDiscriminator(channels=4).eval()
    d = Discriminator(channels=4)
    d.load_state_dict(ref.state_dict())
    x = torch.rand(2, 96, 96, 3, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        want = ref(x.permute(0, 3, 1, 2))
        got = d(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_degradation_matches_jax():
    """resize_bicubic (MATLAB, x1/4, quantized) on a uint8 batch: the same
    quantized LR as the JAX package's, bit for bit."""
    from srgan_st_tpu.ops.resize import resize_bicubic as jax_resize
    from srgan_st_tpu_torch.ops.resize import resize_bicubic

    gt = np.random.default_rng(5).integers(0, 256, (4, 96, 96, 3)).astype(np.float32) / 255
    want = np.asarray(jax_resize(jnp.asarray(gt), 0.25))
    got = resize_bicubic(torch.from_numpy(gt), 0.25).numpy()
    assert got.shape == (4, 24, 24, 3)
    np.testing.assert_array_equal(got, want)


def test_pre_shuffled_kernel_path_is_differentiable():
    """The coarse conv kernel's path (autograd Function) gives conv3 and
    its input the gradients of the plain composition."""
    from srgan_st_tpu_torch.ops.subpixel_conv import conv2d_subpixel_pre_shuffled

    rng = np.random.default_rng(6)
    grads = []
    for inner in (None, 1):
        y = torch.from_numpy(rng.random((2, 8, 10, 16), np.float32)).requires_grad_()
        w = torch.from_numpy(rng.random((9, 9, 4, 3), np.float32) - 0.5).requires_grad_()
        b = torch.zeros(3, requires_grad=True)
        out = conv2d_subpixel_pre_shuffled(y, w, b, factor=2, inner_factor=inner)
        (out ** 2).sum().backward()
        grads.append([t.grad for t in (y, w, b)])
        rng = np.random.default_rng(6)
    for a, b in zip(*grads):
        assert float(a.abs().max()) > 0
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-5)


def test_kernel_weights_follow_the_parameter_version():
    """The coarse conv layout of conv3's weight is made once per parameter
    version: the same tensor while the weight is unchanged, a new one
    after an in-place update."""
    from srgan_st_tpu_torch.kernels.coarse_conv import KernelWeights

    w = torch.nn.Parameter(torch.randn(3, 64, 9, 9))
    cache = KernelWeights()
    first = cache.get(w, torch.float32)
    assert cache.get(w, torch.float32) is first
    with torch.no_grad():
        w.add_(1.0)
    second = cache.get(w, torch.float32)
    assert second is not first and not torch.equal(second, first)


# ---------------------------------------------------------------------------
# steps

def _small_config(dtype="float32", trunk="unfused", channels=16, batch=4, gt=32):
    from srgan_st_tpu.core.config import Config as JaxConfig
    from srgan_st_tpu_torch.core.config import Config

    cfgs = JaxConfig(), Config()
    for c in cfgs:
        c.DATA.BATCH_SIZE = batch
        c.DATA.GT_IMAGE_SIZE = gt
        c.MODEL.G_N_RCB = 2
        c.MODEL.G_N_CHANNEL = channels
        c.MODEL.D_N_CHANNEL = 4
        c.TPU.COMPUTE_DTYPE = dtype
        c.TPU.TRUNK_MODE = trunk
        c.SOLVER.D_UPDATE_INTERVAL = 2
    cfgs[0].TPU.TRUNK_MODE = "packed_interpret" if trunk == "packed" else trunk
    return cfgs


def _batches(n, batch, size, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (n, batch, size, size, 3), np.uint8)


def _port_g_state(cfg, g_vars, spe=10, milestones=False):
    from srgan_st_tpu_torch.models.generator import Generator
    from srgan_st_tpu_torch.train.checkpoint import generator_state_dict_from_variables
    from srgan_st_tpu_torch.train.steps import GANTrainState, make_g_optimizer

    g = Generator.from_config(cfg)
    g.load_state_dict(generator_state_dict_from_variables(g_vars))
    return GANTrainState(g_model=g, g_opt=make_g_optimizer(cfg, g.parameters(), spe,
                                                           milestones))


def _run_warmup(jcfg, cfg, n_steps):
    """n warmup steps through both packages from the JAX package's init."""
    from srgan_st_tpu.losses.registry import build_warmup_criterions as jax_crits
    from srgan_st_tpu.models.generator import Generator as JaxGenerator
    from srgan_st_tpu.train import steps as S
    from srgan_st_tpu_torch.losses.registry import build_warmup_criterions
    from srgan_st_tpu_torch.train.checkpoint import variables_from_generator_state_dict
    from srgan_st_tpu_torch.train.steps import make_warmup_step

    jg = JaxGenerator.from_config(jcfg)
    g_tx = S.make_g_optimizer(jcfg, 10, milestones=False)
    jstate = S.create_generator_state(jcfg, jg, g_tx)
    g_vars = jax.device_get({"params": jstate.g_params, "batch_stats": jstate.g_stats})
    state = _port_g_state(cfg, g_vars)
    jstep = jax.jit(S.make_warmup_step(jcfg, jg, jax_crits(jcfg), g_tx))
    step = make_warmup_step(cfg, build_warmup_criterions(cfg))
    losses = []
    for gt in _batches(n_steps, cfg.DATA.BATCH_SIZE, cfg.DATA.GT_IMAGE_SIZE):
        jstate, jm = jstep(jstate, jnp.asarray(gt))
        state, m = step(state, gt)
        losses.append((float(m["G_Loss"]), float(jm["G_Loss"])))
    want = jax.device_get({"params": jstate.g_params, "batch_stats": jstate.g_stats})
    got = variables_from_generator_state_dict(state.g_model.state_dict())
    return g_vars, losses, got, want


def _assert_trees_close(got, want, **tol):
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a, np.asarray(b), **tol)


def test_warmup_steps_f32_match_jax():
    """Two f32 warmup steps from the same state: losses within 1e-5,
    parameters and running statistics within atol 5e-5 / rtol 1e-4
    (test_kernels.py:464-474's bounds)."""
    _, losses, got, want = _run_warmup(*_small_config(), 2)
    for a, b in losses:
        assert abs(a - b) < 1e-5
    _assert_trees_close(got, want, atol=5e-5, rtol=1e-4)


def test_warmup_steps_bf16_packed_match_jax(monkeypatch):
    """Two bf16 warmup steps of a 64-channel generator, the port's
    "packed" trunk against JAX's "packed_interpret" (one device). Bounds:
    losses within 1e-2 relative (bf16 rounds in other places in the two
    frameworks); an Adam update moves a weight by at most ~1.2 lr (its
    bias-corrected second update), in opposite directions where a small
    bf16 gradient differs in sign between the frameworks, so after two
    updates the parameters agree within 4 lr (2.6 lr measured); running
    statistics within JAX's own bf16 EMA bound, 2e-2."""
    _single_device(monkeypatch)
    _, losses, got, want = _run_warmup(*_small_config("bfloat16", "packed", 64, 2), 2)
    for a, b in losses:
        assert abs(a - b) <= 1e-2 * abs(b)
    _assert_trees_close(got["params"], want["params"], atol=4 * LR)
    _assert_trees_close(got["batch_stats"], want["batch_stats"], atol=2e-2)


def test_bf16_step_keeps_f32_parameter_updates():
    """The f32-parameter repair: one bf16 warmup step updates the float32
    parameters by the JAX step's amounts, including the updates too small
    for bf16 to hold (more than a third of them here), which a bf16
    parameter drops (the port held bf16 parameters before: its update on
    those would be 0, at least lr/2 away from JAX's). Bound: within lr/4 of
    JAX's update for 85% of all weights and 90% of those bf16 cannot hold
    (89.7% and 94.7% measured); the rest are weights whose bf16 gradient is
    rounding noise, whose Adam update can take either sign in either
    framework."""
    g_vars, _, got, want = _run_warmup(*_small_config("bfloat16"), 1)
    flat = lambda t: np.concatenate(  # noqa: E731
        [np.ravel(a) for a in jax.tree_util.tree_leaves(t["params"])])
    p0, p_port, p_jax = flat(g_vars), flat(got), flat(want)
    d_jax, d_port = p_jax - p0, p_port - p0
    bf16 = lambda a: torch.from_numpy(a).bfloat16().float().numpy()  # noqa: E731
    lost_in_bf16 = (np.abs(d_jax) > LR / 2) & (bf16(p0 + d_jax) == bf16(p0))
    assert lost_in_bf16.mean() > 1 / 3
    agree = np.abs(d_port - d_jax) <= LR / 4
    assert agree.mean() >= 0.85
    assert agree[lost_in_bf16].mean() >= 0.9


def test_gan_steps_f32_match_jax():
    """Two f32 G steps (Adversarial + Pixel) with one D update between them,
    from the same state: G and D losses within 1e-5, G and D parameters and
    running statistics within atol 5e-5 / rtol 1e-4. D's statistics move in
    the G step (its train-mode forward), and D's parameters only in the D
    step."""
    from srgan_st_tpu.losses.registry import build_criterions as jax_crits
    from srgan_st_tpu.models.discriminator import Discriminator as JaxD
    from srgan_st_tpu.models.generator import Generator as JaxGenerator
    from srgan_st_tpu.train import steps as S
    from srgan_st_tpu_torch.losses.registry import build_criterions
    from srgan_st_tpu_torch.models.discriminator import Discriminator
    from srgan_st_tpu_torch.train.checkpoint import (
        discriminator_state_dict_from_variables,
        variables_from_discriminator_state_dict,
        variables_from_generator_state_dict,
    )
    from srgan_st_tpu_torch.train.steps import make_d_optimizer, make_gan_steps

    jcfg, cfg = _small_config(batch=2, gt=96)
    for c in (jcfg, cfg):
        c.MODEL.G_LOSS.CRITERIONS = {"Adversarial": {"kind": "adversarial"},
                                     "Pixel": {"kind": "pixel", "criterion": "mse"}}
    jg, jd = JaxGenerator.from_config(jcfg), JaxD.from_config(jcfg)
    g_tx, d_tx = S.make_g_optimizer(jcfg, 10), S.make_d_optimizer(jcfg, 10)
    jstate = S.create_gan_state(jcfg, jg, jd, g_tx, d_tx)
    g_vars = jax.device_get({"params": jstate.g_params, "batch_stats": jstate.g_stats})
    d_vars = jax.device_get({"params": jstate.d_params, "batch_stats": jstate.d_stats})
    state = _port_g_state(cfg, g_vars, milestones=True)
    state.d_model = Discriminator.from_config(cfg)
    state.d_model.load_state_dict(discriminator_state_dict_from_variables(d_vars))
    state.d_opt = make_d_optimizer(cfg, state.d_model.parameters(), 10)

    jg_step, jd_step = (jax.jit(f) for f in S.make_gan_steps(
        jcfg, jg, jd, jax_crits(jcfg), g_tx, d_tx))
    g_step, d_step = make_gan_steps(cfg, build_criterions(cfg))
    b0, b1 = _batches(2, 2, 96)
    jstate, jsr, jm = jg_step(jstate, jnp.asarray(b0))
    state, sr, m = g_step(state, b0)
    d_stats_moved = variables_from_discriminator_state_dict(state.d_model.state_dict())
    assert not np.allclose(d_stats_moved["batch_stats"]["bn1"]["mean"],
                           d_vars["batch_stats"]["bn1"]["mean"])
    np.testing.assert_array_equal(d_stats_moved["params"]["fc2"]["kernel"],
                                  d_vars["params"]["fc2"]["kernel"])
    jstate, jdm = jd_step(jstate, jnp.asarray(b0), jsr)
    state, dm = d_step(state, b0, sr)
    jstate, _, jm2 = jg_step(jstate, jnp.asarray(b1))
    state, _, m2 = g_step(state, b1)
    for a, b in ((m, jm), (dm, jdm), (m2, jm2)):
        for k in b:
            assert abs(float(a[k]) - float(b[k])) < 1e-5, k
    _assert_trees_close(
        variables_from_generator_state_dict(state.g_model.state_dict()),
        jax.device_get({"params": jstate.g_params, "batch_stats": jstate.g_stats}),
        atol=5e-5, rtol=1e-4)
    _assert_trees_close(
        variables_from_discriminator_state_dict(state.d_model.state_dict()),
        jax.device_get({"params": jstate.d_params, "batch_stats": jstate.d_stats}),
        atol=5e-5, rtol=1e-4)


@pytest.mark.parametrize("which", ["g", "d"])
def test_adam_and_schedule_match_optax(which):
    """The port's Adam (torch.optim.Adam with the explicit lr of each
    update) against the JAX package's optax optimizer on the same gradient
    stream, across the MultiStepLR boundary: G's milestone in global steps,
    D's in D-update counts (steps.py:87-103). atol 1e-5, 1e-4 of the lr:
    torch and optax round the moment updates in another order."""
    from srgan_st_tpu.core.config import Config as JaxConfig
    from srgan_st_tpu.train import steps as S
    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.train import steps as T

    jcfg, cfg = JaxConfig(), Config()
    for c in (jcfg, cfg):
        c.SCHEDULER.MILESTONES = [1]
        c.SOLVER.D_UPDATE_INTERVAL = 2
        c.SOLVER.G_BASE_LR = c.SOLVER.D_BASE_LR = 0.1
    spe = 3  # G: decay at update 3; D: 2 updates per epoch, decay at update 2
    rng = np.random.default_rng(7)
    p0 = rng.standard_normal(6).astype(np.float32)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    if which == "g":
        tx, opt = S.make_g_optimizer(jcfg, spe), T.make_g_optimizer(cfg, [param], spe)
        boundary = 3
    else:
        tx, opt = S.make_d_optimizer(jcfg, spe), T.make_d_optimizer(cfg, [param], spe)
        boundary = 2
    assert opt.lr_fn(boundary - 1) == 0.1 and opt.lr_fn(boundary) == 0.05
    jp = jnp.asarray(p0)
    jopt = tx.init(jp)
    for _ in range(6):
        g = rng.standard_normal(6).astype(np.float32)
        updates, jopt = tx.update(jnp.asarray(g), jopt, jp)
        jp = jp + updates
        opt.step([torch.from_numpy(g)])
        np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp), atol=1e-5)


def test_warmup_golden_first_steps():
    """The first 5 warmup losses of tests/goldens/training_trajectory.npz
    (the executed reference loop, torch CPU): the golden's init weights
    (reference state_dict keys) load into the port directly; the losses
    agree within 2e-4 relative, the golden's own tight bound."""
    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.losses.registry import build_warmup_criterions
    from srgan_st_tpu_torch.models.generator import Generator
    from srgan_st_tpu_torch.train.steps import GANTrainState, make_g_optimizer, make_warmup_step

    data = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                                "training_trajectory.npz"))
    warm_n, _, batch, spe, _, _ = (int(v) for v in data["meta"])
    cfg = Config()
    cfg.DATA.BATCH_SIZE = batch
    g = Generator(channels=16, num_rcb=2)
    g.load_state_dict({k[3:]: torch.from_numpy(np.asarray(data[k]))
                       for k in data.files if k.startswith("g0/")})
    state = GANTrainState(g_model=g, g_opt=make_g_optimizer(cfg, g.parameters(), spe,
                                                            milestones=False))
    step = make_warmup_step(cfg, build_warmup_criterions(cfg))
    feed = np.random.default_rng(1234).integers(0, 256, (warm_n, batch, 96, 96, 3),
                                                dtype=np.uint8)
    for i in range(5):
        state, m = step(state, feed[i])
        want = float(data["warm_losses"][i])
        assert abs(float(m["G_Loss"]) - want) / want < 2e-4, i


# ---------------------------------------------------------------------------
# training loops

def _loop_config(n_epochs):
    from srgan_st_tpu_torch.core.config import apply_overrides, Config

    return apply_overrides(Config(), [
        "DATA.SYNTHETIC=true", "DATA.SYNTHETIC_N_BATCHES=2", "DATA.BATCH_SIZE=2",
        "MODEL.G_N_RCB=1", "MODEL.G_N_CHANNEL=8", "MODEL.D_N_CHANNEL=4",
        "SOLVER.D_UPDATE_INTERVAL=2", "LOG_TRAIN_PERIOD=1", f"EXP.N_EPOCHS={n_epochs}",
        "EXP.NAME=tiny"])


@pytest.mark.parametrize("phase", ["warmup", "train"])
def test_training_loop_runs_and_resumes(phase, tmp_path, monkeypatch, capsys):
    """warmup() and train() on synthetic data on the CPU write the npz
    checkpoints and the train state; a restart with one more epoch resumes
    at the second epoch, from the saved step."""
    from srgan_st_tpu_torch.train.train import train
    from srgan_st_tpu_torch.train.warmup import warmup

    monkeypatch.chdir(tmp_path)
    run = warmup if phase == "warmup" else train
    state = run(_loop_config(1), device="cpu")
    assert state.step == 2
    files = set(os.listdir(tmp_path / "results" / "tiny"))
    assert {"g_last.npz", "last.state.pt"} <= files
    if phase == "train":
        assert "d_last.npz" in files and state.d_opt.count == 1
    capsys.readouterr()
    state = run(_loop_config(2), device="cpu")
    out = capsys.readouterr().out
    assert "Beginning train epoch: 1" not in out and "Beginning train epoch: 2" in out
    assert state.step == 4


def test_cli_parses_overrides():
    from srgan_st_tpu_torch.core.config import parse_driver_cli

    cfg, device = parse_driver_cli(
        ["--epochs", "3", "--set", "TPU.TRUNK_MODE=packed", "--set",
         "MODEL.G_LOSS.CRITERION_WEIGHTS.Pixel=0.5", "--device", "cpu"], "d")
    assert (cfg.EXP.N_EPOCHS, cfg.TPU.TRUNK_MODE, device) == (3, "packed", "cpu")
    assert cfg.MODEL.G_LOSS.CRITERION_WEIGHTS["Pixel"] == 0.5
    with pytest.raises(SystemExit):
        parse_driver_cli(["--set", "TPU.NO_SUCH=1"], "d")


def test_unported_training_options_raise(tmp_path):
    """content_vgg, ported, raises only for its missing weights; the data
    options of Queue A item 4 (DATA.AUGMENT, DATA.TILE_SIZE), ported, build;
    so do TPU.CHUNK_STEPS, TPU.NAN_GUARD and TPU.REMAT (Queue A item 6),
    and EXP.ORBAX_CHECKPOINTS (DCP train states, tests/test_torch_ckpt.py).
    What the port leaves out raises: TPU.SHARD_MAP is no key of the port
    (torch has no GSPMD, so its step is always the explicit form), nor
    TPU.DONATE (the port's steps update the state in place, which is what
    donation buys in JAX), and any mesh but the 1-D ('data',) layout over
    the processes is refused (ROADMAP.md Queue C)."""
    from srgan_st_tpu_torch.core.config import Config, apply_overrides
    from srgan_st_tpu_torch.data.pipeline import SyntheticPatchSource, make_train_source
    from srgan_st_tpu_torch.losses.registry import build_criterions
    from srgan_st_tpu_torch.parallel.mesh import make_mesh
    from srgan_st_tpu_torch.train.steps import make_warmup_step

    cfg = Config()
    cfg.MODEL.G_LOSS.CRITERIONS = {"ContentVGG": {"kind": "content_vgg"}}
    cfg.MODEL.G_LOSS.VGG19_WEIGHTS = str(tmp_path / "absent.npz")
    with pytest.raises(FileNotFoundError, match="tools/convert_vgg19.py"):
        build_criterions(cfg)
    cfg = apply_overrides(Config(), ["DATA.AUGMENT=true", "DATA.TILE_SIZE=120",
                                     "DATA.SYNTHETIC=true"])
    assert callable(make_warmup_step(cfg, {}))
    assert isinstance(make_train_source(cfg), SyntheticPatchSource)
    cfg = apply_overrides(Config(), ["TPU.CHUNK_STEPS=50", "TPU.NAN_GUARD=true",
                                     "TPU.REMAT=true", "TPU.CUDA_GRAPHS=false",
                                     "DATA.SYNTHETIC=true"])
    assert (cfg.TPU.CHUNK_STEPS, cfg.TPU.NAN_GUARD, cfg.TPU.REMAT) == (50, True, True)
    assert callable(make_warmup_step(cfg, {}))
    assert apply_overrides(Config(), ["EXP.ORBAX_CHECKPOINTS=true"]).EXP.ORBAX_CHECKPOINTS
    for key in ("TPU.SHARD_MAP=true", "TPU.DONATE=true"):
        with pytest.raises(SystemExit):
            apply_overrides(Config(), [key])
    assert make_mesh(Config()).world_size == 1
    for shape, axes in (((1, 1), ("data", "model")), ((2,), ("data",)), (None, ("model",))):
        cfg = Config()
        cfg.TPU.MESH_SHAPE, cfg.TPU.MESH_AXES = shape, axes
        with pytest.raises(ValueError, match="1-D"):
            make_mesh(cfg)
