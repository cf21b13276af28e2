"""The port's fused trunk (K6's plain version and the torch `_bwd_xla`)
against the JAX package's `fused_trunk` in interpret mode, on the CPU.

Seeded numpy inputs go through both. Each test states its tolerance. The
JAX Generator's Pallas trunks are held to one device by tests elsewhere;
its fused mode has no such gate, but the tests pin `jax.device_count` to 1
for the Generator comparison, as the packed trunk's tests do.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
from srgan_st_tpu_torch.kernels import fused_trunk as ft
from srgan_st_tpu_torch.kernels import packed_trunk as pt


def _args(rng, n, c):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(n, 3, 3, c, c) * 0.05, f(n, 3, 3, c, c) * 0.05, 1 + 0.1 * f(n, c),
            0.1 * f(n, c), 1 + 0.1 * f(n, c), 0.1 * f(n, c), 0.25 + 0.01 * f(n))


@functools.lru_cache(maxsize=None)
def _case(shape, n, dtype_name):
    """Seeded inputs; JAX's K6 forward (interpret mode) with its residuals,
    and y, stats and the 8 gradients of sum(y^2) through fused_trunk, for
    x in `dtype_name` and, on the same rounded inputs, in f32."""
    from srgan_st_tpu.kernels.fused_trunk import _fwd_pallas, fused_trunk as jax_fused

    rng = np.random.default_rng(0)
    args = _args(rng, n, shape[-1])
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype_name == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))

    def run(dt):
        xj = jnp.asarray(x, dt)
        ja = tuple(jnp.asarray(a) for a in args)
        fwd = _fwd_pallas(xj, *ja, 1e-5, interpret=True)
        grads = jax.grad(
            lambda *a: jnp.sum(jax_fused(*a, 1e-5, True)[0].astype(jnp.float32) ** 2),
            argnums=tuple(range(8)))(xj, *ja)
        return [np.asarray(t, np.float32) for t in (*fwd, *grads)]

    ref = run(jnp.dtype(dtype_name))
    ref32 = run(jnp.float32) if dtype_name == "bfloat16" else ref
    return x, args, ref, ref32


def _port(x, args, dtype):
    """The port's forward residuals (plain version), then y, stats and the
    8 gradients through the autograd Function on the CPU."""
    xt = torch.tensor(x, dtype=dtype, requires_grad=True)
    at = [torch.from_numpy(a).requires_grad_() for a in args]
    with torch.no_grad():
        fwd = ft.fused_trunk_reference(xt, *at, 1e-5)
    y, st = ft.fused_trunk(xt, *at)
    (y.float() ** 2).sum().backward()
    return [t.detach().float().numpy() for t in (*fwd, xt.grad, *(a.grad for a in at))]


def test_fused_f32_matches_jax():
    """(2, 8, 8, 32), n = 2, f32: y, the residuals xs, a1s, a2s and the
    stats within atol 1e-5 of JAX's K6 in interpret mode, and all 8
    gradients within 1e-4 of max|ref| (test_kernels.py:283-306's bounds)."""
    x, args, ref, _ = _case((2, 8, 8, 32), 2, "float32")
    got = _port(x, args, torch.float32)
    for i in range(5):
        assert got[i].shape == ref[i].shape
        np.testing.assert_allclose(got[i], ref[i], atol=1e-5)
    for g, r in zip(got[5:], ref[5:]):
        assert g.shape == r.shape
        assert np.abs(g - r).max() / (np.abs(r).max() + 1e-9) < 1e-4


def test_fused_bf16_within_envelope():
    """(2, 8, 8, 64), n = 2, bf16: the forward, its residuals and stats and
    every gradient within 2x JAX's own bf16-vs-f32 envelope on the same
    inputs."""
    x, args, ref16, ref32 = _case((2, 8, 8, 64), 2, "bfloat16")
    got = _port(x, args, torch.bfloat16)
    for i, (g, r16, r32) in enumerate(zip(got, ref16, ref32)):
        env = np.abs(r16 - r32).max()
        assert 0 < env, i
        assert np.abs(g - r32).max() <= 2 * env, (i, np.abs(g - r32).max(), env)


def test_fused_forward_is_the_packed_forward():
    """K6's function and roundings are K4's: the plain forward is K4's
    `packed_trunk._reference_forward`, and JAX's K6 and K4 agree on it, to
    1e-5 in f32 (their convolutions sum in another order)."""
    from srgan_st_tpu.kernels.packed_trunk import packed_trunk as jax_packed

    assert ft.fused_trunk_reference is pt._reference_forward
    x, args, ref, _ = _case((2, 8, 8, 32), 2, "float32")
    y, st = jax_packed(jnp.asarray(x), *(jnp.asarray(a) for a in args), 1e-5, True)
    np.testing.assert_allclose(np.asarray(y), ref[0], atol=1e-5)
    np.testing.assert_allclose(np.asarray(st), ref[4], atol=1e-5)


def test_fused_backward_rounds_as_bwd_xla():
    """The backward follows `_bwd_xla`'s roundings, not K5's: in bf16 its
    gradients differ from packed_trunk's plain backward on the same
    residuals (the compute-dtype rsqrt and the rounded dgrads), and each
    is nearer JAX's fused gradients than K5's plain backward is (summed
    over the 8)."""
    x, args, ref16, _ = _case((2, 8, 8, 64), 2, "bfloat16")
    xt = torch.tensor(x, dtype=torch.bfloat16)
    at = [torch.from_numpy(a) for a in args]
    y, xs, a1s, a2s, stats = ft.fused_trunk_reference(xt, *at, 1e-5)
    dy = 2 * y.float()
    bp = (at[0], at[1], at[2], at[3], at[4], at[6])
    fused = ft.fused_trunk_backward(dy, xs, a1s, a2s, stats, *bp, 1e-5)
    packed = pt._reference_backward(dy, xs, a1s, a2s, stats, *bp, 1e-5)
    assert any(not torch.equal(a.float(), b.float()) for a, b in zip(fused, packed))
    d_fused = sum(np.abs(g.float().numpy() - r).max() for g, r in zip(fused, ref16[5:]))
    d_packed = sum(np.abs(g.float().numpy() - r).max() for g, r in zip(packed, ref16[5:]))
    assert d_fused < d_packed, (d_fused, d_packed)


def test_fused_kernel_not_launched_on_cpu():
    before = ft.launches
    _port(*_case((2, 8, 8, 32), 2, "float32")[:2], torch.float32)
    assert ft.launches == before


@pytest.mark.parametrize("dtype_name,out_atol,stat_atol", [
    ("float32", 1e-5, 1e-5),
    ("bfloat16", 0.06, 2e-2),  # test_kernels.py:401-428's bf16 bounds
])
def test_generator_fused_matches_jax(monkeypatch, dtype_name, out_atol, stat_atol):
    """Train-mode forward of a 64-channel, 2-RCB generator with trunk
    "fused" against the JAX Generator's "fused_interpret": output, the
    running-stat EMA from the returned stats, the same variable tree; eval
    resolves to the unfused blocks."""
    from srgan_st_tpu.models.generator import Generator as JaxGenerator
    from srgan_st_tpu_torch.models.generator import Generator, random_variables
    from srgan_st_tpu_torch.train.checkpoint import (
        generator_state_dict_from_variables,
        variables_from_generator_state_dict,
    )

    monkeypatch.setattr(jax, "device_count", lambda *a, **k: 1)
    variables = random_variables(0, channels=64, num_rcb=2)
    lr = np.random.default_rng(1).random((2, 8, 10, 3), np.float32)
    jg = JaxGenerator(channels=64, num_rcb=2, dtype=jnp.dtype(dtype_name),
                      trunk_mode="fused_interpret")
    want, mut = jg.apply(variables, jnp.asarray(lr), train=True, mutable=["batch_stats"])
    dt = getattr(torch, dtype_name)
    g = Generator(channels=64, num_rcb=2, dtype=dt, trunk_mode="fused")
    sd = generator_state_dict_from_variables(variables)
    g.load_state_dict(sd)
    got = g(torch.from_numpy(lr), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=out_atol)
    stats = variables_from_generator_state_dict(g.state_dict())["batch_stats"]
    want_stats = jax.device_get(mut["batch_stats"])
    assert jax.tree_util.tree_structure(stats) == jax.tree_util.tree_structure(want_stats)
    for a, b in zip(jax.tree_util.tree_leaves(stats), jax.tree_util.tree_leaves(want_stats)):
        np.testing.assert_allclose(a, np.asarray(b), atol=stat_atol)
    unfused = Generator(channels=64, num_rcb=2, dtype=dt)
    unfused.load_state_dict(sd)
    g.load_state_dict(sd)
    assert torch.equal(g(torch.from_numpy(lr)), unfused(torch.from_numpy(lr)))


def test_generator_fused_gradients_match_unfused():
    """f32: every parameter gradient of a 2-RCB generator's train step
    through trunk "fused" equals autograd of the unfused blocks within
    1e-4 of max|ref| (summation order)."""
    from srgan_st_tpu_torch.models.generator import Generator, random_variables
    from srgan_st_tpu_torch.train.checkpoint import generator_state_dict_from_variables

    sd = generator_state_dict_from_variables(random_variables(3, channels=16, num_rcb=2))
    lr = torch.rand(2, 8, 8, 3, generator=torch.Generator().manual_seed(0))
    grads = []
    for mode in ("fused", "unfused"):
        g = Generator(channels=16, num_rcb=2, trunk_mode=mode)
        g.load_state_dict(sd)
        g(lr, train=True).square().mean().backward()
        grads.append({k: p.grad for k, p in g.named_parameters()})
    for k, ref in grads[1].items():
        got = grads[0][k]
        assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max()) + 1e-12, k
