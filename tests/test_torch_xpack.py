"""The port's xpack trunks against the JAX package's `xpack_trunk` /
`xpack_trunk_eval`, and the Generator's "xpack" modes, on the CPU: in
training the port runs xpack's function as the K4/K5 trunk
(kernels/packed_trunk.py, whose plain version runs on a CPU tensor), in
eval as kernels/xpack_trunk.py's BatchNorm-folded trunk.

Seeded numpy inputs go through both. The JAX functions are plain XLA (its
lane packing has no Pallas), run as its own tests run them. Each test states
its tolerance; bf16 is held to 2x JAX's own bf16-vs-f32 envelope on the same
bf16-rounded inputs, since the two round at other points.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
from srgan_st_tpu_torch.kernels import xpack_trunk as xp
from srgan_st_tpu_torch.kernels.packed_trunk import packed_trunk
from srgan_st_tpu_torch.models.generator import Generator, random_variables
from srgan_st_tpu_torch.train.checkpoint import generator_state_dict_from_variables


def _args(rng, n, c):
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(n, 3, 3, c, c) * 0.05, f(n, 3, 3, c, c) * 0.05, 1 + 0.1 * f(n, c),
            0.1 * f(n, c), 1 + 0.1 * f(n, c), 0.1 * f(n, c), 0.25 + 0.01 * f(n))


def _stats(rng, n, c):
    return (0.1 * rng.standard_normal((n, c)).astype(np.float32),
            rng.uniform(0.5, 1.5, (n, c)).astype(np.float32),
            0.1 * rng.standard_normal((n, c)).astype(np.float32),
            rng.uniform(0.5, 1.5, (n, c)).astype(np.float32))


def _bf16_round(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _train_case(shape, n, dtype_name):
    """Seeded inputs; JAX's y, stats and the 8 gradients of sum(y^2) in
    `dtype_name` and, on the same rounded x, in f32."""
    from srgan_st_tpu.kernels.xpack_trunk import xpack_trunk as jax_xpack

    rng = np.random.default_rng(0)
    args = _args(rng, n, shape[-1])
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype_name == "bfloat16":
        x = _bf16_round(x)

    def run(dt):
        xj, ja = jnp.asarray(x, dt), tuple(jnp.asarray(a) for a in args)
        y, st = jax_xpack(xj, *ja, 1e-5)
        grads = jax.grad(
            lambda *a: jnp.sum(jax_xpack(*a, 1e-5)[0].astype(jnp.float32) ** 2),
            argnums=tuple(range(8)))(xj, *ja)
        return [np.asarray(t, np.float32) for t in (y, st, *grads)]

    ref = run(jnp.dtype(dtype_name))
    return x, args, ref, run(jnp.float32) if dtype_name == "bfloat16" else ref


def _port_train(x, args, dtype):
    xt = torch.tensor(x, dtype=dtype, requires_grad=True)
    at = [torch.from_numpy(a).requires_grad_() for a in args]
    y, st = packed_trunk(xt, *at, 1e-5)
    assert not st.requires_grad
    (y.float() ** 2).sum().backward()
    return [t.detach().float().numpy() for t in (y, st, xt.grad, *(a.grad for a in at))]


def test_xpack_trunk_f32_matches_jax():
    """(2, 8, 10, 16), n = 2, f32: packed_trunk's y and stats within 1e-5
    relative to max|ref| of JAX's xpack_trunk, and the 8 gradients of sum(y^2) (x, both
    kernels, the BN scales and biases, the PReLU slopes) within 1e-4."""
    x, args, ref, _ = _train_case((2, 8, 10, 16), 2, "float32")
    got = _port_train(x, args, torch.float32)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.shape == r.shape, i
        tol = 1e-5 if i < 2 else 1e-4
        assert np.abs(g - r).max() <= tol * np.abs(r).max(), (i, np.abs(g - r).max())


def test_xpack_trunk_bf16_within_envelope():
    """(2, 8, 8, 64), n = 2, bf16: packed_trunk's y, stats and 8 gradients
    within 2x JAX's xpack_trunk's own bf16-vs-f32 envelope on the same
    inputs."""
    x, args, ref16, ref32 = _train_case((2, 8, 8, 64), 2, "bfloat16")
    got = _port_train(x, args, torch.bfloat16)
    for i, (g, r16, r32) in enumerate(zip(got, ref16, ref32)):
        env = np.abs(r16 - r32).max()
        assert 0 < env, i
        assert np.abs(g - r32).max() <= 2 * env, (i, np.abs(g - r32).max(), env)


def test_xpack_trunk_is_the_packed_plain_forward():
    """In a train step trunk_mode="xpack" is the K4/K5 trunk: at bf16 and
    C = 64 (inside its gate) its output and running statistics equal
    trunk_mode="packed"'s bit for bit, and it calls packed_trunk; in f32
    (outside the gate) and at an odd width it runs the unfused blocks."""
    from srgan_st_tpu_torch.kernels import packed_trunk as pt

    sd = generator_state_dict_from_variables(random_variables(1, channels=64, num_rcb=2))
    lr = torch.from_numpy(np.random.default_rng(1).random((2, 6, 8, 3), np.float32))
    outs = []
    for mode in ("xpack", "packed"):
        g = Generator(channels=64, num_rcb=2, upscale=4, dtype=torch.bfloat16, trunk_mode=mode)
        g.load_state_dict(sd)
        assert g._trunk_mode(True, torch.zeros(2, 6, 8, 64, dtype=torch.bfloat16)) == "packed"
        outs.append((g(lr, train=True), g.state_dict()))
    assert torch.equal(outs[0][0], outs[1][0])
    for k, v in outs[0][1].items():
        assert torch.equal(v, outs[1][1][k]), k
    g = Generator(channels=64, num_rcb=2, upscale=4, trunk_mode="xpack")
    assert g._trunk_mode(True, torch.zeros(2, 6, 8, 64)) == "unfused"
    g16 = Generator(channels=64, num_rcb=2, upscale=4, dtype=torch.bfloat16, trunk_mode="xpack")
    assert g16._trunk_mode(True, torch.zeros(2, 6, 7, 64, dtype=torch.bfloat16)) == "unfused"
    assert pt.packed_trunk is packed_trunk


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_xpack_trunk_eval_matches_jax(dtype_name):
    """(1, 8, 10, 16), n = 2: the BN-folded eval trunk against JAX's
    xpack_trunk_eval on the same running statistics; f32 within 1e-5
    relative to max|ref|, bf16 within 2x JAX's bf16-vs-f32 envelope."""
    from srgan_st_tpu.kernels.xpack_trunk import xpack_trunk_eval as jax_eval

    rng = np.random.default_rng(2)
    args = _args(rng, 2, 16) + _stats(rng, 2, 16)
    x = rng.standard_normal((1, 8, 10, 16)).astype(np.float32)
    if dtype_name == "bfloat16":
        x = _bf16_round(x)

    def run_jax(dt):
        return np.asarray(jax_eval(jnp.asarray(x, dt), *map(jnp.asarray, args), 1e-5),
                          np.float32)

    got = xp.xpack_trunk_eval(torch.tensor(x, dtype=getattr(torch, dtype_name)),
                              *map(torch.from_numpy, args), 1e-5).float().numpy()
    ref32 = run_jax(jnp.float32)
    if dtype_name == "float32":
        assert np.abs(got - ref32).max() <= 1e-5 * np.abs(ref32).max()
    else:
        env = np.abs(run_jax(jnp.bfloat16) - ref32).max()
        assert 0 < env and np.abs(got - ref32).max() <= 2 * env


def _generators(dtype_name, trunk_mode, channels=16, num_rcb=2):
    from srgan_st_tpu.models.generator import Generator as JaxGenerator

    variables = random_variables(3, channels=channels, num_rcb=num_rcb)
    jax_g = JaxGenerator(channels=channels, num_rcb=num_rcb, upscale=4,
                         dtype=jnp.dtype(dtype_name), trunk_mode=trunk_mode)
    g = Generator(channels=channels, num_rcb=num_rcb, upscale=4,
                  dtype=getattr(torch, dtype_name), trunk_mode=trunk_mode)
    g.load_state_dict(generator_state_dict_from_variables(variables))
    return variables, jax_g, g.eval()


@pytest.mark.parametrize("hw", [(8, 10), (7, 9)])
def test_eval_generator_xpack_matches_jax(hw):
    """The eval Generator with trunk_mode="xpack" against the JAX Generator
    with the same mode: BN folded into the convs at an even width, the
    unfused trunk at an odd one (both Generators' gate); f32 within 1e-4
    absolute of the [0, 1] image, as test_torch_generator's f32 parity."""
    variables, jax_g, g = _generators("float32", "xpack")
    lr = np.random.default_rng(4).random((1, *hw, 3), np.float32)
    want = np.asarray(jax_g.apply(variables, jnp.asarray(lr), train=False))
    with torch.inference_mode():
        got = g(torch.from_numpy(lr)).numpy()
    assert g._trunk_mode(False, torch.zeros(1, *hw, 16)) == (
        "xpack_eval" if hw[1] % 2 == 0 else "unfused")
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_eval_generator_xpack_bf16_within_envelope():
    """bf16 eval Generator with trunk_mode="xpack" within 2x the JAX
    Generator's bf16-vs-f32 envelope on the same input."""
    variables, jax_g, g = _generators("bfloat16", "xpack")
    _, jax_g32, _ = _generators("float32", "xpack")
    lr = np.random.default_rng(5).random((1, 8, 10, 3), np.float32)
    ref16 = np.asarray(jax_g.apply(variables, jnp.asarray(lr), train=False))
    ref32 = np.asarray(jax_g32.apply(variables, jnp.asarray(lr), train=False))
    with torch.inference_mode():
        got = g(torch.from_numpy(lr)).numpy()
    env = np.abs(ref16 - ref32).max()
    assert 0 < env and np.abs(got - ref32).max() <= 2 * env


def test_train_generator_xpack_matches_jax():
    """A train-mode forward with trunk_mode="xpack" in f32 (the unfused
    blocks: f32 is outside the K4/K5 gate): the output within 1e-4 of the
    JAX Generator's, and every running statistic the EMA leaves within 1e-5
    of the JAX batch_stats."""
    from srgan_st_tpu_torch.train.checkpoint import variables_from_generator_state_dict

    variables, jax_g, g = _generators("float32", "xpack")
    g.train()
    lr = np.random.default_rng(6).random((2, 8, 10, 3), np.float32)
    want, mutated = jax_g.apply(variables, jnp.asarray(lr), train=True,
                                mutable=["batch_stats"])
    got = g(torch.from_numpy(lr), train=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)
    stats = variables_from_generator_state_dict(g.state_dict())["batch_stats"]
    leaves = jax.tree_util.tree_leaves_with_path(mutated["batch_stats"])
    assert len(leaves) == 2 * 2 * 2 + 2
    for path, leaf in leaves:
        node = stats
        for key in path:
            node = node[key.key]
        np.testing.assert_allclose(np.asarray(node), np.asarray(leaf), atol=1e-5)


def test_train_generator_xpack_bf16_within_envelope():
    """A bf16 train-mode forward with trunk_mode="xpack" at C = 64 (the
    K4/K5 trunk; its plain version on the CPU) against the JAX Generator's
    xpack trunk: the output and every running statistic the EMA leaves
    within 2x JAX's own bf16-vs-f32 envelope on the same input."""
    from srgan_st_tpu_torch.train.checkpoint import variables_from_generator_state_dict

    variables, jax_g, g = _generators("bfloat16", "xpack", channels=64)
    _, jax_g32, _ = _generators("float32", "xpack", channels=64)
    g.train()
    lr = np.random.default_rng(7).random((2, 8, 10, 3), np.float32)
    ref16, mut16 = jax_g.apply(variables, jnp.asarray(lr), train=True, mutable=["batch_stats"])
    ref32, mut32 = jax_g32.apply(variables, jnp.asarray(lr), train=True,
                                 mutable=["batch_stats"])
    assert g._trunk_mode(True, torch.zeros(2, 8, 10, 64, dtype=torch.bfloat16)) == "packed"
    got = g(torch.from_numpy(lr), train=True).detach().float().numpy()
    env = np.abs(np.asarray(ref16, np.float32) - np.asarray(ref32)).max()
    assert 0 < env and np.abs(got - np.asarray(ref32)).max() <= 2 * env
    stats = variables_from_generator_state_dict(g.state_dict())["batch_stats"]
    pairs = zip(jax.tree_util.tree_leaves_with_path(mut16["batch_stats"]),
                jax.tree_util.tree_leaves(mut32["batch_stats"]))
    for (path, l16), l32 in pairs:
        node = stats
        for key in path:
            node = node[key.key]
        l16, l32 = np.asarray(l16, np.float32), np.asarray(l32, np.float32)
        env = np.abs(l16 - l32).max()
        assert 0 < env and np.abs(np.asarray(node, np.float32) - l32).max() <= 2 * env, path


def test_xpack_eval_raises_in_training():
    """"xpack_eval" is eval only: a train step raises the JAX ValueError;
    eval runs the folded trunk."""
    g = Generator(channels=16, num_rcb=1, upscale=2, trunk_mode="xpack_eval")
    x = torch.rand(1, 4, 6, 3)
    with pytest.raises(ValueError, match="eval-only"):
        g(x, train=True)
    assert g._trunk_mode(False, torch.zeros(1, 4, 6, 16)) == "xpack_eval"
    assert g.eval()(x).shape == (1, 8, 12, 3)
