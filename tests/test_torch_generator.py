"""The port's generator and weight carry-over against the JAX package.

Seeded numpy weights (models/generator.py random_variables) go into the
JAX `Generator` as a variables tree and into the port's `Generator`
through generator_state_dict_from_variables; the same numpy LR batch goes
through both. Everything runs on the CPU, where the port's kernel wrappers
take their plain versions and the JAX package runs its Pallas tail in
interpret mode.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
from srgan_st_tpu.models.generator import Generator as JaxGenerator
from srgan_st_tpu_torch.kernels import launch_counts
from srgan_st_tpu_torch.models.generator import Generator, random_variables
from srgan_st_tpu_torch.train.checkpoint import (
    generator_state_dict_from_variables,
    variables_from_generator_state_dict,
)

# (channels, num_rcb, upscale, extra Generator options, LR height and width)
CASES = {
    "16ch-x2": (16, 2, 2, {}, (8, 10)),
    "16ch-x3": (16, 2, 3, {}, (8, 10)),
    "16ch-x4": (16, 2, 4, {}, (8, 10)),
    "16ch-x4-s2d-stem": (16, 2, 4, {"stem_mode": "s2d"}, (8, 12)),
    "64ch-x4-fused-tail": (64, 2, 4, {"tail_mode": "fused"}, (8, 10)),
    "64ch-x2-fused-tail-odd": (64, 2, 2, {"tail_mode": "fused"}, (7, 9)),
    "full-width": (64, 16, 4, {}, (8, 8)),
}


def _models(case, dtype_name="float32", seed=0):
    ch, nrcb, up, opts, hw = CASES[case]
    variables = random_variables(seed, channels=ch, num_rcb=nrcb, upscale=up)
    jax_g = JaxGenerator(channels=ch, num_rcb=nrcb, upscale=up,
                         dtype=jnp.dtype(dtype_name), **opts)
    g = Generator(channels=ch, num_rcb=nrcb, upscale=up,
                  dtype=getattr(torch, dtype_name), **opts)
    g.load_state_dict(generator_state_dict_from_variables(variables))
    g.eval()
    lr = np.random.default_rng(seed + 1).random((1, *hw, 3), np.float32)
    return variables, jax_g, g, lr


def _run_jax(jax_g, variables, lr):
    return np.asarray(jax_g.apply(variables, jnp.asarray(lr), train=False))


def _run_port(g, lr):
    with torch.inference_mode():
        return g(torch.from_numpy(lr)).numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_generator_f32_matches_jax(case):
    """f32 eval forward == the JAX generator on the same weights and input.
    atol 1e-4: the two frameworks sum each conv in another order. More
    than half of the outputs lie strictly inside (0, 1), so the clamp
    hides little."""
    variables, jax_g, g, lr = _models(case)
    before = launch_counts()
    want = _run_jax(jax_g, variables, lr)
    got = _run_port(g, lr)
    assert launch_counts() == before  # CPU tensors never launch a kernel
    assert got.shape == want.shape == (1, lr.shape[1] * g.upscale,
                                       lr.shape[2] * g.upscale, 3)
    assert got.dtype == np.float32
    assert ((want > 0) & (want < 1)).mean() > 0.5
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("case", ["16ch-x4", "64ch-x4-fused-tail"])
def test_generator_bf16_within_envelope(case):
    """bf16 forward within 2x the JAX bf16-vs-f32 envelope: bf16 rounds at
    other points in the two frameworks, so no fixed epsilon applies."""
    variables, jax_g32, _, lr = _models(case)
    _, jax_g16, g16, _ = _models(case, "bfloat16")
    ref = _run_jax(jax_g32, variables, lr)
    env = np.abs(_run_jax(jax_g16, variables, lr) - ref).max()
    assert 0 < env < 0.1
    assert np.abs(_run_port(g16, lr) - ref).max() <= 2 * env


def test_fused_tail_gate_falls_back_on_odd_dims(monkeypatch):
    """TAIL_MODE="fused" with an odd last-block input takes the composed
    path, as the JAX gate does (generator.py:361-374)."""
    from srgan_st_tpu_torch.kernels import serving_tail

    calls = []
    real = serving_tail.serving_tail
    monkeypatch.setattr(serving_tail, "serving_tail",
                        lambda *a: calls.append(1) or real(*a))
    _, _, g, lr = _models("64ch-x2-fused-tail-odd")
    _run_port(g, lr)
    assert calls == []
    _run_port(g, lr[:, :6, :6])
    assert calls == [1]


def test_weight_round_trip_is_exact():
    """JAX variables -> port state_dict -> JAX variables is the identity,
    and the port's Generator loads the state_dict with no key left over."""
    import jax

    variables = random_variables(3, channels=16, num_rcb=2, upscale=4)
    sd = generator_state_dict_from_variables(variables)
    g = Generator(channels=16, num_rcb=2, upscale=4)
    assert set(g.state_dict()) == set(sd)
    g.load_state_dict(sd)
    back = variables_from_generator_state_dict(g.state_dict())
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(variables))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(variables)):
        assert a.shape == np.shape(b)
        np.testing.assert_array_equal(a, b)


def test_jax_init_tree_carries_over():
    """The tree the JAX Generator's own init makes maps onto every key of
    the port's state_dict (HWIO -> OIHW, scalar slope -> (1,))."""
    import jax

    jax_g = JaxGenerator(channels=16, num_rcb=2, upscale=4)
    variables = jax.device_get(jax_g.init(jax.random.key(0),
                                          jnp.zeros((1, 8, 8, 3)), train=False))
    sd = generator_state_dict_from_variables(variables)
    g = Generator(channels=16, num_rcb=2, upscale=4)
    g.load_state_dict(sd)
    np.testing.assert_array_equal(
        g.conv1[0].weight.detach().numpy(),
        np.asarray(variables["params"]["conv1"]["kernel"]).transpose(3, 2, 0, 1))
    assert tuple(g.conv1[1].weight.shape) == (1,)


def test_matches_reference_torch_model():
    """The port's f32 generator == tests/reference_impls.TorchSRResNet
    loading the same state_dict (the reference's own layer order: shuffle
    before PReLU). atol 1e-5: the same torch convs, other layouts."""
    from tests.reference_impls import TorchSRResNet

    sd = generator_state_dict_from_variables(
        random_variables(4, channels=16, num_rcb=2, upscale=4))
    ref = TorchSRResNet(channels=16, num_rcb=2, upscale=4).eval()
    ref.load_state_dict(sd)
    g = Generator(channels=16, num_rcb=2, upscale=4).eval()
    g.load_state_dict(sd)
    lr = torch.from_numpy(np.random.default_rng(5).random((2, 12, 10, 3), np.float32))
    with torch.inference_mode():
        want = ref(lr.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        got = g(lr)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_load_params_npz_reads_jax_file(tmp_path):
    from srgan_st_tpu.train.checkpoint import save_variables_npz as jax_save
    from srgan_st_tpu_torch.train.checkpoint import load_params_npz, save_variables_npz

    variables = random_variables(6, channels=16, num_rcb=1, upscale=2)
    jax_save(str(tmp_path / "g_best.npz"), variables)
    loaded = load_params_npz(str(tmp_path / "g_best.npz"))
    sd_a = generator_state_dict_from_variables(loaded)
    sd_b = generator_state_dict_from_variables(variables)
    assert set(sd_a) == set(sd_b)
    for k in sd_a:
        assert torch.equal(sd_a[k], sd_b[k]), k
    # and the port's writer is byte-for-byte the same archive layout
    save_variables_npz(str(tmp_path / "port.npz"), variables)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "g_best.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_load_params_npz_with_target_keeps_mismatched(tmp_path):
    """The tolerant loader: a key whose shape differs from the target's
    keeps the target's value, as in the JAX package."""
    from srgan_st_tpu.train.checkpoint import load_params_npz as jax_load
    from srgan_st_tpu_torch.train.checkpoint import load_params_npz, save_variables_npz

    src = {"params": {"a": np.ones(3, np.float32), "b": np.ones(2, np.float32)}}
    tgt = {"params": {"a": np.zeros(3, np.float32), "b": np.zeros(4, np.float32),
                      "c": np.zeros(1, np.float32)}}
    path = str(tmp_path / "w.npz")
    save_variables_npz(path, src)
    got, want = load_params_npz(path, tgt), jax_load(path, tgt)
    for k in ("a", "b", "c"):
        np.testing.assert_array_equal(got["params"][k], np.asarray(want["params"][k]))


def test_unported_modes_raise():
    """Train mode runs, with the trunks "fused" (K6) and "xpack" ("packed"
    in training, here outside its gate) too; no
    trunk mode is left unported: "xpack_eval" raises in a train step only
    (the JAX ValueError), and an unknown mode raises at construction."""
    g = Generator(channels=16, num_rcb=1, upscale=2)
    x = torch.zeros(1, 4, 4, 3)
    assert g(x, train=True).shape == (1, 8, 8, 3)
    for mode in ("fused", "xpack"):
        assert Generator(channels=16, num_rcb=1, upscale=2,
                         trunk_mode=mode)(x, train=True).shape == (1, 8, 8, 3)
    with pytest.raises(ValueError, match="eval-only"):
        Generator(channels=16, num_rcb=1, upscale=2, trunk_mode="xpack_eval")(x, train=True)
    with pytest.raises(ValueError, match="unknown trunk_mode"):
        Generator(channels=16, num_rcb=1, upscale=2, trunk_mode="xpack2")
