"""The rows that `srgan_st_tpu_torch/tools/profile_step.py` profiles against
the JAX package's bench.py on the CPU: the rows' configs, one chunk of the
headline row at a small size against JAX's chunk step, the serving row's
feedback chain, and `main` refusing to run off the card. bench.py imports
only numpy at module level.

Small sizes, as the trajectory goldens': a 2 RCB / 16 ch G and a 4 ch D,
chunks of k = 2 batches of 2, f32 (BENCH_DTYPE=float32).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_threads  # noqa: F401  (this process's share of the cores)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import bench as jax_bench  # noqa: E402

from srgan_st_tpu_torch.tools import profile_step  # noqa: E402


def _shrink(config):
    config.MODEL.G_N_RCB, config.MODEL.G_N_CHANNEL, config.MODEL.D_N_CHANNEL = 2, 16, 4
    config.SOLVER.D_UPDATE_INTERVAL = 2
    return config


# ---------------------------------------------------------------------------
# the rows' configs

@pytest.mark.parametrize("name,vgg_pair", [
    ("headline", None), ("flagship-st", None), ("flagship-st-xla", None),
    ("gram-vgg", None), ("gram-vgg", "1"), ("gram-vgg", "0")])
def test_make_config_matches_bench_py(name, vgg_pair, monkeypatch):
    """Each training row's criteria (names, order, specs) and weights equal
    bench.py's `_make_config`, BENCH_VGG_PAIR included; "pallas" keeps its
    name and meaning (False: the plain selection)."""
    if vgg_pair is None:
        monkeypatch.delenv("BENCH_VGG_PAIR", raising=False)
    else:
        monkeypatch.setenv("BENCH_VGG_PAIR", vgg_pair)
    got, want = profile_step.make_config(name), jax_bench._make_config(name)
    g, w = got.MODEL.G_LOSS, want.MODEL.G_LOSS
    assert list(g.CRITERIONS.items()) == list(w.CRITERIONS.items())
    assert dict(g.CRITERION_WEIGHTS) == dict(w.CRITERION_WEIGHTS)
    if name == "flagship-st-xla":
        assert g.CRITERIONS["PatchwiseST"]["pallas"] is False


def test_make_config_rejects_an_unknown_row():
    with pytest.raises(ValueError):
        profile_step.make_config("infer-4k")
    with pytest.raises(ValueError):
        jax_bench._make_config("infer-4k")


# ---------------------------------------------------------------------------
# one chunk of the headline row against JAX's chunk step

def _jax_headline(k):
    from srgan_st_tpu.losses.registry import build_criterions
    from srgan_st_tpu.models.discriminator import Discriminator
    from srgan_st_tpu.models.generator import Generator
    from srgan_st_tpu.train import steps as S

    config = _shrink(jax_bench._make_config("headline"))
    config.TPU.COMPUTE_DTYPE = "float32"
    config.DATA.BATCH_SIZE = 2
    g, d = Generator.from_config(config), Discriminator.from_config(config)
    g_tx, d_tx = S.make_g_optimizer(config, 1000), S.make_d_optimizer(config, 1000)
    state = S.create_gan_state(config, g, d, g_tx, d_tx)
    chunk_fn = jax.jit(S.make_gan_chunk_step(config, g, d, build_criterions(config), g_tx, d_tx),
                       static_argnums=2)
    assert config.SOLVER.D_UPDATE_INTERVAL == k
    return state, chunk_fn


def test_headline_chunk_matches_jax_chunk_step(monkeypatch):
    """One chunk of the headline row as profile_step builds it (k = 2
    batches of 2, D at the chunk's start) from JAX's initial state, carried
    across by train/checkpoint.py's mappings, on bench.py's seeded chunk: batch 0's
    metrics within the chunk parity tests' bounds (tests/test_torch_chunks.py:
    2e-3 relative for G's, 5e-3 for D's), and G's and D's parameters and
    running statistics after the chunk within the f32 GAN step bounds of
    tests/test_torch_train.py (atol 5e-5, rtol 1e-4)."""
    from srgan_st_tpu_torch.parallel.mesh import make_mesh
    from srgan_st_tpu_torch.train.checkpoint import (
        discriminator_state_dict_from_variables, generator_state_dict_from_variables,
        variables_from_discriminator_state_dict, variables_from_generator_state_dict,
    )

    monkeypatch.setenv("BENCH_DTYPE", "float32")
    for knob in ("BENCH_TRUNK", "BENCH_CONV3"):
        monkeypatch.delenv(knob, raising=False)
    k = 2
    jstate, chunk_fn = _jax_headline(k)
    config = _shrink(profile_step.make_config("headline"))
    assert profile_step.apply_bench_knobs(config) == "float32"
    config.DATA.BATCH_SIZE = 2
    dev, mesh = torch.device("cpu"), make_mesh(config)
    state, chunk_step, graphs = profile_step.build_gan(config, dev, mesh)
    assert graphs is None  # the CPU has no graphs: eager steps
    g_vars = jax.device_get({"params": jstate.g_params, "batch_stats": jstate.g_stats})
    d_vars = jax.device_get({"params": jstate.d_params, "batch_stats": jstate.d_stats})
    state.g_model.load_state_dict(generator_state_dict_from_variables(g_vars))
    state.d_model.load_state_dict(discriminator_state_dict_from_variables(d_vars))

    chunk = profile_step.bench_chunk(config, dev, mesh)
    want_chunk = np.random.default_rng(0).integers(0, 256, (k, 2, 96, 96, 3), np.uint8)
    np.testing.assert_array_equal(chunk.numpy(), want_chunk)

    jstate, jm = chunk_fn(jstate, jnp.asarray(want_chunk), True)
    state, m = chunk_step(state, chunk, True)
    assert state.step == k
    assert set(m) == set(jm)
    for key, want in jm.items():
        rtol = 5e-3 if key.startswith("D") else 2e-3
        assert abs(float(m[key]) - float(want)) <= rtol * abs(float(want)), key
    for got, want in (
            (variables_from_generator_state_dict(state.g_model.state_dict()),
             {"params": jstate.g_params, "batch_stats": jstate.g_stats}),
            (variables_from_discriminator_state_dict(state.d_model.state_dict()),
             {"params": jstate.d_params, "batch_stats": jstate.d_stats})):
        want = jax.device_get(want)
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
        for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), atol=5e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# the serving row's feedback chain

def test_infer_chain_next_input_matches_jax(monkeypatch):
    """infer-4k's generator and feedback chain on a 24x24 LR frame (full
    width, f32): bench.py's seeded frame and noise, then two steps (frames
    5 and 6, so the 1e-7 i term is not 0) equal JAX's step (bench.py:346-356)
    on the same weights, to 1e-5."""
    from srgan_st_tpu.core.config import Config as JaxConfig
    from srgan_st_tpu.models.generator import Generator as JaxGenerator
    from srgan_st_tpu_torch.models.generator import random_variables

    monkeypatch.setenv("BENCH_DTYPE", "float32")
    step, lr, noise, dev, s = profile_step.infer_setup("cpu", (24, 24))
    assert s == 4 and dev.type == "cpu" and lr.dtype == torch.float32
    rng = np.random.default_rng(0)
    want_lr = rng.random((1, 24, 24, 3), np.float32)
    want_noise = rng.random((8, 1, 24, 24, 3), np.float32)
    np.testing.assert_array_equal(lr.numpy(), want_lr)
    np.testing.assert_array_equal(noise.numpy(), want_noise)

    config = JaxConfig()
    config.TPU.COMPUTE_DTYPE = "float32"
    g_model = JaxGenerator.from_config(config)
    variables = jax.tree_util.tree_map(jnp.asarray, random_variables(0))

    @jax.jit
    def jstep(v, x, z, i):
        sr = g_model.apply(v, x, train=False)
        b, hh, ww, c = sr.shape
        pooled = sr.reshape(b, hh // s, s, ww // s, s, c).mean((2, 4))
        return (0.5 * pooled + 0.5 * z + 1e-7 * i).astype(x.dtype)

    x, jx = lr, jnp.asarray(want_lr)
    with torch.inference_mode():
        for n in (5, 6):
            x = step(x, n)
            jx = jstep(variables, jx, jnp.asarray(want_noise[n % 8]), jnp.float32(n))
            assert x.dtype == torch.float32 and x.shape == (1, 24, 24, 3)
            np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-5, rtol=0)


def test_next_lr_keeps_the_input_dtype_and_adds_the_f32_index_term():
    """The chain's output takes x's dtype (no cast of the input per frame)
    and its index term is f32(1e-7) * f32(i), as JAX computes it."""
    sr = torch.zeros(1, 8, 8, 3)
    z = torch.zeros(1, 2, 2, 3)
    for dtype in (torch.float32, torch.bfloat16):
        out = profile_step.next_lr(sr, torch.zeros(1, 2, 2, 3, dtype=dtype), z, 3, 4)
        assert out.dtype == dtype and out.shape == (1, 2, 2, 3)
    term = profile_step.next_lr(sr, torch.zeros(1, 2, 2, 3), z, 12345, 4)
    assert float(term[0, 0, 0, 0]) == float(np.float32(1e-7) * np.float32(12345))


# ---------------------------------------------------------------------------
# the card only

@pytest.mark.parametrize("name", ["headline", "flagship-st", "flagship-st-xla", "gram-vgg",
                                  "warmup", "infer-4k"])
def test_profile_step_without_cuda_raises(name, monkeypatch, capsys):
    """With no GPU, main raises before any row is built, whatever the
    row: nothing falls back to the CPU and nothing is printed."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for run in ("run_and_trace", "run_and_trace_infer"):
        monkeypatch.setattr(profile_step, run, lambda *a, **k: pytest.fail("ran"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_step.main([name])
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("line,want", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", {"name": "NVIDIA H100 80GB HBM3",
                                         "power_limit_w": 700.0}),
    ("NVIDIA H100 80GB HBM3, [N/A]", {"name": "NVIDIA H100 80GB HBM3",
                                      "power_limit_w": None})])
def test_device_record_reads_nvidia_smi(line, want, monkeypatch):
    """A CUDA device's record is nvidia-smi's name and power limit for
    that card; the CPU's names the CPU."""
    import subprocess

    from srgan_st_tpu_torch.utils import profiling

    calls = []

    def run(cmd, **kw):
        calls.append(cmd)
        return subprocess.CompletedProcess(cmd, 0, stdout=line + "\n", stderr="")

    monkeypatch.setattr(profiling.subprocess, "run", run)
    assert profiling.device_record(torch.device("cuda:0")) == want
    assert calls[0][:2] == ["nvidia-smi", "--id=0"]
    assert "--query-gpu=name,power.limit" in calls[0]
    assert profiling.device_record("cpu") == {"name": "cpu", "power_limit_w": None}
