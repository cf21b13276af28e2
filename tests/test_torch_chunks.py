"""The port's chunked training loops, REMAT and the capture-safety pieces of
the CUDA graph steps, on the CPU (where steps run eagerly: the CPU has no
graphs, and these tests ask for it).

Small configs, as the trajectory goldens': a 2 RCB / 16 ch G and a 4 ch D.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import torch_threads  # noqa: F401  (this process's share of the cores)


# ---------------------------------------------------------------------------
# resolve_chunk_steps

@pytest.mark.parametrize("chunk_steps", [None, 1, 3, 64, 250])
def test_resolve_chunk_steps_matches_jax(chunk_steps, capsys):
    """The chunk size and the line printed when an override is cut to a
    divisor of the interval equal the JAX package's, over the grid."""
    from srgan_st_tpu.core.config import Config as JaxConfig
    from srgan_st_tpu.train.utils import resolve_chunk_steps as jax_resolve
    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.train.utils import resolve_chunk_steps

    jcfg, cfg = JaxConfig(), Config()
    jcfg.TPU.CHUNK_STEPS = cfg.TPU.CHUNK_STEPS = chunk_steps
    for interval in (1, 2, 100):
        for spe in (1, 7, 100, 1000):
            capsys.readouterr()
            want = jax_resolve(jcfg, interval, spe)
            want_out = capsys.readouterr().out
            got = resolve_chunk_steps(cfg, interval, spe)
            assert got == want, (interval, spe)
            assert capsys.readouterr().out == want_out, (interval, spe)


def test_iter_chunks_groups_the_epoch():
    from srgan_st_tpu_torch.data.pipeline import SyntheticPatchSource
    from srgan_st_tpu_torch.train.utils import iter_chunks

    src = SyntheticPatchSource(2, 8, n_batches=7, seed=0)
    want = list(SyntheticPatchSource(2, 8, n_batches=7, seed=0).epoch(0))
    chunks = list(iter_chunks(src, 0, 3))
    assert [len(c) for c in chunks] == [3, 3, 1]
    assert all(np.array_equal(a, b) for a, b in zip([b for c in chunks for b in c], want))


# ---------------------------------------------------------------------------
# the chunked loops against per-batch stepping

INTERVAL = 4  # D_UPDATE_INTERVAL of train(), LOG_TRAIN_PERIOD of warmup()
N_BATCHES = 7


def _loop_config(phase: str, chunk_steps):
    from srgan_st_tpu_torch.core.config import Config, apply_overrides

    cfg = apply_overrides(Config(), [
        "DATA.SYNTHETIC=true", f"DATA.SYNTHETIC_N_BATCHES={N_BATCHES}", "DATA.BATCH_SIZE=2",
        "MODEL.G_N_RCB=2", "MODEL.G_N_CHANNEL=16",
        "MODEL.D_N_CHANNEL=4", "EXP.N_EPOCHS=1", "EXP.NAME=chunks",
        "SCHEDULER.MILESTONES=[0]"])  # the lr halves within the run
    cfg.TPU.CHUNK_STEPS = chunk_steps
    if phase == "train":
        cfg.SOLVER.D_UPDATE_INTERVAL = INTERVAL
    else:
        cfg.LOG_TRAIN_PERIOD = INTERVAL
    return cfg


def _per_batch(phase: str):
    """The same run stepped one batch at a time with the eager steps: D on
    every INTERVAL-th batch (the loops' semantics before chunking)."""
    from srgan_st_tpu_torch.data.pipeline import make_train_source
    from srgan_st_tpu_torch.losses.registry import build_criterions, build_warmup_criterions
    from srgan_st_tpu_torch.models.discriminator import Discriminator
    from srgan_st_tpu_torch.models.generator import Generator
    from srgan_st_tpu_torch.parallel.mesh import make_mesh
    from srgan_st_tpu_torch.train.steps import (
        create_gan_state, create_generator_state, make_gan_steps, make_warmup_step,
    )

    cfg = _loop_config(phase, None)
    mesh = make_mesh(cfg)
    source = make_train_source(cfg, device="cpu")
    if phase == "warmup":
        state = create_generator_state(cfg, Generator.from_config(cfg, group=mesh),
                                       len(source), "cpu", milestones=False)
        step = make_warmup_step(cfg, build_warmup_criterions(cfg), mesh)
        for gt in source.epoch(0):
            state, _ = step(state, gt)
        return state
    state = create_gan_state(cfg, Generator.from_config(cfg, group=mesh),
                             Discriminator.from_config(cfg, group=mesh), len(source), "cpu")
    g_step, d_step = make_gan_steps(cfg, build_criterions(cfg), mesh)
    for i, gt in enumerate(source.epoch(0)):
        state, sr, _ = g_step(state, gt)
        if i % INTERVAL == 0:
            state, _ = d_step(state, gt, sr)
    return state


def _tensors(state) -> dict:
    out = {}
    for tag, model, opt in (("g", state.g_model, state.g_opt), ("d", state.d_model, state.d_opt)):
        if model is None:
            continue
        out.update({f"{tag}/{k}": v for k, v in model.state_dict().items()})
        sd = opt.state_dict()
        out[f"{tag}/count"] = torch.tensor(sd["count"])
        out[f"{tag}/lr"] = torch.tensor([g["lr"] for g in sd["opt"]["param_groups"]])
        for i, st in sd["opt"]["state"].items():
            out.update({f"{tag}/adam{i}/{k}": v for k, v in st.items()})
    return out


@pytest.mark.parametrize("phase", ["warmup", "train"])
def test_chunked_loops_equal_per_batch_stepping(phase, tmp_path, monkeypatch, capsys):
    """warmup() and train() with CHUNK_STEPS None (the interval, 4), 1, 2 (a
    divisor) and 3 (a non-divisor, cut to 1) end with the parameters,
    running statistics and optimizer state of per-batch stepping, bit for
    bit (f32): the D update stays on every 4th batch."""
    from srgan_st_tpu_torch.train.train import train
    from srgan_st_tpu_torch.train.warmup import warmup

    want = _tensors(_per_batch(phase))
    run = warmup if phase == "warmup" else train
    for chunk_steps in (None, 1, 2, 3):
        os.makedirs(tmp_path / str(chunk_steps), exist_ok=True)
        monkeypatch.chdir(tmp_path / str(chunk_steps))
        state = run(_loop_config(phase, chunk_steps), device="cpu")
        assert state.step == N_BATCHES
        got = _tensors(state)
        assert got.keys() == want.keys()
        differ = [k for k in want if not torch.equal(got[k], want[k])]
        assert not differ, (chunk_steps, differ[:5])
    out = capsys.readouterr().out
    assert "TPU.CHUNK_STEPS=3 does not divide the interval 4; using 1" in out


def _write_scalars_run(package: str, phase: str, tmp_path, weights: dict) -> list:
    """Run `phase` of `package` ("jax" or "torch") with the scalars forced
    to scalars.jsonl; returns its rows (tag, step, value)."""
    from srgan_st_tpu.core.config import Config as JaxConfig
    from srgan_st_tpu_torch.core.config import Config

    cfg = (JaxConfig if package == "jax" else Config)()
    cfg.EXP.NAME = f"{package}-{phase}"
    cfg.EXP.N_EPOCHS = 1
    cfg.DATA.SYNTHETIC = True
    cfg.DATA.SYNTHETIC_N_BATCHES = 6
    cfg.DATA.BATCH_SIZE = 8
    cfg.MODEL.G_N_RCB, cfg.MODEL.G_N_CHANNEL, cfg.MODEL.D_N_CHANNEL = 2, 16, 4
    cfg.MODEL.G_LOSS.CRITERIONS = {"Adversarial": {"kind": "adversarial"},
                                   "Pixel": {"kind": "pixel", "criterion": "mse"}}
    cfg.SOLVER.D_UPDATE_INTERVAL = 2
    cfg.LOG_TRAIN_PERIOD = 2
    cfg.TPU.CHUNK_STEPS = 2 if phase == "warmup" else None
    if phase == "train":
        cfg.MODEL.G_CONTINUE_FROM_WARMUP = cfg.MODEL.D_CONTINUE_FROM_WARMUP = True
        cfg.MODEL.G_WARMUP_WEIGHTS, cfg.MODEL.D_WARMUP_WEIGHTS = weights["g"], weights["d"]
    if package == "jax":
        from srgan_st_tpu.train.train import train
        from srgan_st_tpu.train.warmup import warmup

        (warmup if phase == "warmup" else train)(cfg)
    else:
        from srgan_st_tpu_torch.train.train import train
        from srgan_st_tpu_torch.train.warmup import warmup

        (warmup if phase == "warmup" else train)(cfg, device="cpu")
    with open(os.path.join("tensorboard", cfg.EXP.NAME, "scalars.jsonl")) as f:
        return [(r["tag"], r["step"], r["value"]) for r in map(json.loads, f)]


@pytest.mark.parametrize("phase", ["warmup", "train"])
def test_scalar_rows_match_jax_chunked_loops(phase, tmp_path, monkeypatch):
    """The scalars.jsonl rows (tags and steps) of the port's
    chunked warmup() and train() equal the JAX package's for the same
    config: the log rows at chunk starts, D's values carried to the rows
    between D updates. train() starts both packages from the same npz G
    and D (the warm-start flags) on the same synthetic patches, so its
    Train/ values match too, within the trajectory tests' first-steps
    bounds (2e-3 relative for G's, 5e-3 for D's)."""
    from srgan_st_tpu_torch.models.discriminator import Discriminator
    from srgan_st_tpu_torch.models.generator import random_variables
    from srgan_st_tpu_torch.train.checkpoint import (
        save_variables_npz, variables_from_discriminator_state_dict,
    )

    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(sys.modules, "tensorboardX", None)  # the jsonl writer
    weights = {"g": str(tmp_path / "g.npz"), "d": str(tmp_path / "d.npz")}
    save_variables_npz(weights["g"], random_variables(0, channels=16, num_rcb=2))
    save_variables_npz(weights["d"], variables_from_discriminator_state_dict(
        Discriminator(channels=4).state_dict()))
    rows = {p: _write_scalars_run(p, phase, tmp_path, weights) for p in ("jax", "torch")}
    # the same (tag, step) rows, step by step; within a step JAX writes its
    # metrics in its pytree's sorted key order
    assert [r[1] for r in rows["torch"]] == [r[1] for r in rows["jax"]]
    assert sorted(r[:2] for r in rows["torch"]) == sorted(r[:2] for r in rows["jax"])
    rows = {p: sorted(r) for p, r in rows.items()}
    steps = sorted({s for t, s, _ in rows["jax"] if t.startswith("Train/")})
    assert steps == ([1, 3, 5] if phase == "warmup" else [0, 2, 4])
    if phase == "train":
        for (tag, step, got), (_, _, want) in zip(rows["torch"], rows["jax"]):
            if tag.startswith("Train/"):
                rtol = 5e-3 if tag.startswith("Train/D") else 2e-3
                assert abs(got - want) <= rtol * abs(want), (tag, step, got, want)


# ---------------------------------------------------------------------------
# REMAT

def _g_grads(remat: bool, variables, lr):
    from srgan_st_tpu_torch.models.generator import Generator
    from srgan_st_tpu_torch.train.checkpoint import generator_state_dict_from_variables

    g = Generator(channels=16, num_rcb=2, trunk_mode="unfused", remat=remat)
    g.load_state_dict(generator_state_dict_from_variables(variables))
    y = g(torch.from_numpy(lr), train=True)
    (y.float() ** 2).sum().backward()
    return g, y


def test_remat_gradients_equal_without_remat_bit_for_bit():
    """f32 on the CPU: the output, every parameter gradient and the running
    statistics (moved once, not again by the recomputation) are the same
    bits with and without REMAT."""
    from srgan_st_tpu_torch.models.generator import random_variables

    variables = random_variables(0, channels=16, num_rcb=2)
    lr = np.random.default_rng(1).random((2, 8, 10, 3), np.float32)
    g0, y0 = _g_grads(False, variables, lr)
    g1, y1 = _g_grads(True, variables, lr)
    assert torch.equal(y0, y1)
    for (name, p0), p1 in zip(g0.named_parameters(), g1.parameters()):
        assert torch.equal(p0.grad, p1.grad), name
    for (name, b0), b1 in zip(g0.named_buffers(), g1.buffers()):
        assert torch.equal(b0, b1), name


def test_remat_generator_matches_jax_remat():
    """The port's REMAT generator against the JAX Generator with
    remat=True on shared weights (f32): the output within the f32
    generator-parity bound (1e-5) and the gradients of sum(y^2) within
    1e-4 of their largest magnitude."""
    from srgan_st_tpu.models.generator import Generator as JaxGenerator
    from srgan_st_tpu_torch.models.generator import random_variables
    from srgan_st_tpu_torch.train.checkpoint import variables_from_generator_state_dict

    variables = random_variables(0, channels=16, num_rcb=2)
    lr = np.random.default_rng(1).random((2, 8, 10, 3), np.float32)
    jg = JaxGenerator(channels=16, num_rcb=2, trunk_mode="unfused", remat=True)

    def loss(params):
        y, _ = jg.apply({"params": params, "batch_stats": variables["batch_stats"]},
                        jnp.asarray(lr), train=True, mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) ** 2), y

    (_, want_y), want = jax.value_and_grad(loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    g, y = _g_grads(True, variables, lr)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), atol=1e-5)
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in g.named_parameters()}
    got = variables_from_generator_state_dict({**g.state_dict(), **grads})["params"]
    flat_got = jax.tree_util.tree_leaves(got)
    flat_want = jax.tree_util.tree_leaves(jax.device_get(want))
    assert len(flat_got) == len(flat_want)
    for a, b in zip(flat_got, flat_want):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, atol=1e-4 * max(float(np.abs(b).max()), 1e-6))


def test_remat_is_off_the_kernel_trunks():
    """REMAT wraps only the unfused blocks: a packed trunk keeps its saved
    residuals (the CPU runs the packed trunk's plain version)."""
    from srgan_st_tpu_torch.core.config import Config, apply_overrides
    from srgan_st_tpu_torch.models import generator as G

    calls = []
    real = G.remat_block
    G.remat_block = lambda *a: calls.append(1) or real(*a)
    try:
        cfg = apply_overrides(Config(), ["TPU.REMAT=true", "MODEL.G_N_RCB=2",
                                         "TPU.COMPUTE_DTYPE=bfloat16"])
        g = G.Generator.from_config(cfg)
        assert g.remat
        g(torch.rand(2, 8, 8, 3), train=True)  # bf16 training: "packed"
        assert not calls
        g.trunk_mode = "unfused"
        g(torch.rand(2, 8, 8, 3), train=True)
        assert len(calls) == 2
    finally:
        G.remat_block = real


# ---------------------------------------------------------------------------
# the pieces of the graph steps that the CPU reaches

def test_graphs_are_off_on_the_cpu_and_refuse_gloo(monkeypatch):
    """No graphs on the CPU. A CUDA run whose group's collectives a graph
    cannot capture (gloo) raises, naming the key."""
    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.parallel import mesh as M
    from srgan_st_tpu_torch.train.graphs import step_graphs

    assert step_graphs(Config(), "cpu") is None
    monkeypatch.setattr(M.dist, "get_backend", lambda *a: "gloo")
    with pytest.raises(ValueError, match="TPU.CUDA_GRAPHS=false"):
        M.DataParallel(2, 0).require_capturable("TPU.CUDA_GRAPHS")
    M.DataParallel(1, 0).require_capturable("TPU.CUDA_GRAPHS")  # one process: none
    monkeypatch.setattr(M.dist, "get_backend", lambda *a: "nccl")
    M.DataParallel(2, 0).require_capturable("TPU.CUDA_GRAPHS")


def test_launch_counts_add_replays():
    """A capture takes its launches back, a replay adds them, and the
    replayed part is counted apart."""
    from srgan_st_tpu_torch import kernels
    from srgan_st_tpu_torch.kernels import packed_trunk

    kernels.reset_launch_counts()
    packed_trunk.fwd_launches += 1  # a capture's launch: nothing ran
    kernels.add_launch_counts({"packed_trunk_fwd": -1})
    for _ in range(3):
        kernels.add_launch_counts({"packed_trunk_fwd": 1}, replayed=True)
    assert kernels.launch_counts()["packed_trunk_fwd"] == 3
    assert kernels.graph_launch_counts()["packed_trunk_fwd"] == 3
    kernels.reset_launch_counts()
    assert kernels.graph_launch_counts()["packed_trunk_fwd"] == 0


def test_layout_caches_key_on_the_replay_generation():
    """A replay updates the weights without bumping their version: the
    layout caches of kernel A and kernel B make their layouts again after
    `kernels.generation` moves."""
    from srgan_st_tpu_torch import kernels
    from srgan_st_tpu_torch.kernels.coarse_conv import KernelWeights
    from srgan_st_tpu_torch.kernels.serving_tail import TailWeights

    w = torch.randn(3, 16, 9, 9)
    cache = KernelWeights()
    first = cache.get(w, torch.float32)
    assert cache.get(w, torch.float32) is first
    kernels.generation += 1
    assert cache.get(w, torch.float32) is not first
    w_up, b_up, w3 = torch.randn(3, 3, 64, 256), torch.randn(256), torch.randn(9, 9, 64, 3)
    tail = TailWeights()
    lay = tail.get(w_up, b_up, 0.25, w3, "cpu", torch.float32)
    assert tail.get(w_up, b_up, 0.25, w3, "cpu", torch.float32) is lay
    kernels.generation += 1
    assert tail.get(w_up, b_up, 0.25, w3, "cpu", torch.float32) is not lay


def test_step_constants_are_made_once():
    """The degradation's resize matrices, the structure tensor's taps and
    the coarse kernel's gather indices are made once per (shape, dtype,
    device) and then shared: a step makes no host-to-device copy."""
    from srgan_st_tpu_torch.core import device as D
    from srgan_st_tpu_torch.ops.resize import resize_bicubic
    from srgan_st_tpu_torch.ops.structure_tensor import structure_tensor_patches
    from srgan_st_tpu_torch.ops.subpixel_conv import _coarse_kernel

    x = torch.rand(1, 12, 12, 3)
    resize_bicubic(x, 0.25)
    _coarse_kernel(torch.rand(9, 9, 2, 3), 2)
    structure_tensor_patches(torch.rand(2, 7, 7))
    n = len(D._CONSTANTS)
    kept = dict(D._CONSTANTS)
    resize_bicubic(x, 0.25)
    _coarse_kernel(torch.rand(9, 9, 2, 3), 2)
    structure_tensor_patches(torch.rand(2, 7, 7))
    assert len(D._CONSTANTS) == n
    assert all(D._CONSTANTS[k] is v for k, v in kept.items())
    assert any(k[0][0] == "resize" for k in D._CONSTANTS)


def test_adam_state_dict_keeps_its_format():
    """The optimizer's state dict keeps its format: the update count an
    int, each group's lr a float (on CUDA both live on the device)."""
    from srgan_st_tpu_torch.train.steps import make_optimizer

    p = torch.nn.Parameter(torch.ones(3))
    opt = make_optimizer([p], 0.1, 0.9, 0.999, 1e-4, 0.0, [1], 0.5)
    for _ in range(2):
        opt.step([torch.ones(3)])
    sd = opt.state_dict()
    assert sd["count"] == 2 and isinstance(sd["count"], int)
    assert sd["opt"]["param_groups"][0]["lr"] == 0.05
    opt2 = make_optimizer([torch.nn.Parameter(torch.ones(3))], 0.1, 0.9, 0.999, 1e-4,
                          0.0, [1], 0.5)
    opt2.load_state_dict(sd)
    assert opt2.count == 2
