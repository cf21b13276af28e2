"""The port's multi-process training and tiled eval, on the CPU over gloo.

Two real processes (torch.distributed, gloo, the SRGAN_ST_* launch
variables) run the same steps as one process on the global batch and as
the JAX package's explicit shard_map step on a 2-device mesh. Sizes are
those of the trajectory goldens (a 2 RCB / 16 ch G, a 4 ch D). Each
subprocess has its own timeout; a rank that fails fails the test.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.torch_threads import started_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-4
GLOBAL_BATCH = 2

# The steps each case runs, as source shared by the parent (one process)
# and the children (two): one warmup step on one state, and a G step, a D
# step and a G step on another from the same weights (test_torch_train.py's
# GAN sequence); every gradient the optimizers apply is kept.
_STEPS = textwrap.dedent('''
    import numpy as np
    import torch

    def run_steps(sets, gts, g_sd, d_sd, group):
        from srgan_st_tpu_torch.core.config import Config, apply_overrides
        from srgan_st_tpu_torch.losses.registry import build_criterions, build_warmup_criterions
        from srgan_st_tpu_torch.models.discriminator import Discriminator
        from srgan_st_tpu_torch.models.generator import Generator
        from srgan_st_tpu_torch.train.steps import (
            GANTrainState, make_d_optimizer, make_g_optimizer, make_gan_steps,
            make_warmup_step)

        cfg = apply_overrides(Config(), sets)
        sl = group.batch_slice(cfg.DATA.BATCH_SIZE)
        grads = []

        def state_from(g_sd, d_sd=None):
            g = Generator.from_config(cfg, group=group)
            g.load_state_dict(g_sd)
            state = GANTrainState(g, make_g_optimizer(cfg, g.parameters(), 10))
            if d_sd is not None:
                state.d_model = Discriminator.from_config(cfg, group=group)
                state.d_model.load_state_dict(d_sd)
                state.d_opt = make_d_optimizer(cfg, state.d_model.parameters(), 10)
            for opt in (state.g_opt, state.d_opt):
                if opt is not None:
                    def capture(gs, _step=opt.step):
                        grads.append([t.detach().float().clone() for t in gs])
                        _step(gs)
                    opt.step = capture
            return state

        warm = make_warmup_step(cfg, build_warmup_criterions(cfg), group)
        g_step, d_step = make_gan_steps(cfg, build_criterions(cfg), group)
        losses = {}
        w_state, m = warm(state_from(g_sd), gts[0][sl])
        losses.update({"warm/" + k: float(v) for k, v in m.items()})
        state, sr, m = g_step(state_from(g_sd, d_sd), gts[1][sl])
        losses.update({"g1/" + k: float(v) for k, v in m.items()})
        state, m = d_step(state, gts[1][sl], sr)
        losses.update({"d/" + k: float(v) for k, v in m.items()})
        state, _, m = g_step(state, gts[2][sl])
        losses.update({"g2/" + k: float(v) for k, v in m.items()})
        state.w_model = w_state.g_model
        return losses, grads, state
''')

_CHILD = textwrap.dedent('''
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist

    from srgan_st_tpu_torch.parallel.distributed import initialize_distributed, process_info
    from srgan_st_tpu_torch.parallel.mesh import make_mesh

    work = sys.argv[1]
    assert initialize_distributed(device="cpu")
    assert initialize_distributed(device="cpu")  # idempotent
    assert dist.get_backend() == "gloo"
    rank, world = process_info()
    assert world == 2
    exec(open(os.path.join(work, "steps.py")).read())
    inp = np.load(os.path.join(work, "inputs.npz"))
    sd = lambda prefix: {k[len(prefix):]: torch.from_numpy(inp[k]) for k in inp.files
                         if k.startswith(prefix)}
    group = make_mesh()
    out = {}
    for case in json.loads(str(inp["cases"])):
        sets = json.loads(str(inp["sets/" + case]))
        losses, grads, state = run_steps(sets, inp["gts"], sd("g/"), sd("d/"), group)
        out[case + "/losses"] = json.dumps(losses)
        for i, gl in enumerate(grads):
            out[f"{case}/grad{i}"] = torch.cat([t.reshape(-1) for t in gl]).numpy()
        for name, m in (("w", state.w_model), ("g", state.g_model), ("d", state.d_model)):
            for k, v in m.state_dict().items():
                out[f"{case}/{name}/{k}"] = v.detach().float().numpy()

    # EXP.ORBAX_CHECKPOINTS: the collective DCP save of the last case's GAN
    # state from both ranks into one directory (rank 1 passes NaN metrics,
    # as it does not validate), then both restore `last` into a fresh state
    from srgan_st_tpu_torch.core.config import Config, apply_overrides
    from srgan_st_tpu_torch.models.common import init_weights
    from srgan_st_tpu_torch.models.discriminator import Discriminator
    from srgan_st_tpu_torch.models.generator import Generator
    from srgan_st_tpu_torch.train.checkpoint import CheckpointPolicy, train_state_arrays
    from srgan_st_tpu_torch.train.steps import (
        GANTrainState, make_d_optimizer, make_g_optimizer)

    state.step = 3
    policy = CheckpointPolicy(os.path.join(work, "ckpt"), use_orbax=True)
    assert policy.collective
    psnr, ssim = (20.0, 0.5) if rank == 0 else (float("nan"), float("nan"))
    out["ckpt/is_best"] = np.array(policy.save_epoch(state, 0, psnr, ssim))
    cfg = apply_overrides(Config(), sets)
    g, d = Generator.from_config(cfg, group=group), Discriminator.from_config(cfg, group=group)
    init_weights(g, torch.Generator().manual_seed(11))
    init_weights(d, torch.Generator().manual_seed(12))
    fresh = GANTrainState(g, make_g_optimizer(cfg, g.parameters(), 10), d,
                          make_d_optimizer(cfg, d.parameters(), 10))
    out["ckpt/restored"] = np.array(policy.restore_latest(fresh))
    saved, got = train_state_arrays(state), train_state_arrays(fresh)
    out.update({"ckpt/saved/" + k: v for k, v in saved.items()})
    out.update({"ckpt/got/" + k: v for k, v in got.items()})

    # a collective save of a changed state that fails partway on rank 1 (its
    # DCP writer raises at its third item): both ranks see the exception, the
    # old `last/` stays in place, and both restore it bit for bit
    import torch.distributed.checkpoint.filesystem as fs

    real_write, calls = fs._write_item, [0]

    def failing_write(*args, **kwargs):
        calls[0] += 1
        if rank == 1 and calls[0] > 2:
            raise OSError("rank 1 lost its disk mid-save")
        return real_write(*args, **kwargs)

    init_weights(g, torch.Generator().manual_seed(13))  # `fresh` now differs from `last`
    fresh.step = 4
    fs._write_item = failing_write
    try:
        policy.save_epoch(fresh, 1, 10.0 if rank == 0 else float("nan"), float("nan"))
        out["torn/raised"] = np.array("")
    except BaseException as e:  # DCP's CheckpointException is no Exception
        out["torn/raised"] = np.array(type(e).__name__)
    fs._write_item = real_write
    out["torn/listing"] = np.array(sorted(os.listdir(os.path.join(work, "ckpt"))))
    out["torn/restored"] = np.array(policy.restore_latest(fresh))
    out.update({"torn/got/" + k: v for k, v in train_state_arrays(fresh).items()})

    # LOCAL_BN with the packed trunk (bf16, 64 channels): K4/K5's wrapper
    # runs per rank (its plain version on the CPU), the EMA takes the
    # global moments
    from srgan_st_tpu_torch.core.config import Config, apply_overrides
    from srgan_st_tpu_torch.kernels import packed_trunk as pt
    from srgan_st_tpu_torch.losses.registry import build_warmup_criterions
    from srgan_st_tpu_torch.models.generator import Generator
    from srgan_st_tpu_torch.train.steps import GANTrainState, make_g_optimizer, make_warmup_step

    calls = []
    real = pt.packed_trunk
    pt.packed_trunk = lambda *a: calls.append(1) or real(*a)
    cfg = apply_overrides(Config(), ["TPU.COMPUTE_DTYPE=bfloat16", "TPU.LOCAL_BN=true",
                                     "MODEL.G_N_RCB=2", "DATA.BATCH_SIZE=2"])
    g = Generator.from_config(cfg, group=group)
    g.load_state_dict(sd("g64/"))
    state = GANTrainState(g, make_g_optimizer(cfg, g.parameters(), 10))
    step = make_warmup_step(cfg, build_warmup_criterions(cfg), group)
    step(state, inp["gts"][0][group.batch_slice(2)])
    out["packed_calls"] = np.array(len(calls))
    for k, v in g.state_dict().items():
        if "running" in k:
            out["packed/" + k] = v.numpy()

    # tiled eval over the two ranks
    from srgan_st_tpu_torch.eval.tiled import TiledApplier
    from srgan_st_tpu_torch.eval.validate import make_generator_apply
    from srgan_st_tpu_torch.train.checkpoint import variables_from_generator_state_dict

    tcfg = apply_overrides(Config(), ["MODEL.G_N_RCB=2", "MODEL.G_N_CHANNEL=16"])
    apply_fn = make_generator_apply(tcfg, variables_from_generator_state_dict(sd("g/")),
                                    device="cpu")
    tiled = TiledApplier(apply_fn, 4, tile=16, halo=12, tile_batch=4, mesh=group)
    out["tiled"] = tiled(inp["lr"])
    np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()
''')

SETS = ["MODEL.G_N_RCB=2", "MODEL.G_N_CHANNEL=16", "MODEL.D_N_CHANNEL=4",
        f"DATA.BATCH_SIZE={GLOBAL_BATCH}", "SOLVER.D_UPDATE_INTERVAL=2",
        "MODEL.G_LOSS.CRITERIONS={'Adversarial': {'kind': 'adversarial'}, "
        "'Pixel': {'kind': 'pixel', 'criterion': 'mse'}}"]
CASES = {"sync": SETS, "local": SETS + ["TPU.LOCAL_BN=true"]}


def _jax_init():
    """The JAX package's initial G and D (2 RCB / 16 ch, 4 ch D), f32."""
    from srgan_st_tpu.core.config import Config as JaxConfig
    from srgan_st_tpu.models.discriminator import Discriminator as JaxD
    from srgan_st_tpu.models.generator import Generator as JaxG
    from srgan_st_tpu.train import steps as S

    jcfg = JaxConfig()
    jcfg.MODEL.G_N_RCB, jcfg.MODEL.G_N_CHANNEL, jcfg.MODEL.D_N_CHANNEL = 2, 16, 4
    jstate = S.create_gan_state(jcfg, JaxG.from_config(jcfg), JaxD.from_config(jcfg),
                                S.make_g_optimizer(jcfg, 10), S.make_d_optimizer(jcfg, 10))
    get = lambda p, s: jax.device_get({"params": p, "batch_stats": s})  # noqa: E731
    return get(jstate.g_params, jstate.g_stats), get(jstate.d_params, jstate.d_stats)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Runs _CHILD in two processes once; returns (inputs, [rank0, rank1])."""
    from srgan_st_tpu_torch.models.generator import random_variables
    from srgan_st_tpu_torch.train.checkpoint import (
        discriminator_state_dict_from_variables, generator_state_dict_from_variables,
    )

    work = tmp_path_factory.mktemp("dist")
    g_vars, d_vars = _jax_init()
    inputs = {"gts": np.random.default_rng(3).integers(0, 256, (3, GLOBAL_BATCH, 96, 96, 3),
                                                        np.uint8),
              "lr": np.random.default_rng(2).random((1, 48, 56, 3), np.float32),
              "cases": json.dumps(list(CASES))}
    inputs.update({f"sets/{c}": json.dumps(s) for c, s in CASES.items()})
    for prefix, sd in (("g/", generator_state_dict_from_variables(g_vars)),
                       ("d/", discriminator_state_dict_from_variables(d_vars)),
                       ("g64/", generator_state_dict_from_variables(
                           random_variables(1, channels=64, num_rcb=2)))):
        inputs.update({prefix + k: v.numpy() for k, v in sd.items()})
    np.savez(work / "inputs.npz", **inputs)
    (work / "steps.py").write_text(_STEPS)
    (work / "child.py").write_text(_CHILD)
    port = _free_port()
    procs = []
    for rank in range(2):
        # sync-BN's gradients hold their 1e-4 gate at up to 2 threads a rank, not at 4 or 8
        env = dict(os.environ, **started_env(2, most=2), SRGAN_ST_COORDINATOR=f"127.0.0.1:{port}",
                   SRGAN_ST_NUM_PROCESSES="2", SRGAN_ST_PROCESS_ID=str(rank),
                   PYTHONPATH=os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH"))
                                              if p))
        procs.append(subprocess.Popen([sys.executable, str(work / "child.py"), str(work)],
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, f"rank failed rc={p.returncode}\n{out}\n{err[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(2)]
    return inputs, (g_vars, d_vars), ranks


def _one_rank(inputs, case):
    """The same steps in this process, one rank, on the global batch."""
    from srgan_st_tpu_torch.parallel.mesh import DataParallel

    ns = {}
    exec(_STEPS, ns)
    sd = lambda p: {k[len(p):]: torch.from_numpy(v) for k, v in inputs.items()  # noqa: E731
                    if k.startswith(p)}
    return ns["run_steps"](CASES[case], inputs["gts"], sd("g/"), sd("d/"), DataParallel())


def _state_arrays(rank, case, name):
    pre = f"{case}/{name}/"
    return {k[len(pre):]: v for k, v in rank.items() if k.startswith(pre)}


def test_process_slice():
    from srgan_st_tpu_torch.parallel.distributed import process_slice

    got = np.zeros(12, bool)
    for p in range(3):
        s = process_slice(12, p, 3)
        assert not got[s].any()
        got[s] = True
    assert got.all()
    assert process_slice(8, 1, 2) == slice(4, 8)
    assert process_slice(16, 0, 1) == slice(0, 16)
    assert process_slice(16) == slice(0, 16)  # no process group: one process
    with pytest.raises(ValueError, match="not divisible"):
        process_slice(10, 0, 3)


def test_single_process_needs_no_group_and_cuda_takes_nccl(monkeypatch):
    """Nothing set: no process group, one rank. With the launch variables
    (SRGAN_ST_* or torchrun's) and a CUDA device the backend is NCCL unless
    the caller passes another (init_process_group recorded, not run); a
    missing GPU raises."""
    import torch.distributed as dist

    from srgan_st_tpu_torch.parallel import distributed as D

    for v in ("SRGAN_ST_COORDINATOR", "SRGAN_ST_NUM_PROCESSES", "SRGAN_ST_PROCESS_ID",
              "MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(v, raising=False)
    assert D.initialize_distributed(device="cpu") is False
    assert D.process_info() == (0, 1) and D.is_coordinator()
    seen = []
    monkeypatch.setattr(dist, "init_process_group", lambda backend, **kw: seen.append(
        (backend, kw.get("device_id"), kw["world_size"], kw["rank"], kw["init_method"])))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("SRGAN_ST_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("SRGAN_ST_NUM_PROCESSES", "4")
    monkeypatch.setenv("SRGAN_ST_PROCESS_ID", "3")
    assert D.initialize_distributed(device="cuda")
    assert D.initialize_distributed(device="cuda", backend="gloo")
    assert D.initialize_distributed(device="cpu")
    tcp = "tcp://127.0.0.1:1"
    assert seen == [("nccl", torch.device("cuda", 1), 4, 3, tcp), ("gloo", None, 4, 3, tcp),
                    ("gloo", None, 4, 3, tcp)]
    # torchrun's variables: its agent's store, joined by env://; LOCAL_RANK
    # picks the GPU
    for v in ("SRGAN_ST_COORDINATOR", "SRGAN_ST_NUM_PROCESSES", "SRGAN_ST_PROCESS_ID"):
        monkeypatch.delenv(v)
    for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", "2"), ("WORLD_SIZE", "2"),
                 ("RANK", "1"), ("LOCAL_RANK", "0")):
        monkeypatch.setenv(k, v)
    assert D.initialize_distributed(device="cuda")
    assert seen[-1] == ("nccl", torch.device("cuda", 0), 2, 1, "env://")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D.rank_device("cuda", 0)


def test_sync_bn_two_ranks_equal_one_rank_on_the_global_batch(two_ranks):
    """Sync-BN over 2 ranks (f32, the unfused trunk): one warmup step, then
    G, D and G steps. Against one process on the global batch: losses
    within 1e-5 relative; every applied gradient within 1e-4 of its
    max|grad| (3e-6 to 2e-5 measured), which shows that the BN moment
    average is on the differentiated path (an average off it errs by ~1x
    max|grad|); parameters within 2.01 lr after Adam; both ranks hold the
    same parameters and running statistics, bit for bit."""
    inputs, _, ranks = two_ranks
    losses, grads, state = _one_rank(inputs, "sync")
    flat = lambda gl: torch.cat([t.reshape(-1) for t in gl]).numpy()  # noqa: E731
    for r in ranks:
        got = json.loads(str(r["sync/losses"]))
        assert set(got) == set(losses)
        for k, v in losses.items():
            assert abs(got[k] - v) <= 1e-5 * abs(v), k
        for i, gl in enumerate(grads):
            want = flat(gl)
            assert np.abs(r[f"sync/grad{i}"] - want).max() <= 1e-4 * np.abs(want).max(), i
        for name, m in (("w", state.w_model), ("g", state.g_model), ("d", state.d_model)):
            arrays = _state_arrays(r, "sync", name)
            for k, v in m.state_dict().items():
                bound = 2.01 * LR if "running" not in k else 1e-5
                np.testing.assert_allclose(arrays[k], v.float().numpy(), atol=bound, err_msg=k)
    for k in ranks[0]:
        if k.startswith("sync/"):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def _jax_steps(g_vars, d_vars, gts, local_bn):
    """The JAX package's steps on the same global batches: the default
    (GSPMD) step for sync-BN, or the shard_map step with LOCAL_BN on a
    2-device mesh (tests/test_train.py:320's setup)."""
    from jax.sharding import PartitionSpec as P

    from srgan_st_tpu.core.config import Config as JaxConfig
    from srgan_st_tpu.losses.registry import build_criterions, build_warmup_criterions
    from srgan_st_tpu.models.discriminator import Discriminator as JaxD
    from srgan_st_tpu.models.generator import Generator as JaxG
    from srgan_st_tpu.parallel.mesh import make_mesh, replicated, shard_map_step
    from srgan_st_tpu.train import steps as S

    cfg = JaxConfig()
    cfg.MODEL.G_N_RCB, cfg.MODEL.G_N_CHANNEL, cfg.MODEL.D_N_CHANNEL = 2, 16, 4
    cfg.DATA.BATCH_SIZE, cfg.SOLVER.D_UPDATE_INTERVAL = GLOBAL_BATCH, 2
    cfg.MODEL.G_LOSS.CRITERIONS = {"Adversarial": {"kind": "adversarial"},
                                   "Pixel": {"kind": "pixel", "criterion": "mse"}}
    axis = None
    if local_bn:
        cfg.TPU.SHARD_MAP, cfg.TPU.SHARD_MAP_AXIS, cfg.TPU.LOCAL_BN = True, "data", True
        axis = "data"
    jg, jd = JaxG.from_config(cfg, axis_name=axis), JaxD.from_config(cfg, axis_name=axis)
    g_tx, d_tx = S.make_g_optimizer(cfg, 10), S.make_d_optimizer(cfg, 10)
    state = S.create_gan_state(cfg, jg, jd, g_tx, d_tx).replace(
        g_params=g_vars["params"], g_stats=g_vars["batch_stats"],
        d_params=d_vars["params"], d_stats=d_vars["batch_stats"])
    w_state = state
    warm = S.make_warmup_step(cfg, jg, build_warmup_criterions(cfg), g_tx)
    g_step, d_step = S.make_gan_steps(cfg, jg, jd, build_criterions(cfg), g_tx, d_tx)
    if local_bn:
        mesh = make_mesh(cfg, devices=jax.devices()[:2])
        state = w_state = jax.device_put(state, replicated(mesh))
        warm = shard_map_step(warm, mesh, (P(), P("data")), (P(), P()))
        g_step = shard_map_step(g_step, mesh, (P(), P("data")), (P(), P("data"), P()))
        d_step = shard_map_step(d_step, mesh, (P(), P("data"), P("data")), (P(), P()))
    warm, g_step, d_step = jax.jit(warm), jax.jit(g_step), jax.jit(d_step)
    losses = {}
    w_state, m = warm(w_state, jnp.asarray(gts[0]))
    losses.update({"warm/" + k: float(v) for k, v in m.items()})
    state, sr, m = g_step(state, jnp.asarray(gts[1]))
    losses.update({"g1/" + k: float(v) for k, v in m.items()})
    state, m = d_step(state, jnp.asarray(gts[1]), sr)
    losses.update({"d/" + k: float(v) for k, v in m.items()})
    state, _, m = g_step(state, jnp.asarray(gts[2]))
    losses.update({"g2/" + k: float(v) for k, v in m.items()})
    get = lambda p, s: jax.device_get({"params": p, "batch_stats": s})  # noqa: E731
    return losses, {"w": get(w_state.g_params, w_state.g_stats),
                    "g": get(state.g_params, state.g_stats),
                    "d": get(state.d_params, state.d_stats)}


@pytest.mark.parametrize("case", ["sync", "local"])
def test_two_ranks_match_the_jax_step(two_ranks, case):
    """Rank 0's losses, parameters and running statistics against the JAX
    package's steps on the same global batch of 2 (a warmup step; G, D and G
    steps: test_torch_train.py's sequences), with test_torch_train.py's f32
    bounds (losses within 1e-5, atol 5e-5 / rtol 1e-4): sync-BN against
    the default step, LOCAL_BN against the shard_map LOCAL_BN step on a
    2-device mesh. LOCAL_BN's running statistics are bit-identical across
    the ranks."""
    from srgan_st_tpu_torch.train.checkpoint import (
        variables_from_discriminator_state_dict, variables_from_generator_state_dict,
    )

    inputs, (g_vars, d_vars), ranks = two_ranks
    losses, want = _jax_steps(g_vars, d_vars, inputs["gts"], case == "local")
    got = json.loads(str(ranks[0][f"{case}/losses"]))
    for k, v in losses.items():
        assert abs(got[k] - v) < 1e-5, k
    for name, to_vars in (("w", variables_from_generator_state_dict),
                          ("g", variables_from_generator_state_dict),
                          ("d", variables_from_discriminator_state_dict)):
        arrays = {k: torch.from_numpy(v) for k, v in _state_arrays(ranks[0], case, name).items()}
        arrays.update({k: torch.zeros(()) for k in ("num_batches_tracked",)})
        tree = to_vars(arrays)
        assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(want[name])
        for a, b in zip(jax.tree_util.tree_leaves(tree),
                        jax.tree_util.tree_leaves(want[name])):
            np.testing.assert_allclose(a, np.asarray(b), atol=5e-5, rtol=1e-4)
    for k in ranks[0]:
        if k.startswith(f"{case}/") and "running" in k:
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def test_local_bn_runs_the_packed_trunk_per_rank(two_ranks):
    """Under LOCAL_BN the K4/K5 trunk runs on each rank (its wrapper called
    once per G forward, bf16, 64 channels), and the running statistics it
    feeds, averaged over the ranks, are bit-identical on both. Without
    LOCAL_BN, more than one rank takes the unfused trunk (auto) or refuses
    a forced kernel trunk."""
    from srgan_st_tpu_torch.models.generator import Generator
    from srgan_st_tpu_torch.parallel.mesh import DataParallel

    _, _, ranks = two_ranks
    for r in ranks:
        assert int(r["packed_calls"]) == 1
    keys = [k for k in ranks[0] if k.startswith("packed/")]
    assert len(keys) == 2 * (2 * 2 + 1)
    for k in keys:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)
    x = torch.empty(2, 24, 24, 64, dtype=torch.bfloat16, device="meta")
    two = DataParallel(2, 0)
    assert Generator(channels=64, num_rcb=1, dtype=torch.bfloat16,
                     group=two)._trunk_mode(True, x) == "unfused"
    assert Generator(channels=64, num_rcb=1, dtype=torch.bfloat16, group=two,
                     local_bn=True)._trunk_mode(True, x) == "packed"
    for mode in ("packed", "xpack", "fused", "hybrid"):
        with pytest.raises(ValueError, match="LOCAL_BN"):
            Generator(channels=64, num_rcb=1, dtype=torch.bfloat16, group=two,
                      trunk_mode=mode)._trunk_mode(True, x)


def test_collective_dcp_checkpoint_over_two_ranks(two_ranks):
    """EXP.ORBAX_CHECKPOINTS over two ranks (the JAX child's orbax case,
    tests/test_distributed.py:159-181): both ranks call save_epoch into one
    directory, rank 1 with NaN metrics, and both see is_best (the metrics
    are broadcast from rank 0); both restore `last` into a fresh state and
    hold, bit for bit, every parameter, running statistic, Adam moment and
    step count, update count and `step` that was saved, the same bits on
    both ranks."""
    _, _, ranks = two_ranks
    for r in ranks:
        assert bool(r["ckpt/is_best"]) and bool(r["ckpt/restored"])
        saved = {k[len("ckpt/saved/"):]: v for k, v in r.items() if k.startswith("ckpt/saved/")}
        got = {k[len("ckpt/got/"):]: v for k, v in r.items() if k.startswith("ckpt/got/")}
        assert got.keys() == saved.keys() and len(saved) > 100
        assert sum(".moments." in k for k in saved) > 0 and int(saved["step"]) == 3
        for k in saved:
            np.testing.assert_array_equal(got[k], saved[k], err_msg=k)
    for k in ranks[0]:
        if k.startswith("ckpt/got/"):
            np.testing.assert_array_equal(ranks[0][k], ranks[1][k], err_msg=k)


def test_collective_dcp_save_failing_on_rank_1_keeps_last(two_ranks):
    """A collective save of `last` that fails partway on rank 1 (its DCP
    writer raises at its third item) raises DCP's CheckpointException on
    both ranks and leaves the previous `last/` in place, beside the torn
    temporary directory; both ranks restore the previous state bit for
    bit."""
    _, _, ranks = two_ranks
    for r in ranks:
        assert str(r["torn/raised"]) == "CheckpointException"
        assert list(r["torn/listing"]) == ["_policy.json", "best", "last", "last.tmp-4"]
        assert bool(r["torn/restored"])
        saved = {k[len("ckpt/saved/"):]: v for k, v in r.items() if k.startswith("ckpt/saved/")}
        got = {k[len("torn/got/"):]: v for k, v in r.items() if k.startswith("torn/got/")}
        assert got.keys() == saved.keys() and int(got["step"]) == 3
        for k in saved:
            np.testing.assert_array_equal(got[k], saved[k], err_msg=k)


def test_tiled_eval_over_two_ranks(two_ranks):
    """The tile batches split over 2 ranks and gathered: bit for bit the
    one-rank tiled output on every rank, and the whole-image output within
    test_torch_serving.py's atol 1e-5."""
    from srgan_st_tpu_torch.core.config import Config, apply_overrides
    from srgan_st_tpu_torch.eval.tiled import TiledApplier
    from srgan_st_tpu_torch.eval.validate import make_generator_apply
    from srgan_st_tpu_torch.train.checkpoint import variables_from_generator_state_dict

    inputs, _, ranks = two_ranks
    cfg = apply_overrides(Config(), ["MODEL.G_N_RCB=2", "MODEL.G_N_CHANNEL=16"])
    sd = {k[2:]: torch.from_numpy(v) for k, v in inputs.items() if k.startswith("g/")}
    apply_fn = make_generator_apply(cfg, variables_from_generator_state_dict(sd), device="cpu")
    one = TiledApplier(apply_fn, 4, tile=16, halo=12, tile_batch=4)(inputs["lr"])
    assert one.shape == (1, 192, 224, 3)
    for r in ranks:
        np.testing.assert_array_equal(r["tiled"], one)
    np.testing.assert_allclose(one, apply_fn(inputs["lr"]).numpy(), atol=1e-5)
