"""The port's train-state checkpoints, on the CPU: EXP.ORBAX_CHECKPOINTS as
`torch.distributed.checkpoint` (DCP) directories beside the default
`.state.pt` files, against the JAX package's policy where they share
semantics (last / best / epoch{N}, the skip of an incompatible `last`,
resume). Sizes are those of the trajectory goldens (a 2 RCB / 16 ch G, a
4 ch D). The two-rank collective save is in test_torch_distributed.py.
"""

import os

import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
from srgan_st_tpu_torch.core.config import Config, apply_overrides

SETS = ["MODEL.G_N_RCB=2", "MODEL.G_N_CHANNEL=16", "MODEL.D_N_CHANNEL=4",
        "DATA.BATCH_SIZE=2", "SOLVER.D_UPDATE_INTERVAL=2"]


def _gan_state(seed, sets=()):
    from srgan_st_tpu_torch.models.discriminator import Discriminator
    from srgan_st_tpu_torch.models.generator import Generator
    from srgan_st_tpu_torch.train.steps import create_gan_state

    cfg = apply_overrides(Config(), SETS + list(sets))
    return cfg, create_gan_state(cfg, Generator.from_config(cfg), Discriminator.from_config(cfg),
                                 10, "cpu", generator=torch.Generator().manual_seed(seed))


def _stepped_gan_state(seed=0):
    """A GAN state after a G, D and G step: Adam moments and counts that
    differ between G (2 updates) and D (1), running statistics moved."""
    from srgan_st_tpu_torch.losses.registry import build_criterions
    from srgan_st_tpu_torch.train.steps import make_gan_steps

    cfg, state = _gan_state(seed)
    g_step, d_step = make_gan_steps(cfg, build_criterions(cfg))
    gts = torch.from_numpy(np.random.default_rng(seed).integers(0, 256, (2, 2, 96, 96, 3),
                                                                np.uint8))
    state, sr, _ = g_step(state, gts[0])
    state, _ = d_step(state, gts[0], sr)
    state, _, _ = g_step(state, gts[1])
    return cfg, state


def _ptrs(state):
    out = [t.data_ptr() for m in (state.g_model, state.d_model) for t in m.state_dict().values()]
    for opt in (state.g_opt, state.d_opt):
        out += [t.data_ptr() for st in opt.opt.state.values() for t in st.values()]
    return out


def test_dcp_round_trips_a_gan_state_in_place(tmp_path):
    """save_epoch writes DCP `last/` and `best/` directories (and
    `epoch{N}/` at the interval); restore_latest into a fresh state
    restores every parameter, running statistic, Adam moment, Adam step
    count, update count and `step` bit for bit. A fresh optimizer's state
    is made before the load without a step: parameters unchanged, counts 0.
    Every tensor keeps its storage (data_ptr), the restore's point for
    captured CUDA graphs."""
    from srgan_st_tpu_torch.train.checkpoint import (
        CheckpointPolicy, _dcp_tree, _trainable, train_state_arrays,
    )

    _, state = _stepped_gan_state()
    state.step = 7
    saved = train_state_arrays(state)
    assert saved["g_opt.count"] == 2 and saved["d_opt.count"] == 1
    policy = CheckpointPolicy(str(tmp_path / "res"), interval=2, use_orbax=True)
    assert not policy.collective
    assert policy.save_epoch(state, 2, 20.0, 0.5) is True
    for name in ("last", "best", "epoch2"):
        assert {".metadata", "__0_0.distcp"} <= set(os.listdir(tmp_path / "res" / name))
    assert not any(f.endswith(".state.pt") for f in os.listdir(tmp_path / "res"))

    _, fresh = _gan_state(5)
    before = {k: v.clone() for k, v in fresh.g_model.state_dict().items()}
    # the restore's first move: the moments the checkpoint holds, no step
    _dcp_tree(fresh, {"g": set(_trainable(fresh.g_model)), "d": set(_trainable(fresh.d_model))})
    assert all(torch.equal(before[k], v) for k, v in fresh.g_model.state_dict().items())
    assert fresh.g_opt.count == fresh.d_opt.count == 0
    assert all(float(st["step"]) == 0 and not st["exp_avg"].any()
               for st in fresh.g_opt.opt.state.values())
    ptrs = _ptrs(fresh)
    assert policy.restore_latest(fresh) is True
    assert _ptrs(fresh) == ptrs
    got = train_state_arrays(fresh)
    assert got.keys() == saved.keys()
    assert len([k for k in saved if ".moments." in k]) == 3 * (
        len(state.g_opt.params) + len(state.d_opt.params))
    differ = [k for k in saved if not np.array_equal(got[k], saved[k])]
    assert not differ, differ[:5]
    assert (fresh.step, fresh.g_opt.count, fresh.d_opt.count) == (7, 2, 1)


def test_dcp_restored_state_steps_like_the_saved_one(tmp_path):
    """The next G step of a restored state equals the saved state's next G
    step bit for bit (the moments, counts and lr schedule carried over)."""
    from srgan_st_tpu_torch.losses.registry import build_criterions
    from srgan_st_tpu_torch.train.checkpoint import CheckpointPolicy, train_state_arrays
    from srgan_st_tpu_torch.train.steps import make_gan_steps

    cfg, state = _stepped_gan_state(1)
    policy = CheckpointPolicy(str(tmp_path), use_orbax=True)
    policy.save_epoch(state, 0, 1.0, 1.0)
    _, fresh = _gan_state(6)
    assert policy.restore_latest(fresh)
    g_step, _ = make_gan_steps(cfg, build_criterions(cfg))
    gt = torch.from_numpy(np.random.default_rng(9).integers(0, 256, (2, 96, 96, 3), np.uint8))
    outs = [train_state_arrays(g_step(s, gt)[0]) for s in (state, fresh)]
    differ = [k for k in outs[0] if not np.array_equal(outs[0][k], outs[1][k])]
    assert not differ, differ[:5]


@pytest.mark.parametrize("case", ["warmup_state", "other_width", "orbax_directory"])
def test_dcp_skips_an_incompatible_last_with_the_warning(tmp_path, capsys, case):
    """A `last/` that does not fit is skipped with the JAX package's warning
    and changes nothing: a warmup (G only) state found by a GAN run, a state
    of another G_N_CHANNEL, and a directory that is no DCP checkpoint (an
    orbax one)."""
    from srgan_st_tpu_torch.train.checkpoint import CheckpointPolicy, train_state_arrays
    from srgan_st_tpu_torch.train.steps import GANTrainState

    policy = CheckpointPolicy(str(tmp_path), use_orbax=True)
    if case == "warmup_state":
        _, other = _gan_state(2)
        policy.save_epoch(GANTrainState(other.g_model, other.g_opt), 0, 1.0, 1.0)
    elif case == "other_width":
        _, other = _gan_state(2, ["MODEL.G_N_CHANNEL=8"])
        policy.save_epoch(other, 0, 1.0, 1.0)
    else:
        os.makedirs(tmp_path / "last" / "default")
        (tmp_path / "last" / "_CHECKPOINT_METADATA").write_text("{}")
    _, state = _gan_state(3)
    before = train_state_arrays(state)
    assert policy.restore_latest(state) is False
    assert "skipping incompatible 'last' checkpoint" in capsys.readouterr().out
    after = train_state_arrays(state)
    assert after.keys() == before.keys()
    assert all(np.array_equal(after[k], before[k]) for k in before)
    assert not state.g_opt.opt.state


@pytest.mark.parametrize("use_orbax", [True, False])
def test_resumed_warmup_equals_an_uninterrupted_one(tmp_path, monkeypatch, use_orbax):
    """warmup() for 1 epoch, then relaunched for 2 (AUTO_RESUME restores
    `last` and starts at epoch 1), ends bit for bit where one 2-epoch run
    ends: the DCP format and `.state.pt`. The batches come from a pack,
    whose epoch order is a function of (seed, epoch) (the synthetic source
    is one stream that a relaunch starts again); validation is on the
    synthetic pairs."""
    from srgan_st_tpu_torch.data.pipeline import PackedPatchSource
    from srgan_st_tpu_torch.train import warmup as W
    from srgan_st_tpu_torch.train.checkpoint import train_state_arrays

    pack = str(tmp_path / "patches.pack.npy")
    np.save(pack, np.random.default_rng(4).integers(0, 256, (4, 96, 96, 3), np.uint8))
    monkeypatch.setattr(W, "make_train_source", lambda config, device=None: PackedPatchSource(
        pack, config.DATA.BATCH_SIZE, seed=config.DATA.SEED, device_cache=False))
    sets = SETS + ["DATA.SYNTHETIC=true", "LOG_TRAIN_PERIOD=1",
                   f"EXP.ORBAX_CHECKPOINTS={use_orbax}"]
    runs = {}
    for name, epochs in (("resumed", (1, 2)), ("straight", (2,))):
        os.makedirs(tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        for n in epochs:
            state = W.warmup(apply_overrides(Config(), sets + [f"EXP.N_EPOCHS={n}"]), "cpu")
        last = os.path.join("results", "experiment-name",
                            "last" if use_orbax else "last.state.pt")
        assert os.path.isdir(last) == use_orbax and os.path.exists(last)
        runs[name] = train_state_arrays(state)
    assert runs["resumed"]["step"] == runs["straight"]["step"] == 4
    differ = [k for k in runs["straight"]
              if not np.array_equal(runs["resumed"][k], runs["straight"][k])]
    assert not differ, differ[:5]


def test_orbax_checkpoints_key_builds():
    """--set EXP.ORBAX_CHECKPOINTS=true is accepted (the JAX default False
    otherwise) and the loops build their policy with it."""
    from srgan_st_tpu_torch.core.config import parse_driver_cli
    from srgan_st_tpu_torch.train.checkpoint import CheckpointPolicy

    assert Config().EXP.ORBAX_CHECKPOINTS is False
    cfg, dev = parse_driver_cli(["--set", "EXP.ORBAX_CHECKPOINTS=true", "--device", "cpu"], "d")
    assert cfg.EXP.ORBAX_CHECKPOINTS is True and dev == "cpu"
    import inspect

    from srgan_st_tpu_torch.train import train, warmup

    for mod in (train, warmup):
        assert "use_orbax=config.EXP.ORBAX_CHECKPOINTS" in inspect.getsource(mod)
    assert CheckpointPolicy.__init__.__defaults__ == (100, False)


def test_train_states_do_not_cross_between_the_packages(tmp_path, capsys):
    """Pinned divergence (ROADMAP.md Queue C): the port's train states are
    its own. A JAX `.state.npz` is not the port's `last.state.pt`, and the
    port's `.state.pt` is not the JAX package's `last.state.npz`: neither
    policy finds the other's. A JAX orbax `last/` is skipped by the port's
    DCP policy with the warning (test above), and the JAX orbax policy
    cannot restore the port's DCP `last/` (test below). Weights cross
    through the npz files: a g_last.npz either package writes loads in the
    other."""
    import jax

    from srgan_st_tpu.core.config import Config as JaxConfig
    from srgan_st_tpu.models.generator import Generator as JaxG
    from srgan_st_tpu.train import checkpoint as jck
    from srgan_st_tpu.train import steps as S
    from srgan_st_tpu_torch.train.checkpoint import (
        CheckpointPolicy, generator_state_dict_from_variables, load_params_npz,
        save_variables_npz, variables_from_generator_state_dict,
    )

    jcfg = JaxConfig()
    jcfg.MODEL.G_N_RCB, jcfg.MODEL.G_N_CHANNEL = 2, 16
    jstate = S.create_generator_state(jcfg, JaxG.from_config(jcfg), S.make_g_optimizer(jcfg, 4))
    jpol = jck.CheckpointPolicy(str(tmp_path / "jax"), interval=100)
    jpol.save_epoch(jstate, 0, 20.0, 0.5)
    assert os.path.exists(tmp_path / "jax" / "last.state.npz")
    _, state = _gan_state(0)
    for use_orbax in (False, True):
        assert CheckpointPolicy(str(tmp_path / "jax"), use_orbax=use_orbax
                                ).restore_latest(state) is False
    port = CheckpointPolicy(str(tmp_path / "port"))
    port.save_epoch(state, 0, 20.0, 0.5)
    assert jck.CheckpointPolicy(str(tmp_path / "port"), interval=100
                                ).restore_latest(jstate) is None
    # weights cross: the JAX g variables into the port and back
    g_vars = jax.device_get({"params": jstate.g_params, "batch_stats": jstate.g_stats})
    jck.save_variables_npz(str(tmp_path / "g_last.npz"), g_vars)
    sd = generator_state_dict_from_variables(load_params_npz(str(tmp_path / "g_last.npz")))
    save_variables_npz(str(tmp_path / "g_port.npz"), variables_from_generator_state_dict(sd))
    back = jck.load_params_npz(str(tmp_path / "g_port.npz"))
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(g_vars)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_jax_orbax_policy_does_not_restore_a_port_dcp_state(tmp_path):
    """Pinned divergence (ROADMAP.md Queue C): EXP.ORBAX_CHECKPOINTS keeps
    its name, but the port's `last/` is a DCP directory, in which orbax's
    StandardCheckpointer finds no checkpoint structure."""
    pytest.importorskip("orbax.checkpoint")
    from srgan_st_tpu.core.config import Config as JaxConfig
    from srgan_st_tpu.models.generator import Generator as JaxG
    from srgan_st_tpu.train import checkpoint as jck
    from srgan_st_tpu.train import steps as S
    from srgan_st_tpu_torch.train.checkpoint import CheckpointPolicy

    jcfg = JaxConfig()
    jcfg.MODEL.G_N_RCB, jcfg.MODEL.G_N_CHANNEL = 2, 16
    jstate = S.create_generator_state(jcfg, JaxG.from_config(jcfg), S.make_g_optimizer(jcfg, 4))
    _, state = _gan_state(0)
    CheckpointPolicy(str(tmp_path), use_orbax=True).save_epoch(state, 0, 20.0, 0.5)
    assert os.path.exists(tmp_path / "last" / ".metadata")
    jorbax = jck.CheckpointPolicy(str(tmp_path), interval=100, use_orbax=True)
    with pytest.raises(FileNotFoundError, match="No structure could be identified"):
        jorbax.restore_latest(jstate)


def test_dcp_save_changes_nothing_and_restores_as_saved(tmp_path):
    """A DCP save of a state whose optimizers have not stepped writes what
    exists (no moments) and leaves the optimizers empty; restoring it into a
    stepped state gives back the saved state, moments dropped as
    Optimizer.load_state_dict drops them."""
    from srgan_st_tpu_torch.train.checkpoint import CheckpointPolicy, train_state_arrays

    _, fresh = _gan_state(4)
    saved = train_state_arrays(fresh)
    policy = CheckpointPolicy(str(tmp_path), use_orbax=True)
    policy.save_epoch(fresh, 0, 1.0, 1.0)
    assert not fresh.g_opt.opt.state and not fresh.d_opt.opt.state
    assert train_state_arrays(fresh).keys() == saved.keys()
    assert not any(".moments." in k for k in saved)
    _, state = _stepped_gan_state(2)
    assert policy.restore_latest(state) is True
    got = train_state_arrays(state)
    assert got.keys() == saved.keys()
    assert all(np.array_equal(got[k], saved[k]) for k in saved)
    assert not state.g_opt.opt.state and not state.d_opt.opt.state
    assert (state.step, state.g_opt.count, state.d_opt.count) == (0, 0, 0)


# ---------------------------------------------------------------------------
# crash safety of the DCP saves: a save that fails partway, a crash between
# the swap's two renames, leftovers of crashed saves, a `last/` torn by an
# in-place save (the layout before the swap)

def _fail_writes_after(monkeypatch, k: int) -> None:
    """DCP's file writer raises at its (k+1)-th item from now on, as a crash
    partway through a save would stop it (DCP truncates a data file when it
    opens it and writes `.metadata` last)."""
    import torch.distributed.checkpoint.filesystem as fs

    real, calls = fs._write_item, [0]

    def write_item(*args, **kwargs):
        calls[0] += 1
        if calls[0] > k:
            raise OSError("disk lost mid-save")
        return real(*args, **kwargs)

    monkeypatch.setattr(fs, "_write_item", write_item)


def _items_per_save(tmp_path, state) -> int:
    """The items DCP writes for one save of `state`."""
    import torch.distributed.checkpoint.filesystem as fs

    from srgan_st_tpu_torch.train.checkpoint import save_train_state_dcp

    real, calls = fs._write_item, [0]

    def count(*args, **kwargs):
        calls[0] += 1
        return real(*args, **kwargs)

    fs._write_item = count
    try:
        save_train_state_dcp(str(tmp_path / "count"), state)
    finally:
        fs._write_item = real
    return calls[0]


def _equal(got: dict, want: dict) -> list:
    assert got.keys() == want.keys()
    return [k for k in want if not np.array_equal(got[k], want[k])]


@pytest.mark.parametrize("name", ["last", "best"])
def test_dcp_save_failing_partway_keeps_the_previous_state(tmp_path, monkeypatch, name):
    """A save of `last` (or of `best`) that fails after 3 items raises DCP's
    CheckpointException and leaves the previous directory whole: it
    restores bit for bit (`last` through restore_latest, `best` by a direct
    load), and `_policy.json` keeps the previous best."""
    from torch.distributed.checkpoint.api import CheckpointException

    from srgan_st_tpu_torch.train.checkpoint import (
        CheckpointPolicy, load_train_state_dcp, resolve_dcp_dir, train_state_arrays,
    )

    _, old = _stepped_gan_state(0)
    old.step = 10
    want = train_state_arrays(old)
    policy = CheckpointPolicy(str(tmp_path / "res"), use_orbax=True)
    assert policy.save_epoch(old, 0, 20.0, 0.5)
    _, new = _stepped_gan_state(1)
    new.step = 20
    n = _items_per_save(tmp_path, new)
    _fail_writes_after(monkeypatch, 3 if name == "last" else n + 3)
    with pytest.raises(CheckpointException):
        policy.save_epoch(new, 1, 21.0, 0.6)
    monkeypatch.undo()
    listing = os.listdir(tmp_path / "res")
    assert f"{name}.tmp-20" in listing and ".metadata" not in os.listdir(
        tmp_path / "res" / f"{name}.tmp-20")
    _, fresh = _gan_state(5)
    if name == "last":
        assert CheckpointPolicy(str(tmp_path / "res"), use_orbax=True).restore_latest(fresh)
    else:
        load_train_state_dcp(resolve_dcp_dir(str(tmp_path / "res" / "best")), fresh)
        assert CheckpointPolicy(str(tmp_path / "res"), use_orbax=True).best_psnr == 20.0
    assert not _equal(train_state_arrays(fresh), want)
    assert fresh.step == 10


def test_dcp_crash_between_the_renames_is_recovered(tmp_path, monkeypatch):
    """A crash after the old `last/` was moved aside and before the new one
    was renamed into place leaves no `last/`: restore_latest takes the
    moved-aside directory, whole, bit for bit. The next save puts a `last/`
    in place and removes both leftovers."""
    from srgan_st_tpu_torch.train.checkpoint import CheckpointPolicy, train_state_arrays

    res = tmp_path / "res"
    _, old = _stepped_gan_state(0)
    old.step = 10
    want = train_state_arrays(old)
    policy = CheckpointPolicy(str(res), use_orbax=True)
    policy.save_epoch(old, 0, 20.0, 0.5)
    real = os.rename

    def rename(src, dst, *args, **kwargs):
        if os.fspath(dst) == str(res / "last"):
            raise OSError("killed between the renames")
        return real(src, dst, *args, **kwargs)

    monkeypatch.setattr(os, "rename", rename)
    _, new = _stepped_gan_state(1)
    new.step = 20
    with pytest.raises(OSError, match="between the renames"):
        policy.save_epoch(new, 1, 19.0, 0.4)
    monkeypatch.undo()
    assert not (res / "last").exists() and (res / "last.old" / ".metadata").exists()
    _, fresh = _gan_state(5)
    assert CheckpointPolicy(str(res), use_orbax=True).restore_latest(fresh)
    assert not _equal(train_state_arrays(fresh), want)

    _, third = _stepped_gan_state(2)
    third.step = 30
    policy.save_epoch(third, 2, 19.0, 0.4)
    assert sorted(os.listdir(res)) == ["_policy.json", "best", "last"]
    _, fresh = _gan_state(6)
    assert policy.restore_latest(fresh) and fresh.step == 30
    assert not _equal(train_state_arrays(fresh), train_state_arrays(third))


def test_dcp_leftover_temporary_directories_are_ignored_then_removed(tmp_path, capsys):
    """Temporary directories of crashed saves are never restored, even a
    whole one, and the next save of each name removes its own."""
    import shutil

    from srgan_st_tpu_torch.train.checkpoint import CheckpointPolicy, train_state_arrays

    res = tmp_path / "res"
    _, old = _stepped_gan_state(0)
    old.step = 10
    policy = CheckpointPolicy(str(res), use_orbax=True)
    policy.save_epoch(old, 0, 20.0, 0.5)
    shutil.copytree(res / "last", res / "last.tmp-99")  # whole, but never taken
    os.makedirs(res / "best.tmp-7")
    (res / "best.tmp-7" / "__0_0.distcp").write_bytes(b"\0" * 100)
    _, fresh = _gan_state(5)
    assert policy.restore_latest(fresh) and fresh.step == 10
    assert not _equal(train_state_arrays(fresh), train_state_arrays(old))

    alone = tmp_path / "alone"
    os.makedirs(alone)
    shutil.copytree(res / "last", alone / "last.tmp-10")
    _, fresh = _gan_state(6)
    assert CheckpointPolicy(str(alone), use_orbax=True).restore_latest(fresh) is False
    assert fresh.step == 0 and not fresh.g_opt.opt.state

    _, new = _stepped_gan_state(1)
    new.step = 20
    assert policy.save_epoch(new, 1, 21.0, 0.6)
    assert sorted(os.listdir(res)) == ["_policy.json", "best", "last"]
    assert "skipping" not in capsys.readouterr().out


def _in_place_dcp_save(path: str, state) -> None:
    """A DCP save over `path` in place: the layout of the saves before the
    write-then-swap (FileSystemWriter with overwrite=True)."""
    import warnings

    import torch.distributed.checkpoint as dcp

    from srgan_st_tpu_torch.train.checkpoint import _dcp_tree

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        dcp.save(_dcp_tree(state)[0], checkpoint_id=path, no_dist=True,
                 storage_writer=dcp.FileSystemWriter(path, overwrite=True))


@pytest.mark.parametrize("target", ["stepped", "fresh"])
def test_dcp_torn_in_place_last_is_skipped_and_changes_nothing(tmp_path, monkeypatch, capsys,
                                                               target):
    """A `last/` torn by an in-place save that failed partway (the old
    `.metadata` over a truncated data file) passes the key and shape check,
    then DCP's load raises CheckpointException, a BaseException: restore_latest
    skips it with the warning and returns False, and no tensor of the state
    changes, nor its storage, nor its optimizers' state."""
    from torch.distributed.checkpoint.api import CheckpointException

    from srgan_st_tpu_torch.train.checkpoint import CheckpointPolicy, train_state_arrays

    last = str(tmp_path / "last")
    _, old = _stepped_gan_state(0)
    _in_place_dcp_save(last, old)
    data = os.path.join(last, "__0_0.distcp")
    whole = os.path.getsize(data)
    _, new = _stepped_gan_state(1)
    _fail_writes_after(monkeypatch, 3)
    with pytest.raises(CheckpointException):
        _in_place_dcp_save(last, new)
    monkeypatch.undo()
    assert os.path.getsize(data) < whole and os.path.exists(os.path.join(last, ".metadata"))

    _, state = _stepped_gan_state(3) if target == "stepped" else _gan_state(3)
    before, ptrs = train_state_arrays(state), _ptrs(state)
    opt_keys = [len(o.opt.state) for o in (state.g_opt, state.d_opt)]
    assert CheckpointPolicy(str(tmp_path), use_orbax=True).restore_latest(state) is False
    assert "skipping incompatible 'last' checkpoint" in capsys.readouterr().out
    assert not _equal(train_state_arrays(state), before)
    assert _ptrs(state) == ptrs
    assert [len(o.opt.state) for o in (state.g_opt, state.d_opt)] == opt_keys


def test_a_crashed_save_resumes_one_epoch_back_where_jax_starts_fresh(tmp_path, monkeypatch):
    """Pinned divergence (ROADMAP.md Queue C): a crash while epoch 1's `last`
    is saved. The JAX package's orbax save (force=True) has removed `last`
    before it writes, so its run starts fresh at epoch 0; the port's keeps
    the old `last/` until the new one is whole, so it resumes at epoch 1,
    one epoch back."""
    pytest.importorskip("orbax.checkpoint")
    from torch.distributed.checkpoint.api import CheckpointException

    from srgan_st_tpu.core.config import Config as JaxConfig
    from srgan_st_tpu.models.generator import Generator as JaxG
    from srgan_st_tpu.train import checkpoint as jck
    from srgan_st_tpu.train import steps as S
    from srgan_st_tpu_torch.train.checkpoint import CheckpointPolicy
    from srgan_st_tpu_torch.train.warmup import resume

    steps_per_epoch = 5
    jcfg = JaxConfig()
    jcfg.MODEL.G_N_RCB, jcfg.MODEL.G_N_CHANNEL = 2, 16
    jstate = S.create_generator_state(jcfg, JaxG.from_config(jcfg), S.make_g_optimizer(jcfg, 4))
    jpol = jck.CheckpointPolicy(str(tmp_path / "jax"), interval=100, use_orbax=True)
    jpol.save_epoch(jstate, 0, 20.0, 0.5)

    async def crash(*args, **kwargs):
        raise OSError("killed mid-save")

    monkeypatch.setattr(jpol._ckpt._handler, "async_save", crash)
    try:
        with pytest.raises(OSError, match="killed mid-save"):
            jpol.save_epoch(jstate, 1, 19.0, 0.4)
    finally:
        monkeypatch.undo()
        jpol._ckpt.close()
    assert not (tmp_path / "jax" / "last").exists()
    assert jck.CheckpointPolicy(str(tmp_path / "jax"), interval=100,
                                use_orbax=True).restore_latest(jstate) is None

    cfg, state = _stepped_gan_state(0)
    policy = CheckpointPolicy(str(tmp_path / "port"), use_orbax=True)
    state.step = steps_per_epoch
    policy.save_epoch(state, 0, 20.0, 0.5)
    state.step = 2 * steps_per_epoch
    _fail_writes_after(monkeypatch, 3)
    with pytest.raises(CheckpointException):
        policy.save_epoch(state, 1, 19.0, 0.4)
    monkeypatch.undo()
    cfg.EXP.AUTO_RESUME = True
    _, fresh = _gan_state(5)
    assert resume(cfg, CheckpointPolicy(str(tmp_path / "port"), use_orbax=True), fresh,
                  steps_per_epoch) == 1
