"""The kill/resume soak (`srgan_st_tpu_torch/tools/soak.py`) on the CPU at
toy size: a 2 RCB / 16 ch G and a 4 ch D (the trajectory goldens' sizes),
f32, a 32-patch pack in batches of 4, one log line a batch. A real SIGKILL
of a training process mid-epoch and its relaunch (the `.state.pt` case); the
mid-save kill of the DCP case is covered on the CPU by the injected
failures of tests/test_torch_ckpt.py, and on the card by chip_smoke.py's
`soak` phase. Plus the soak's own readers of the disk: the in-flight DCP
save it kills on, the whole state's step, and the scalar log.
"""

import json
import os
import signal

import numpy as np
import pytest
import torch

from tests.torch_threads import started_env

TOY = ["MODEL.G_N_RCB=2", "MODEL.G_N_CHANNEL=16", "MODEL.D_N_CHANNEL=4", "DATA.BATCH_SIZE=4",
       "LOG_TRAIN_PERIOD=1", "TPU.CHUNK_STEPS=1", "SOLVER.D_UPDATE_INTERVAL=2",
       "TPU.COMPUTE_DTYPE=float32"]


def test_soak_kills_and_resumes_bit_for_bit_on_the_cpu(tmp_path, monkeypatch):
    """Warmup, the uninterrupted GAN run, and the GAN run SIGKILLed after three
    logged batch lines of epoch 2 of 3 (8 batches), then relaunched: it resumes at epoch
    1 (the restored step's), the scalar log holds Test/PSNR for epochs 1-3,
    the best PSNR never fell, the checkpoint set is whole, and its final
    g_last.npz and d_last.npz equal the uninterrupted run's bit for bit."""
    from srgan_st_tpu_torch.tools.soak import run_soak

    for name, value in started_env().items():  # each phase's process, one at a time
        monkeypatch.setenv(name, value)
    report = run_soak(str(tmp_path), patches=32, warmup_epochs=1, epochs=3, kill_epoch=2,
                      cases=("state_pt",), device="cpu", sets=TOY, child_timeout=240)
    assert report["ok"], report["failures"]
    case = report["state_pt"]
    killed, resumed = case["children"]
    assert killed["killed"] and killed["rc"] == -signal.SIGKILL
    assert case["mid_epoch"] and killed["epoch_started"] == 2 and killed["validated"] == [1]
    assert resumed["rc"] == 0 and resumed["done"] and resumed["resumed_at"] == [1]
    assert resumed["validated"] == [2, 3]
    assert case["psnr_epochs"] == [1, 2, 3]
    assert case["final_max_abs_diff"] == {"g_last.npz": 0.0, "d_last.npz": 0.0}
    assert case["best_psnr"][1] >= case["best_psnr"][0]
    assert {"g_last.npz", "d_last.npz", "g_best.npz", "d_best.npz",
            "last.state.pt"} <= set(case["results_files"])
    assert "dcp" not in report
    with open(tmp_path / "SOAK_REPORT.json") as f:
        assert json.load(f)["ok"]


def test_soak_needs_a_gpu_unless_the_cpu_is_asked_for(tmp_path, monkeypatch):
    """The soak runs on CUDA by default and raises without a GPU; a kill in
    the first epoch (no `last` to resume from) and unknown cases are
    refused."""
    from srgan_st_tpu_torch.tools import soak

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        soak.run_soak(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        soak.main(["--root", str(tmp_path)])
    with pytest.raises(ValueError, match="kill-epoch 1"):
        soak.run_soak(str(tmp_path), patches=8, epochs=3, kill_epoch=1, device="cpu")
    with pytest.raises(ValueError, match="unknown cases"):
        soak.run_soak(str(tmp_path), cases=("sigterm",), device="cpu")


def test_soak_reads_a_cut_dcp_save_from_the_disk(tmp_path, monkeypatch):
    """`save_in_flight` sees the temporary directory of a DCP save that was
    cut (a data file, no `.metadata`), and an in-place layout's data file
    newer than its `.metadata`, but neither a whole directory nor files
    older than the child's start; `dcp_step` reads the step of the whole
    state, the moved-aside one too."""
    import time

    from tests.test_torch_ckpt import _fail_writes_after, _stepped_gan_state
    from torch.distributed.checkpoint.api import CheckpointException

    from srgan_st_tpu_torch.tools.soak import dcp_step, save_in_flight
    from srgan_st_tpu_torch.train.checkpoint import CheckpointPolicy

    res = tmp_path / "res"
    _, state = _stepped_gan_state(0)
    state.step = 8
    policy = CheckpointPolicy(str(res), use_orbax=True)
    since = time.time_ns()
    policy.save_epoch(state, 0, 20.0, 0.5)
    assert save_in_flight(str(res), since) == [] and dcp_step(str(res / "last")) == 8
    state.step = 16
    _fail_writes_after(monkeypatch, 3)
    with pytest.raises(CheckpointException):
        policy.save_epoch(state, 1, 21.0, 0.6)
    monkeypatch.undo()
    assert save_in_flight(str(res), since) == ["last.tmp-16"]
    assert save_in_flight(str(res), time.time_ns()) == []  # left by an earlier child
    assert dcp_step(str(res / "last")) == 8
    data = res / "last" / "__0_0.distcp"  # an in-place save under way over `last/`
    later = os.stat(res / "last" / ".metadata").st_mtime_ns + 10**9
    os.utime(data, ns=(later, later))
    assert sorted(save_in_flight(str(res), since)) == ["last", "last.tmp-16"]
    os.rename(res / "last", res / "last.old")
    assert dcp_step(str(res / "last")) == 8
    assert dcp_step(str(tmp_path / "none")) is None


def test_jsonl_scalar_rows_reach_the_file_as_they_are_logged(tmp_path, monkeypatch):
    """Without tensorboardX the scalar log is scalars.jsonl, written a line
    at a time: every row is in the file before the writer closes, so a run
    killed mid-epoch loses none."""
    import sys

    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.tools.soak import psnr_epochs
    from srgan_st_tpu_torch.train.logging import ExperimentWriter

    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    monkeypatch.chdir(tmp_path)
    writer = ExperimentWriter(Config())
    for epoch in (1, 2):
        writer.add_scalar("Test/PSNR", 20.0 + epoch, epoch)
    log_dir = tmp_path / "tensorboard" / Config().EXP.NAME
    assert psnr_epochs(str(log_dir)) == [1, 2]
    with open(log_dir / "scalars.jsonl", "a") as f:
        f.write('{"tag": "Test/PSNR", "val')  # a row cut by a kill is skipped
    assert psnr_epochs(str(log_dir)) == [1, 2]
    writer.close()


def test_write_pack_is_seeded_and_kept(tmp_path):
    """The soak's pack: seeded uint8 patches in the packed archive's format,
    written once and kept while its shape fits."""
    from srgan_st_tpu_torch.data.pipeline import PackedPatchSource
    from srgan_st_tpu_torch.tools.soak import write_pack

    path = str(tmp_path / "train" / "patches.pack.npy")
    write_pack(path, 10, size=96, seed=3)
    first = np.load(path)
    assert first.shape == (10, 96, 96, 3) and first.dtype == np.uint8
    mtime = os.stat(path).st_mtime_ns
    write_pack(path, 10, size=96, seed=3)
    assert os.stat(path).st_mtime_ns == mtime
    write_pack(str(tmp_path / "again.npy"), 10, size=96, seed=3)
    assert np.array_equal(np.load(tmp_path / "again.npy"), first)
    source = PackedPatchSource(path, 2, seed=0, device_cache=False)
    assert len(source) == 5 and next(iter(source.epoch(0))).shape == (2, 96, 96, 3)
