"""The port's examples on the CPU: the loss-sensitivity study
(`srgan_st_tpu_torch/tools/loss_study.py`, front end
examples/loss_study_torch.py) against the JAX script examples/loss_study.py,
and the array-job and multi-process launchers
(examples/train_array_job_torch.sh, examples/train_multihost_torch.sh).
"""

import importlib.util
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests.torch_threads import started_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
BUDDY = ("BestBuddy", "Gram", "PatchwiseST")


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_loss_study", os.path.join(EXAMPLES, "loss_study.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_table(gt, strengths, picks):
    """examples/loss_study.py's loop: its PERTURBATIONS and losses, one
    default_rng(0) for every call, the JAX package's f32 XLA path; the bank
    rows its buddy selection picks are appended to `picks`, call by call."""
    from srgan_st_tpu.losses import functions as JF
    from srgan_st_tpu.ops.pairwise import batch_pairwise_distance

    def select(p1, p2, bank, alpha, beta, dist_norm, pallas=None):
        score = alpha * batch_pairwise_distance(p1, bank, dist_norm) + beta * (
            batch_pairwise_distance(p2, bank, dist_norm))
        picks.append(torch.from_numpy(np.array(jnp.argmin(score, axis=2))))
        return real(p1, p2, bank, alpha, beta, dist_norm, pallas=False)

    real, JF._buddy_select = JF._buddy_select, select
    try:
        losses = {"Pixel": JF.pixel_loss, "BestBuddy": JF.best_buddy_loss,
                  "Gram": JF.gram_loss, "PatchwiseST": JF.patchwise_st_loss, "ST": JF.st_loss}
        rng, gt_j, table = np.random.default_rng(0), jnp.asarray(gt), {}
        for pname, pfn in _jax_script().PERTURBATIONS.items():
            table[pname] = {
                lname: [float(lfn(jnp.asarray(pfn(gt, s, rng).astype(np.float32)), gt_j))
                        for s in strengths] for lname, lfn in losses.items()}
    finally:
        JF._buddy_select = real
    return table


def _tol(lname, value):
    """test_torch_losses.py's parity rule against the JAX package: 2e-4
    (PatchwiseST) or 1e-5, absolute below 1 and relative above."""
    return (2e-4 if lname == "PatchwiseST" else 1e-5) * max(1.0, abs(value))


def test_loss_table_matches_the_jax_script(monkeypatch):
    """loss_table on the script's synthetic 96x96 patch and default strengths
    equals the JAX script's values within the parity rule, in the same loop
    order (the noise draws per loss included). An entry outside it must be a
    buddy loss whose selection differs from the JAX script's only at near
    ties: the rows either picks score within 1e-6 of the f64 minimum (the
    features of the two frameworks differ in their last bits, and the port
    rescores its two best rows in f64, a pinned divergence). On this patch
    they are BestBuddy and Gram under the 12 px shift (four patch strides:
    exact duplicates) and under the quarter turn."""
    from srgan_st_tpu_torch.kernels._checks import f64_scores, near_tie_agrees
    from srgan_st_tpu_torch.kernels.buddy_select import buddy_select_index, gather_rows
    from srgan_st_tpu_torch.losses import functions as F
    from srgan_st_tpu_torch.tools import loss_study as L

    gt = L.synthetic_patch()
    assert L.PERTURBATIONS.keys() == _jax_script().PERTURBATIONS.keys()
    jax_picks = []
    want = _jax_table(gt, L.STRENGTHS, jax_picks)
    jax_calls, log = iter(jax_picks), []

    def select(p1, p2, bank, alpha, beta, dist_norm, pallas=None):
        idx, jidx = buddy_select_index(p1, p2, bank, alpha, beta, dist_norm), next(jax_calls)
        f64 = f64_scores(p1, p2, bank, alpha, beta, dist_norm)
        log.append({"differs": bool((idx != jidx).any()),
                    "near_tie": bool(near_tie_agrees(idx, jidx, f64).all()
                                     and near_tie_agrees(jidx, idx, f64).all())})
        return gather_rows(bank, idx)

    monkeypatch.setattr(F, "_buddy_select", select)
    got = L.loss_table(gt, L.STRENGTHS, np.random.default_rng(0), "cpu")
    assert got.keys() == want.keys() and next(jax_calls, None) is None
    calls, ties = iter(log), []
    for pname in want:
        assert got[pname].keys() == want[pname].keys()
        for lname, values in want[pname].items():
            for i, v in enumerate(values):
                call = next(calls) if lname in BUDDY else None
                if abs(got[pname][lname][i] - v) <= _tol(lname, v):
                    continue
                assert call is not None and call["differs"] and call["near_tie"], (
                    pname, lname, L.STRENGTHS[i], got[pname][lname][i], v, call)
                ties.append((pname, lname, L.STRENGTHS[i]))
    assert next(calls, None) is None
    assert {(p, l) for p, l, _ in ties} <= {(p, l) for p in ("shift", "rotation")
                                           for l in ("BestBuddy", "Gram")}, ties


def test_loss_study_front_end_draws_the_figure(tmp_path):
    """examples/loss_study_torch.py on the CPU writes the figure; matplotlib
    is imported only there, and the study's module imports neither it nor
    PIL."""
    out = subprocess.run(
        [sys.executable, os.path.join(EXAMPLES, "loss_study_torch.py"), "--device", "cpu",
         "--out", str(tmp_path), "--strengths", "0", "0.5"],
        capture_output=True, text=True, timeout=240, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert os.path.getsize(tmp_path / "loss_study.png") > 1000
    code = ("import sys, srgan_st_tpu_torch.tools.loss_study; "
            "print([m for m in ('PIL', 'matplotlib') if m in sys.modules])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=REPO)
    assert out.stdout.strip() == "[]", out.stderr


def test_loss_table_needs_a_gpu_unless_the_cpu_is_asked_for(monkeypatch):
    from srgan_st_tpu_torch.tools import loss_study as L

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        L.loss_table(L.synthetic_patch())


def _stub_python(tmp_path):
    """A `python` first on PATH that prints its arguments and job_index."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    stub = bin_dir / "python"
    stub.write_text('#!/bin/sh\necho "ARGS $* JOB ${job_index:-unset}"\n')
    stub.chmod(0o755)
    return {**os.environ, "PATH": f"{bin_dir}{os.pathsep}{os.environ['PATH']}"}


@pytest.mark.parametrize("env,job", [({}, "0"), ({"job_index": "4"}, "4"),
                                     ({"SLURM_ARRAY_TASK_ID": "3"}, "3"),
                                     ({"LSB_JOBINDEX": "2"}, "1")])
def test_array_job_launcher_runs_the_port(tmp_path, env, job):
    """examples/train_array_job_torch.sh passes `bash -n` and runs `python -m
    srgan_st_tpu_torch run` with its arguments, job_index from SLURM's array
    task id, LSF's 1-based index, or the plain variable (default 0), as
    examples/train_array_job.sh does for the JAX package."""
    script = os.path.join(EXAMPLES, "train_array_job_torch.sh")
    assert subprocess.run(["bash", "-n", script]).returncode == 0
    base = {k: v for k, v in _stub_python(tmp_path).items()
            if k not in ("job_index", "SLURM_ARRAY_TASK_ID", "LSB_JOBINDEX")}
    out = subprocess.run(["bash", script, "--device", "cpu"], env={**base, **env},
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert f"starting job_index={job}" in out.stdout
    assert f"ARGS -m srgan_st_tpu_torch run --device cpu JOB {job}" in out.stdout


def test_multihost_launcher_starts_two_local_ranks(tmp_path):
    """examples/train_multihost_torch.sh with LOCAL_PROCESSES=2 starts two
    processes that join one group through the SRGAN_ST_* variables: a tiny
    job script prints its rank, the world size and the backend (gloo on the
    CPU). The sample job in its comments uses LOCAL_BN and the packed
    trunk, and no TPU.SHARD_MAP."""
    script = os.path.join(EXAMPLES, "train_multihost_torch.sh")
    assert subprocess.run(["bash", "-n", script]).returncode == 0
    text = open(script).read()
    assert "config.TPU.LOCAL_BN = True" in text and 'TRUNK_MODE = "packed"' in text
    assert "config.TPU.SHARD_MAP" not in text
    job = tmp_path / "job.py"
    job.write_text(
        "import os\n"
        "import torch.distributed as dist\n"
        "from srgan_st_tpu_torch.parallel.distributed import initialize_distributed, "
        "process_info\n"
        "assert initialize_distributed(device='cpu')\n"
        "rank, world = process_info()\n"
        "os.write(1, f'RANK {rank} {world} {dist.get_backend()}\\n'.encode())  # one write\n"
        "dist.barrier()\n"
        "dist.destroy_process_group()\n")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {**os.environ, **started_env(2), "LOCAL_PROCESSES": "2", "COORDINATOR_PORT": str(port),
           "PYTHONPATH": os.pathsep.join(p for p in (REPO, os.environ.get("PYTHONPATH")) if p)}
    env = {k: v for k, v in env.items() if not k.startswith("SRGAN_ST_")}
    out = subprocess.run(["bash", script, str(job)], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert sorted(ln for ln in out.stdout.splitlines() if ln.startswith("RANK")) == [
        "RANK 0 2 gloo", "RANK 1 2 gloo"]
