"""The port's utils (srgan_st_tpu_torch/utils/) and the `doctor` command,
on the CPU: the counterparts of tests/test_utils.py (finite checks)
and tests/test_tpu_health.py (the verdicts, on synthetic probe results)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# profiling

def test_trace_context_writes_a_trace_and_none_is_a_no_op(tmp_path):
    from srgan_st_tpu_torch.utils.profiling import trace_context

    with trace_context(None):
        torch.ones(4).sum()
    assert not os.listdir(tmp_path)
    log_dir = tmp_path / "trace"
    with trace_context(str(log_dir)):
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    with open(log_dir / "trace.json") as f:
        trace = json.load(f)
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


# ---------------------------------------------------------------------------
# debugging

def test_check_finite_tree_raises_with_the_key_path():
    from srgan_st_tpu_torch.utils.debugging import check_finite_tree

    ok = {"a": np.ones(3, np.float32), "b": {"c": torch.zeros(2)}, "n": torch.arange(3)}
    check_finite_tree(ok)  # no raise
    bad = {"a": np.ones(3, np.float32), "b": {"c": torch.tensor([1.0, float("nan")])}}
    with pytest.raises(FloatingPointError, match=r"\['b'\]\['c'\]"):
        check_finite_tree(bad, "state")
    with pytest.raises(FloatingPointError, match=r"\['x'\]\[1\]"):
        check_finite_tree({"x": [1.0, np.array([np.inf])]})


def test_check_finite_tree_takes_a_state_dict():
    from srgan_st_tpu_torch.utils.debugging import check_finite_tree

    model = torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.BatchNorm1d(2))
    check_finite_tree(model.state_dict(), "model")
    with torch.no_grad():
        model[1].running_var[1] = float("inf")
    with pytest.raises(FloatingPointError, match="running_var"):
        check_finite_tree(model.state_dict(), "model")


def test_nan_guard_passes_through_and_warns_on_a_nan(capsys):
    from srgan_st_tpu_torch.utils.debugging import nan_guard

    def step(state, x):
        return state + 1, {"loss": torch.as_tensor(x).sum()}

    guarded = nan_guard(step)
    state, metrics = guarded(0, torch.ones(3))
    assert state == 1 and float(metrics["loss"]) == 3.0
    assert "non-finite" not in capsys.readouterr().out
    guarded(state, torch.tensor([1.0, float("nan")]))
    guarded.flush()
    assert capsys.readouterr().out.count("WARNING: non-finite training metrics") == 1


def test_all_finite_makes_no_host_value():
    from srgan_st_tpu_torch.utils.debugging import all_finite

    flag = all_finite({"a": torch.ones(()), "b": torch.tensor(float("inf"))})
    assert torch.is_tensor(flag) and flag.dtype == torch.bool and not bool(flag)


# ---------------------------------------------------------------------------
# doctor (utils/cuda_health.py)

def _ok(init_s=2.0, matmul_s=0.05):
    return {"ok": True, "init_s": init_s, "matmul_s": matmul_s, "device": "GPU",
            "count": 1, "error": None}


def _fail(seconds, error="RuntimeError: CUDA error: no CUDA-capable device is detected"):
    return {"ok": False, "init_s": None, "matmul_s": None, "device": None, "count": None,
            "error": error, "seconds": seconds}


def test_healthy_gpu():
    from srgan_st_tpu_torch.utils.cuda_health import diagnose

    assert diagnose([_ok()]).startswith("USABLE (")


def test_slow_probe_is_flagged():
    from srgan_st_tpu_torch.utils.cuda_health import diagnose

    assert "slow" in diagnose([_ok(init_s=90.0)])


def test_failure_reports_the_error_verbatim():
    from srgan_st_tpu_torch.utils.cuda_health import diagnose

    v = diagnose([_fail(2.0)])
    assert v.startswith("UNAVAILABLE") and "no CUDA-capable device is detected" in v


def test_constant_or_varying_failure_times_are_never_a_wedge():
    """The TPU probe's wedge verdict (a constant ~25 min claim timeout) is a
    pooled TPU runtime's matter: a GPU's failures are reported as they are."""
    from srgan_st_tpu_torch.utils.cuda_health import diagnose

    for results in ([_fail(1505.0), _fail(1501.0), _fail(1502.0)],
                    [_fail(700.0), _fail(1400.0)]):
        v = diagnose(results)
        assert v.startswith("UNAVAILABLE") and "WEDGED" not in v


def test_a_later_usable_probe_decides():
    from srgan_st_tpu_torch.utils.cuda_health import diagnose

    assert diagnose([_fail(3.0), _ok()]).startswith("USABLE")


def test_probe_without_cuda_records_the_error():
    """On a machine without a usable GPU the probe's child reports ok False
    with its error and the probe does not raise."""
    from srgan_st_tpu_torch.utils.cuda_health import probe

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    r = probe()
    assert r["ok"] is False and r["error"] and r["seconds"] > 0


def _doctor(*args):
    return subprocess.run([sys.executable, "-m", "srgan_st_tpu_torch", "doctor", *args],
                          capture_output=True, text=True, cwd=ROOT, timeout=300)


def test_doctor_json_exits_1_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    proc = _doctor("--json")
    assert proc.returncode == 1
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ok"] is False and out["verdict"].startswith("UNAVAILABLE")
    assert len(out["probes"]) == 1 and out["probes"][0]["error"]


def test_doctor_rejects_patient():
    """--patient holds a pooled TPU runtime's claim: no GPU counterpart."""
    proc = _doctor("--patient", "60")
    assert proc.returncode == 2 and "--patient" in proc.stderr


def test_doctor_is_a_command():
    from srgan_st_tpu_torch.__main__ import _COMMANDS

    assert _COMMANDS["doctor"][:2] == ("srgan_st_tpu_torch.utils.cuda_health", "main")
    assert "bench" not in _COMMANDS
