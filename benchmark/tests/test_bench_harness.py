"""The harness's exits: no card, a forbidden module, and the result line's
shape."""

import json
import os
import subprocess
import sys
import types

from benchmark import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_without_a_card_the_command_exits_non_zero_and_prints_no_result():
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "srgan_x4.gan",
                           "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and proc.stdout == ""


def test_a_forbidden_module_loaded_prints_no_result(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", types.ModuleType("jaxlib.xla_client"))
    assert harness.emit({"checks": {}}) != 0
    out = capsys.readouterr()
    assert out.out == "" and "jaxlib.xla_client" in out.err


def test_the_port_is_not_forbidden(monkeypatch):
    monkeypatch.setitem(sys.modules, "srgan_st_tpu_torch_like", types.ModuleType("x"))
    assert "srgan_st_tpu_torch_like" not in harness.forbidden_modules()


def test_checks_come_last_on_both_streams(capsys):
    result = {"correct": True, "metrics": {}, "checks": {"loss_gap": {"value": 0.1, "limit": 1}}}
    assert harness.emit(result) == 0
    out = capsys.readouterr()
    assert list(json.loads(out.out.strip().splitlines()[-1]))[-1] == "checks"
    assert out.err.strip().splitlines()[-1] == "check loss_gap = 0.1 (limit 1)"


def test_judge_fails_a_missing_or_non_finite_reading():
    ok, checks = harness.judge({"a": 0.5, "b": float("nan")}, {"a": 1.0, "b": 1.0, "c": 1.0})
    assert not ok and checks["a"] == {"value": 0.5, "limit": 1.0}
    assert harness.judge({"a": 0.5}, {"a": 1.0})[0]
