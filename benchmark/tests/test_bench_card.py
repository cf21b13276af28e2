"""The benchmark's command on the card: a short run of each cell of
BENCHMARK.json prints one result line with every key, and `correct`
true. Marked `cuda`; skips without a card (decided inside the fixture).
Run on the card with `python -m pytest benchmark/tests/test_bench_card.py`."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = tuple(w["name"] for w in json.load(f)["workloads"])


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def run(cell: str, trace: int) -> dict:
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                           str(2**31 + 7), "--seconds", "2", "--trace", str(trace)],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct_and_complete(card, cell):
    out = run(cell, 0)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert list(out)[-1] == "checks"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_its_layers(card, cell):
    out = run(cell, 1)
    assert out["correct"]
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    for name, m in out["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 105, name
    assert out["breakdown"]["device_ops"] and out["breakdown"]["idle_gaps"]
