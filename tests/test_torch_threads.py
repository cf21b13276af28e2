"""The thread policy of the port's CPU tests (tests/torch_threads.py): a test
process's share of the cores, and the part of it a process that a test
starts takes."""

import os
import subprocess
import sys

import pytest
import torch

from tests import torch_threads


@pytest.mark.parametrize("cores,environ,want", [
    (8, {"PYTEST_XDIST_WORKER_COUNT": "6"}, 1),
    (8, {"PYTEST_XDIST_WORKER_COUNT": "1"}, 8),
    (2, {"PYTEST_XDIST_WORKER_COUNT": "6"}, 1),
    (64, {"PYTEST_XDIST_WORKER_COUNT": "6"}, 10),
    (8, {}, 8)])
def test_share_is_the_cores_over_the_workers(cores, environ, want):
    """The cores over the xdist workers, at least one; outside xdist (no
    worker count) every core."""
    assert torch_threads.share(cores, environ) == want


def test_this_process_runs_on_its_share():
    """Importing the helper set this process's torch to its share of the
    cores it may run on."""
    assert torch_threads.THREADS == torch_threads.share()
    assert torch.get_num_threads() == torch_threads.THREADS


@pytest.mark.parametrize("processes,most", [(1, None), (2, None), (10 ** 6, None), (1, 1),
                                            (2, 10 ** 6)])
def test_started_env_splits_the_share(processes, most):
    """One variable: the share over the processes, at least 1, at most
    `most` (the next test shows that torch reads it)."""
    threads = max(1, torch_threads.THREADS // processes)
    (value,) = torch_threads.started_env(processes, most).values()
    assert int(value) == (threads if most is None else min(threads, most))


def test_a_started_process_runs_on_its_part_of_the_share():
    """A process started with `started_env` runs torch on that many
    threads."""
    env = {**os.environ, **torch_threads.started_env(2)}
    out = subprocess.run([sys.executable, "-c", "import torch; print(torch.get_num_threads())"],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) == max(1, torch_threads.THREADS // 2)
