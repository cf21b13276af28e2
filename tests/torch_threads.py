"""How many threads the port's CPU tests take: one policy, applied on import.

The suite runs in several pytest-xdist workers on one machine. Left alone,
each worker's torch keeps one OpenMP thread per core, so the workers'
threads outnumber the cores many times over and small CPU ops spin against
each other: a replay that takes 7 s alone takes minutes beside five others.
Importing this module gives this process its share of the cores it may run
on, the cores over the workers, at least one; a file run by hand, outside
xdist, keeps every core. Every `test_torch_*.py` imports it before any
torch work, and since each worker collects every test module at its start,
the share holds for all torch work in the worker. A process that a test
starts takes its part of the share through `started_env`.
"""

import os

import torch


def share(cores: int | None = None, environ=os.environ) -> int:
    """The threads of one test process: `cores` (default: the cores this
    process may run on) over the xdist workers that `environ` names (1
    outside xdist), at least 1."""
    if cores is None:
        cores = len(os.sched_getaffinity(0))
    return max(1, cores // int(environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))


THREADS = share()
torch.set_num_threads(THREADS)


def started_env(processes: int = 1, most: int | None = None) -> dict[str, str]:
    """The variables to add to the environment of a process a test starts
    beside `processes - 1` others like it: this process's share split
    among them, at least one thread each, and at most `most` where a
    comparison's numbers hold only up to that many threads."""
    threads = max(1, THREADS // processes)
    return {"OMP_NUM_THREADS": str(threads if most is None else min(threads, most))}
