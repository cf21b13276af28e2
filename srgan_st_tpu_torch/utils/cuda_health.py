"""GPU health probe: can this process use the CUDA device, and if not,
why? (the port's counterpart of srgan_st_tpu/utils/tpu_health.py, behind
``python -m srgan_st_tpu_torch doctor``).

Each probe runs in a clean child process, so that a broken CUDA context
cannot outlive it and a retry starts from nothing: CUDA initialization
(its seconds), the device's name and count, then a small matmul followed by
`synchronize` (its seconds). The child reports one JSON line; a failure,
the child's own crash or timeout included, is recorded verbatim in the
result rather than raised.

Usage:
    python -m srgan_st_tpu_torch doctor                 # one probe, a verdict
    python -m srgan_st_tpu_torch doctor --retries 3 --spacing 10
    python -m srgan_st_tpu_torch doctor --json          # one JSON line

Exit code 0: the GPU is usable; 1: it is not.

The TPU probe's `--patient` mode and its "wedged claim" verdict are about a
pooled TPU runtime's session grants, which a local CUDA device does not
have: `--patient` is rejected, and failures at any times are reported as
they are, never as a wedge.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# a probe that takes longer than this (CUDA init plus the matmul) is "slow"
SLOW_S = 60.0

_CHILD = r"""
import json, time
out = {"ok": False, "init_s": None, "matmul_s": None, "device": None, "count": None,
       "error": None}
t0 = time.perf_counter()
try:
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    torch.cuda.init()
    out["count"] = torch.cuda.device_count()
    out["device"] = torch.cuda.get_device_name(0)
    out["init_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    a = torch.ones((256, 256), device="cuda")
    s = float((a @ a).sum())
    torch.cuda.synchronize()
    out["matmul_s"] = time.perf_counter() - t1
    if s != 256.0 ** 3:
        raise RuntimeError(f"the matmul's sum is {s}, not {256.0 ** 3}")
    out["ok"] = True
except Exception as e:
    out["error"] = f"{type(e).__name__}: {e}"
print(json.dumps(out), flush=True)
"""


def probe(timeout: float = 600.0) -> dict:
    """One probe in a clean child process. Returns its result dict (with
    `seconds`, the child's wall time); a failure to start, a timeout or an
    unreadable report is recorded, not raised."""
    t0 = time.perf_counter()
    result = {"ok": False, "init_s": None, "matmul_s": None, "device": None,
              "count": None, "error": None}
    try:
        proc = subprocess.run([sys.executable, "-c", _CHILD], capture_output=True,
                              text=True, timeout=timeout)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
        if lines:
            result.update(json.loads(lines[-1]))
        else:
            tail = (proc.stderr or proc.stdout).strip().splitlines()[-3:]
            result["error"] = (f"the probe process exited with code {proc.returncode}: "
                               + " | ".join(tail))
    except (OSError, ValueError, subprocess.SubprocessError) as e:
        result["error"] = f"{type(e).__name__}: {e}"
    result["seconds"] = time.perf_counter() - t0
    return result


def diagnose(results: list[dict]) -> str:
    """The verdict from one or more probe results (the last decides)."""
    last = results[-1]
    if last["ok"]:
        took = (last["init_s"] or 0.0) + (last["matmul_s"] or 0.0)
        what = (f"{last['device']} x{last['count']}, CUDA init {last['init_s']:.2f}s, "
                f"matmul {last['matmul_s']:.3f}s")
        if took > SLOW_S:
            return (f"USABLE but slow ({what}): another process may hold the device, "
                    "or the CUDA driver is still initializing")
        return f"USABLE ({what})"
    fails = [r for r in results if not r["ok"]]
    if len(fails) > 1:
        return (f"UNAVAILABLE: {len(fails)} failed probes, the last: {last['error']}")
    return f"UNAVAILABLE: {last['error']}"


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Probe whether the CUDA device is usable, each probe in a clean "
        "child process, and give a verdict.")
    parser.add_argument("--retries", type=int, default=1,
                        help="most probes to make (default 1); stops at the first usable")
    parser.add_argument("--spacing", type=float, default=10.0,
                        help="seconds between probes")
    parser.add_argument("--json", action="store_true",
                        help="print one JSON line instead of prose")
    parser.add_argument("--patient", type=int, default=None, metavar="SECONDS",
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.patient is not None:
        parser.error("--patient holds a pooled TPU runtime's claim; a CUDA device "
                     "has no claim to hold (see the module docstring)")

    results: list[dict] = []
    for i in range(max(1, args.retries)):
        if i:
            time.sleep(args.spacing)
        r = probe()
        results.append(r)
        if not args.json:
            status = "ok" if r["ok"] else f"fail ({r['error']})"
            print(f"probe {i + 1}/{args.retries}: {status} after {r['seconds']:.1f}s",
                  flush=True)
        if r["ok"]:
            break
    verdict = diagnose(results)
    if args.json:
        print(json.dumps({"ok": results[-1]["ok"], "verdict": verdict, "probes": results}))
    else:
        print(verdict)
    sys.exit(0 if results[-1]["ok"] else 1)


if __name__ == "__main__":
    main()
