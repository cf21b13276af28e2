"""What every cell's run shares: finding its files by name, the card
check, the cache directories, the program's configuration and the
prologue on the card, the per-layer readers, the checks and the result
line.

A cell `workloads/<cell>.json` names its configuration
(`configs/<config>.json`) and its traffic mix (`traffic/<traffic>.json`),
and the mix names its driver (`drivers/<driver>.py`), a module with
`run(ctx) -> dict`. Each per-layer metric is a reader
`metrics/<metric>.py` with LAYER, UNIT, MOVES and `read(record)`, which
returns None where the traced record holds nothing for it. New cells,
configurations, mixes and metrics are new files."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# the program's build and compile caches: fixed directories in the checkout
CACHE = os.path.join(ROOT, "build", "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "srgan_st_tpu")


def load_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclass
class Ctx:
    """One run: the cell's files, its seed and window, and where it runs."""

    cell: str
    workload: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    t0: float = 0.0


def load_ctx(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: float = 0.0) -> Ctx:
    workload = load_json("workloads", f"{cell}.json")
    return Ctx(cell, workload, load_json("configs", f"{workload['config']}.json"),
               load_json("traffic", f"{workload['traffic']}.json"), seed, seconds, trace,
               device, t0)


def driver(ctx: Ctx):
    name = ctx.traffic["driver"]
    return load_module(os.path.join(HERE, "drivers", f"{name}.py"), f"benchmark_driver_{name}")


def sync(dev) -> None:
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


def program_config(cfg: dict):
    """The program's Config for a configuration file."""
    from srgan_st_tpu_torch.core.config import Config

    c = Config()
    c.DATA.UPSCALE_FACTOR = cfg["upscale_factor"]
    c.DATA.GT_IMAGE_SIZE = cfg["gt_image_size"]
    c.DATA.BATCH_SIZE = cfg["batch_size"]
    c.MODEL.G_IN_CHANNEL, c.MODEL.G_OUT_CHANNEL = cfg["g_in_channels"], cfg["g_out_channels"]
    c.MODEL.G_N_CHANNEL, c.MODEL.G_N_RCB = cfg["g_channels"], cfg["g_num_rcb"]
    c.MODEL.D_IN_CHANNEL, c.MODEL.D_OUT_CHANNEL = cfg["d_in_channels"], cfg["d_out_channels"]
    c.MODEL.D_N_CHANNEL = cfg["d_channels"]
    loss = c.MODEL.G_LOSS

    def specs(criteria):
        return ({n: {k: v for k, v in s.items() if k != "weight"} for n, s in criteria.items()},
                {n: float(s["weight"]) for n, s in criteria.items()})

    loss.CRITERIONS, loss.CRITERION_WEIGHTS = specs(cfg["criteria"])
    loss.WARMUP_CRITERIONS, loss.WARMUP_WEIGHTS = specs(cfg["warmup_criteria"])
    loss.DISC_FEATURES_LOSS_LAYERS = dict(cfg["content_disc_taps"])
    c.EXP.LABEL_SMOOTHING = cfg["label_smoothing"]
    s = c.SOLVER
    s.D_UPDATE_INTERVAL = cfg["d_update_interval"]
    for net in ("G", "D"):
        a = cfg[f"{net.lower()}_adam"]
        s[f"{net}_BASE_LR"], s[f"{net}_BETA1"], s[f"{net}_BETA2"], s[f"{net}_EPS"] = (
            a["lr"], a["beta1"], a["beta2"], a["eps"])
        s[f"{net}_WEIGHT_DECAY"] = 0.0
    c.SCHEDULER.MILESTONES = []  # the window is a slice of the first epochs
    c.TPU.COMPUTE_DTYPE = cfg["compute_dtype"]
    c.TPU.TRUNK_MODE = cfg["trunk_mode"]
    c.TPU.TAIL_MODE = cfg["tail_mode"]
    return c


def start(dev) -> float:
    """The prologue of every run on the card: the check that the program's
    kernels are built (the first run in a checkout builds them), then a
    fresh count of peak memory. Returns its seconds."""
    if dev.type != "cuda":
        return 0.0
    import torch
    from srgan_st_tpu_torch.kernels import _build

    t = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t
    torch.cuda.reset_peak_memory_stats(dev)
    return build_s


def set_cache_dirs() -> None:
    """Compile caches of anything the program may build (Triton, torch
    extensions, the CUDA JIT) in fixed directories of the checkout; the
    port's own kernels build into build/kernels (kernels/_build.py)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_jit")):
        os.environ[var] = os.path.join(CACHE, sub)


def require_cards(chips: int) -> None:
    """Exit 4, printing no result, without `chips` CUDA devices."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: needs {chips} CUDA device(s), found {n}", file=sys.stderr)
        raise SystemExit(4)


def card_record() -> dict:
    """The card's name and power limit as nvidia-smi gives them (the
    fields of `device_record` in srgan_st_tpu_torch/utils/profiling.py): a
    card set below its maximum runs slower under load. None where
    nvidia-smi gives nothing."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
        name, limit = (s.strip() for s in out.strip().splitlines()[0].rsplit(",", 1))
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return {"name": None, "power_limit_w": None}
    try:
        watts = float(limit.split()[0])
    except (ValueError, IndexError):
        watts = None
    return {"name": name, "power_limit_w": watts}


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def readers() -> dict:
    d = os.path.join(HERE, "metrics")
    return {f[:-3]: load_module(os.path.join(d, f), f"benchmark_metric_{f[:-3]}")
            for f in sorted(os.listdir(d)) if f.endswith(".py")}


def per_layer(record: dict) -> dict:
    """Every reader's value on the traced record, where it finds one."""
    out = {}
    for name, mod in readers().items():
        value = mod.read(record)
        if value is not None:
            out[name] = {"value": value, "unit": mod.UNIT}
    return out


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """correct: every reading within its limit (a missing or non-finite one
    fails); the checks as {name: {"value", "limit"}}."""
    import math

    checks = {}
    ok = True
    for name, limit in limits.items():
        value = readings.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value, "limit": limit}
    return ok, checks


def emit(result: dict) -> int:
    """Print the checks as the last lines of stderr and the result as the
    last line of stdout, unless a forbidden module is loaded: then name it
    and print no result (exit 5)."""
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 5
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
