"""Kill/resume soak of the training loops (the port's counterpart of
tools/soak_two_stage.py).

    python -m srgan_st_tpu_torch.tools.soak [--root DIR] [--patches 12800]
        [--warmup-epochs 10] [--epochs 10] [--kill-epoch 5] [--device cuda|cpu]
        [--set GROUP.FIELD=value ...]

The production recipe at full width from a seeded uint8 pack on disk: the
warmup (Pixel), then the GAN phase (Adversarial 0.001 + Pixel 1 +
PatchwiseST 100 + ContentDiscriminator 2000, G_CONTINUE_FROM_WARMUP from
the warmup's g_best.npz); batch 16 of 96x96 GT, x4, bf16, the bf16 training
auto trunk ("packed"), steps replayed from CUDA graphs (the default on
CUDA), a log line and a chunk every 10 batches. Validation runs on the
seeded synthetic pairs: the phase script patches `make_test_pairs` (the
card machine has no PIL to decode a test set). Each phase runs as a
subprocess, so that a kill is a real SIGKILL:

  reference  the GAN phase, uninterrupted;
  state_pt   the default `.state.pt` train states: SIGKILLed after three
             logged batch lines of GAN epoch --kill-epoch (1-based, as
             printed), then relaunched with the same config
             (EXP.AUTO_RESUME);
  dcp        EXP.ORBAX_CHECKPOINTS (DCP directories): SIGKILLed, from epoch
             --kill-epoch on, as soon as a `.distcp` file of `last` is being
             written for which no newer `.metadata` exists (read from the
             disk every 2 ms); the kill must have cut the save (the whole
             `last/` still holds the epoch before), else the next epoch's
             save is tried, three times at most; then relaunched.

After the warmup, the uninterrupted run goes first (the killed cases end
at its weights), then the killed cases side by side. Each killed case is
held to: the relaunch prints `resuming at epoch k`, k the epoch of the
restored step; the scalar log (scalars.jsonl) holds Test/PSNR for every
epoch; `_policy.json`'s best PSNR never decreased; the checkpoint set is
complete and no temporary directory is left; the final g_last.npz and
d_last.npz equal the reference's bit for bit. On CUDA every training child
must have launched kernel A, K4 and K5, and every GAN child K7 as well (the
launch counts each child prints as an epoch starts and at its end, graph
replays included). Runs on CUDA unless `--device cpu`; the kernels
are built before the children start, so that no child runs nvcc. Prints
one JSON report, writes it to <root>/SOAK_REPORT.json, and exits non-zero
when a check failed.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CASES = ("state_pt", "dcp")
TRAIN_KERNELS = ("coarse_conv_s2d", "packed_trunk_fwd", "packed_trunk_bwd")  # A, K4, K5
GAN_KERNELS = TRAIN_KERNELS + ("buddy_select",)  # and K7, PatchwiseST's selection
_ATTEMPTS = 3  # saves of `last` the dcp case tries to cut
_KILL_LINES = 3  # logged batch lines of the kill epoch before the state_pt kill

# One phase, run by `python -u -c` with its settings in $SOAK_CONFIG.
PHASE_SCRIPT = r'''
import json, os, sys
sys.modules["tensorboardX"] = None  # the scalar log goes to scalars.jsonl
cfg = json.loads(os.environ["SOAK_CONFIG"])
from srgan_st_tpu_torch import kernels
from srgan_st_tpu_torch.core.config import Config, apply_overrides
from srgan_st_tpu_torch.data import pipeline
from srgan_st_tpu_torch.train import train as gan_loop, warmup as warmup_loop
from srgan_st_tpu_torch.train.utils import make_test_pairs

config = Config()
config.EXP.NAME = cfg["name"]
config.EXP.N_EPOCHS = cfg["epochs"]
config.EXP.ORBAX_CHECKPOINTS = cfg["orbax"]
config.DATA.SYNTHETIC = False
config.DATA.TRAIN_GT_IMAGES_DIR = cfg["train_dir"]
config.TPU.COMPUTE_DTYPE = "bfloat16"
config.LOG_TRAIN_PERIOD = 10
config.TPU.CHUNK_STEPS = 10
if cfg["phase"] == "gan":
    config.add_g_criterion("Pixel", {"kind": "pixel"}, 1.0)
    config.add_g_criterion("PatchwiseST", {"kind": "patchwise_st"}, 100.0)
    config.add_g_criterion("ContentDiscriminator", {"kind": "content_disc"}, 2000.0)
    config.MODEL.G_CONTINUE_FROM_WARMUP = True
    config.MODEL.G_WARMUP_WEIGHTS = cfg["warmup_weights"]
config = apply_overrides(config, cfg["sets"])


class Counted:
    """The training source, printing the launch counts as each epoch starts."""

    def __init__(self, source):
        self.source = source

    def __len__(self):
        return len(self.source)

    def epoch(self, epoch_idx=None):
        print("LAUNCHES " + json.dumps(kernels.launch_counts()), flush=True)
        return self.source.epoch(epoch_idx)


def source(config, device=None):
    return Counted(pipeline.make_train_source(config, device))


def pairs(config):  # the seeded synthetic pairs
    synthetic = Config()
    synthetic.DATA.SYNTHETIC = True
    return make_test_pairs(synthetic)


loop = warmup_loop if cfg["phase"] == "warmup" else gan_loop
loop.make_train_source, loop.make_test_pairs = source, pairs
(loop.warmup if cfg["phase"] == "warmup" else loop.train)(config, device=cfg["device"])
print("LAUNCHES " + json.dumps(kernels.launch_counts()), flush=True)
print("PHASE_DONE", flush=True)
'''


def write_pack(path: str, n: int, size: int = 96, seed: int = 0) -> None:
    """A seeded uint8 (n, size, size, 3) `patches.pack.npy` (the packed
    archive's format, `data/pipeline.py` PackedPatchSource); kept when one
    of that shape is there."""
    if os.path.exists(path) and np.load(path, mmap_mode="r").shape == (n, size, size, 3):
        return
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.default_rng(seed)
    pack = np.lib.format.open_memmap(path + ".tmp", mode="w+", dtype=np.uint8,
                                     shape=(n, size, size, 3))
    for i in range(0, n, 1024):
        pack[i:i + 1024] = rng.integers(0, 256, (min(1024, n - i), size, size, 3), np.uint8)
    pack.flush()
    del pack
    os.replace(path + ".tmp", path)


class Child:
    """One phase as a subprocess, its output read line by line on a thread
    with the seconds since its start."""

    def __init__(self, root: str, cfg: dict):
        env = dict(os.environ, SOAK_CONFIG=json.dumps(cfg), PYTHONPATH=os.pathsep.join(
            p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p))
        self.name, self.lines = cfg["name"], []
        self.wall_start = time.time_ns()
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen([sys.executable, "-u", "-c", PHASE_SCRIPT], cwd=root,
                                     env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.lines.append((time.perf_counter() - self.t0, line.rstrip("\n")))

    def run(self, kill_when=None, timeout: float = 3600.0) -> dict:
        """Wait for the child; SIGKILL it as soon as `kill_when(self)` is true
        (polled every 2 ms), or when `timeout` s have passed."""
        killed = timed_out = False
        while self.proc.poll() is None:
            if kill_when is not None and kill_when(self):
                self.proc.kill()
                killed = True
                break
            if time.perf_counter() - self.t0 > timeout:
                self.proc.kill()
                timed_out = True
                break
            time.sleep(0.002)
        self.proc.wait()
        self._reader.join()
        text = [line for _, line in self.lines]
        validated = [int(m.group(1)) for m in map(re.compile(r"^\[Test: (\d+)/").match, text)
                     if m]
        first_epoch = next((t for t, line in self.lines
                            if line.startswith("Beginning train epoch")), None)
        resumed = [int(m.group(1)) for m in map(re.compile(r"resuming at epoch (\d+)").search,
                                               text) if m]
        counts = [json.loads(line[len("LAUNCHES "):]) for line in text
                  if line.startswith("LAUNCHES ")]
        return {"name": self.name, "rc": self.proc.returncode, "killed": killed,
                "timed_out": timed_out, "done": "PHASE_DONE" in text,
                "seconds": time.perf_counter() - self.t0,
                "seconds_to_first_epoch": first_epoch, "resumed_at": resumed,
                "epoch_started": epoch_started(text), "validated": validated,
                "launches": counts[-1] if counts else None,
                "tail": text[-15:]}


def epoch_started(lines: list[str]) -> int | None:
    """The last epoch (1-based) whose start the output shows."""
    epochs = [int(line.split(":")[1]) for line in lines
              if line.startswith("Beginning train epoch:")]
    return epochs[-1] if epochs else None


def save_in_flight(results_dir: str, since_ns: int) -> list[str]:
    """Directories of `last` (itself, or a sibling such as `last.tmp-<step>`)
    holding a `.distcp` data file written after `since_ns` (time.time_ns)
    that no newer `.metadata` covers: a DCP save of `last` under way."""
    found = []
    try:
        entries = os.listdir(results_dir)
    except FileNotFoundError:
        return found
    for entry in entries:
        if entry != "last" and not entry.startswith("last."):
            continue
        path = os.path.join(results_dir, entry)
        try:
            files = os.listdir(path)
            data = [os.stat(os.path.join(path, f)).st_mtime_ns for f in files
                    if f.endswith(".distcp")]
            meta = (os.stat(os.path.join(path, ".metadata")).st_mtime_ns
                    if ".metadata" in files else None)
        except (FileNotFoundError, NotADirectoryError):
            continue
        if data and max(data) > since_ns and (meta is None or max(data) > meta):
            found.append(entry)
    return found


def dcp_step(path: str) -> int | None:
    """The train step of the whole DCP train state a save to `path` left
    (`resolve_dcp_dir`), None when there is none."""
    import warnings

    import torch
    import torch.distributed.checkpoint as dcp

    from srgan_st_tpu_torch.train.checkpoint import resolve_dcp_dir

    found = resolve_dcp_dir(path)
    if found is None:
        return None
    step = {"step": torch.zeros((), dtype=torch.int64)}
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        dcp.load(step, checkpoint_id=found, no_dist=True)
    return int(step["step"])


def psnr_epochs(tb_dir: str) -> list[int]:
    """The epochs with a Test/PSNR row in scalars.jsonl (a row the kill cut
    is skipped)."""
    epochs = set()
    with open(os.path.join(tb_dir, "scalars.jsonl")) as f:
        for line in f:
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                continue
            if row["tag"] == "Test/PSNR":
                epochs.add(int(row["step"]))
    return sorted(epochs)


def best_psnr(results_dir: str) -> float | None:
    path = os.path.join(results_dir, "_policy.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return float(json.load(f)["best_psnr"])


def npz_diff(a: str, b: str) -> float | None:
    """0.0 when two npz files hold the same arrays bit for bit, else the
    largest absolute difference (None when their keys differ)."""
    with np.load(a) as x, np.load(b) as y:
        if sorted(x.files) != sorted(y.files):
            return None
        return max((float(np.abs(x[k].astype(np.float64) - y[k]).max())
                    if not np.array_equal(x[k], y[k]) else 0.0) for k in x.files)


class Soak:
    def __init__(self, root: str, patches: int, warmup_epochs: int, epochs: int,
                 kill_epoch: int, device: str, sets: list[str], child_timeout: float):
        from srgan_st_tpu_torch.core.config import Config, apply_overrides

        if not 2 <= kill_epoch <= epochs:
            raise ValueError(f"--kill-epoch {kill_epoch}: a resume needs a `last` from an "
                             f"earlier epoch (2 <= k <= {epochs})")
        self.root, self.epochs, self.device = os.path.abspath(root), epochs, device
        self.kill_epoch, self.timeout = kill_epoch, child_timeout
        self.batch = apply_overrides(Config(), sets).DATA.BATCH_SIZE
        self.steps_per_epoch = patches // self.batch
        train_dir = os.path.join(self.root, "train")
        write_pack(os.path.join(train_dir, "patches.pack.npy"), patches)
        self.base = {"train_dir": train_dir, "device": device, "sets": list(sets),
                     "orbax": False, "epochs": epochs}
        self.warmup = {**self.base, "phase": "warmup", "name": "soak-warmup",
                       "epochs": warmup_epochs}
        self.failures: list[str] = []

    def _results(self, name: str) -> str:
        return os.path.join(self.root, "results", name)

    def _gan(self, name: str, orbax: bool) -> dict:
        return {**self.base, "phase": "gan", "name": name, "orbax": orbax,
                "warmup_weights": os.path.join(self._results("soak-warmup"), "g_best.npz")}

    def _child_ok(self, child: dict, kernels: tuple[str, ...], killed: bool = False) -> None:
        if killed != child["killed"] or child["timed_out"] or (
                not killed and (child["rc"] != 0 or not child["done"])):
            self.failures.append(f"{child['name']}: rc {child['rc']}, killed "
                                 f"{child['killed']}, timed out {child['timed_out']}: "
                                 f"{child['tail']}")
        # on the CPU the wrappers run their plain versions: nothing launches
        missing = [] if self.device == "cpu" else [
            n for n in kernels if not (child["launches"] or {}).get(n)]
        if missing:
            self.failures.append(f"{child['name']}: launched none of {missing} "
                                 f"({child['launches']})")

    def run_warmup(self) -> dict:
        child = Child(self.root, self.warmup).run(timeout=self.timeout)
        self._child_ok(child, TRAIN_KERNELS)
        return child

    def run_reference(self) -> dict:
        child = Child(self.root, self._gan("soak-reference", False)).run(timeout=self.timeout)
        self._child_ok(child, GAN_KERNELS)
        return {"child": child}

    def run_state_pt(self) -> dict:
        """Killed after _KILL_LINES logged batch lines of `kill_epoch`."""
        cfg = self._gan("soak-state-pt", False)
        marker = f"[Epoch {self.kill_epoch}/{self.epochs}] [Batch "

        def kill_when(child):
            return sum(line.startswith(marker) for _, line in child.lines) >= _KILL_LINES

        killed = Child(self.root, cfg).run(kill_when, self.timeout)
        self._child_ok(killed, GAN_KERNELS, killed=True)
        mid_epoch = (killed["epoch_started"] == self.kill_epoch
                     and self.kill_epoch not in killed["validated"])
        if not mid_epoch:
            self.failures.append(
                f"state_pt: the kill fell outside epoch {self.kill_epoch}'s steps")
        return self._resume(cfg, [killed], self.kill_epoch - 1,
                            {"killed_in_epoch": killed["epoch_started"],
                             "killed_after_lines": _KILL_LINES, "mid_epoch": mid_epoch})

    def run_dcp(self) -> dict:
        """Killed while a save of `last` is under way, from `kill_epoch` on."""
        cfg = self._gan("soak-dcp", True)
        results = self._results(cfg["name"])
        children, attempts, arm = [], [], self.kill_epoch
        for _ in range(_ATTEMPTS):
            child = Child(self.root, cfg)
            seen = []

            def kill_when(c, child=child, seen=seen):
                epoch = epoch_started([line for _, line in c.lines])
                if epoch is None or epoch < arm:
                    return False
                seen[:] = save_in_flight(results, child.wall_start)
                return bool(seen)

            rec = child.run(kill_when, self.timeout)
            children.append(rec)
            self._child_ok(rec, GAN_KERNELS, killed=True)
            if not rec["killed"]:
                break
            epoch = rec["epoch_started"]
            whole = dcp_step(os.path.join(results, "last"))
            cut = whole is not None and whole < epoch * self.steps_per_epoch
            attempts.append({"save_of_epoch": epoch, "in_flight": list(seen),
                             "whole_last_step": whole, "saving_step": epoch * self.steps_per_epoch,
                             "cut": cut, "after_s": rec["seconds"],
                             "left": sorted(os.listdir(results))})
            if cut:
                break
            arm = epoch + 1
        if not attempts or not attempts[-1]["cut"]:
            self.failures.append(
                f"dcp: no save of `last` was cut in {len(children)} runs: {attempts}")
            return {"attempts": attempts, "children": children}
        return self._resume(cfg, children, attempts[-1]["save_of_epoch"] - 1,
                            {"attempts": attempts})

    def _resume(self, cfg: dict, killed: list[dict], expect: int, rec: dict) -> dict:
        """Relaunch a killed case with the same config and check its run."""
        results = self._results(cfg["name"])
        best = [best_psnr(results)]
        child = Child(self.root, cfg).run(timeout=self.timeout)
        self._child_ok(child, GAN_KERNELS)
        best.append(best_psnr(results))
        name = cfg["name"]
        if child["resumed_at"] != [expect]:
            self.failures.append(
                f"{name}: resumed at {child['resumed_at']}, expected epoch {expect}")
        epochs = psnr_epochs(os.path.join(self.root, "tensorboard", name))
        if epochs != list(range(1, self.epochs + 1)):
            self.failures.append(f"{name}: Test/PSNR logged for epochs {epochs}")
        if None in best or best[1] < best[0]:
            self.failures.append(f"{name}: best PSNR {best[0]} -> {best[1]}")
        state = "last" if cfg["orbax"] else "last.state.pt"
        files = sorted(os.listdir(results))
        missing = [f for f in ("g_last.npz", "d_last.npz", "g_best.npz", "d_best.npz", state)
                   if f not in files]
        leftovers = [f for f in files if ".tmp-" in f or f.endswith(".old")]
        if missing or leftovers or (cfg["orbax"] and not os.path.exists(
                os.path.join(results, "last", ".metadata"))):
            self.failures.append(
                f"{name}: checkpoint set {files} (missing {missing}, left {leftovers})")
        reference = self._results("soak-reference")
        diffs = {f: npz_diff(os.path.join(results, f), os.path.join(reference, f))
                 for f in ("g_last.npz", "d_last.npz")}
        if any(d != 0.0 for d in diffs.values()):
            self.failures.append(
                f"{name}: final weights differ from the uninterrupted run's: {diffs}")
        return {**rec, "children": killed + [child], "resumed_at": child["resumed_at"],
                "expected_resume_epoch": expect, "psnr_epochs": epochs, "best_psnr": best,
                "results_files": files, "final_max_abs_diff": diffs,
                "seconds_to_resume": child["seconds_to_first_epoch"],
                "resumed_patches_per_s": self._rate(child, expect)}

    def _rate(self, child: dict, start_epoch: int) -> float | None:
        """Patches per second of a relaunch, from its first epoch's start to
        its end (validation and checkpoints included)."""
        if not child["done"] or child["seconds_to_first_epoch"] is None:
            return None
        patches = (self.epochs - start_epoch) * self.steps_per_epoch * self.batch
        return patches / (child["seconds"] - child["seconds_to_first_epoch"])


def run_soak(root: str, patches: int = 12_800, warmup_epochs: int = 10, epochs: int = 10,
             kill_epoch: int = 5, cases=CASES, device: str = "cuda", sets=(),
             child_timeout: float = 3600.0) -> dict:
    """The soak (see the module's docstring); returns its report, whose
    `failures` lists every check that failed."""
    import torch

    if device != "cpu":
        if not torch.cuda.is_available():
            raise RuntimeError("the soak runs on a CUDA GPU; none is available "
                               "(pass --device cpu for the CPU)")
        from srgan_st_tpu_torch.kernels import _build

        _build.build(("coarse_conv", "packed_trunk", "buddy_select"))
    unknown = set(cases) - set(CASES)
    if unknown:
        raise ValueError(f"unknown cases {sorted(unknown)} (of {CASES})")
    t0 = time.perf_counter()
    soak = Soak(root, patches, warmup_epochs, epochs, kill_epoch, device, list(sets),
                child_timeout)
    report = {"root": soak.root, "patches": patches, "steps_per_epoch": soak.steps_per_epoch,
              "warmup_epochs": warmup_epochs, "epochs": epochs, "kill_epoch": kill_epoch,
              "device": device, "sets": list(sets),
              "warmup": soak.run_warmup()}
    if not soak.failures:
        results, errors = {}, []

        def run(case: str) -> None:
            try:
                results[case] = getattr(soak, f"run_{case}")()
            except Exception as e:  # noqa: BLE001 - reported as a failure below
                errors.append(f"{case}: {e!r}")

        run("reference")  # first: the killed cases compare with its final weights
        threads = [threading.Thread(target=run, args=(case,)) for case in cases]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        report.update(results)
        soak.failures += errors
    report["seconds"] = time.perf_counter() - t0
    report["failures"] = soak.failures
    report["ok"] = not soak.failures
    with open(os.path.join(soak.root, "SOAK_REPORT.json"), "w") as f:
        json.dump(report, f, indent=1)
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--root", default="soak", help="working directory (pack, results/, "
                   "tensorboard/, SOAK_REPORT.json)")
    p.add_argument("--patches", type=int, default=12_800)
    p.add_argument("--warmup-epochs", type=int, default=10)
    p.add_argument("--epochs", type=int, default=10, help="GAN epochs")
    p.add_argument("--kill-epoch", type=int, default=5,
                   help="GAN epoch (1-based, as printed) in which the kills fall")
    p.add_argument("--device", default="cuda")
    p.add_argument("--set", action="append", default=[], metavar="GROUP.FIELD=value")
    args = p.parse_args(argv)
    report = run_soak(args.root, args.patches, args.warmup_epochs, args.epochs,
                      args.kill_epoch, device=args.device, sets=args.set)
    print(json.dumps(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
