"""Trajectory replay on the card: the four training goldens replayed through
the port's training steps, and a full-width window of the same recipes (the
port's counterpart of tools/onchip_trajectory_smoke.py).

    python -m srgan_st_tpu_torch.tools.trajectory [--recipes st flagship gram-vgg bb]
        [--bf16] [--form step|chunk|both] [--full] [--device cuda|cpu]
        [--goldens DIR]

Run it from the checkout's root: DIR defaults to tests/goldens there.

Each golden (tests/goldens/training_trajectory*.npz) holds 20 warmup and 20
GAN steps of the executed reference training loop on a small config (a
2 RCB / 16 ch G, a 4 ch D): the initial and final state dicts and the
per-step losses. A replay runs 20 warmup steps from the golden's g0, then
20 GAN steps from its post-warmup G and its d0, on the golden's feed
(`make_batches`, seeds 1234 and 5678) and schedule (`meta`: batch, steps
per epoch, D interval, lr milestone in epochs). D steps where
(step % steps_per_epoch) % D_UPDATE_INTERVAL == 0, the reference's cadence.
The run takes the port's defaults on the device it runs on: on CUDA kernel
A in every warmup and G step (the reconstruction conv on the pre-shuffle
activation, (8, 48, 48, 64): 4 x 16 channels, within its gate), K7 in every
G step of the buddy recipes, and torch's own TF32 switches. The trunk
kernels do not run at this width (their gate needs the trunk's C, 16, a
multiple of 64).

  --form step   the eager step functions (`make_warmup_step`,
                `make_gan_steps`), the JAX tool's per-step jit;
  --form chunk  the chunk steps (`make_warmup_chunk_step`,
                `make_gan_chunk_step`) in the chunks train() cuts
                (`resolve_chunk_steps`, `iter_chunks`), each step kind
                captured as a CUDA graph and replayed (`step_graphs`,
                TPU.CUDA_GRAPHS, on CUDA);
  --bf16        TPU.COMPUTE_DTYPE="bfloat16", everything else default;
  --full        the full-width window instead: the four recipes at the
                default widths (G 16 RCB / 64 ch, D 64 ch) on torch-seeded
                weights, batch 16, the goldens' schedule. No golden exists
                there: each run is held against the port's own reference
                run on the same device (f32, every kernel on its plain
                version, TF32 off, cuDNN deterministic, eager steps), the
                GAN window starting from the reference's post-warmup G.
                Held to it: (a) the shipping recipe (bf16, the auto trunk,
                which is "packed" in a bf16 train step, chunk steps) for
                each recipe and (b) flagship with TRUNK_MODE="fused", at
                the bf16 gates and, since the loss traces do not see a
                wrong trunk backward, at UPDATE_COS_GATE: the cosine of
                the warmup's update of G (post-warmup G minus g0) with the
                reference's, over the head conv, the trunk and the rest
                (`update_cos`). When (a) misses a gate, the same run with
                the kernels on their plain versions splits kernel error
                from bf16 rounding (reported, not gated).

Gates (the JAX tool's, on the first 5 steps of each trace): f32 warmup G
loss 2e-3, GAN G loss 1.5e-2, GAN D loss 5e-2; bf16 4e-2, 1.5e-1, 3e-1. The
whole-window values are reported. Each run's launches of the hand-written
kernels (graph replays included, the replayed part beside them) are held
to the counts its configuration implies (none on the CPU, where every
wrapper runs its plain version).

Prints one JSON line per run: metric "onchip_trajectory_max_rel_err",
value (the first-5-step warmup G-loss max rel-err), unit, config, device
(the card's name and power limit), detail, gates, launches, ok. Exits
nonzero if a gate or a launch count misses. Runs on CUDA unless
`--device cpu`; without a GPU it raises.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass

import numpy as np
import torch

# golden file, and the criteria after Adversarial and Pixel in the golden's
# summation order
RECIPES = {
    "st": ("training_trajectory.npz", {"ST": {"kind": "st"}}),
    "flagship": ("training_trajectory_flagship.npz",
                 {"PatchwiseST": {"kind": "patchwise_st"},
                  "ContentDiscriminator": {"kind": "content_disc"}}),
    "gram-vgg": ("training_trajectory_gramvgg.npz",
                 {"Gram": {"kind": "gram"}, "ContentVGG": {"kind": "content_vgg"}}),
    "bb": ("training_trajectory_bb.npz", {"BestBuddy": {"kind": "best_buddy"}}),
}
BUDDY_KINDS = ("best_buddy", "gram", "patchwise_st")

# tools/onchip_trajectory_smoke.py's gates: its measured on-chip envelopes
# with ~10x headroom; semantic divergence (a wrong optimizer, BN or
# selection behaviour) shows at 1e-1 and more
GATES = {"float32": {"warm5": 2e-3, "gan5_g": 1.5e-2, "gan5_d": 5e-2},
         "bfloat16": {"warm5": 4e-2, "gan5_g": 1.5e-1, "gan5_d": 3e-1}}
# the least cosine of a full-width run's warmup update of G with the f32
# plain reference's, per part: the shipping bf16 runs gave 0.989 (trunk) to
# 0.995 on an H100; K5's input gradient halved gave 0.929 on the head conv,
# its weight gradients x4 0.943 on the trunk, while every loss trace stayed
# under its gate (srgan_st_tpu_torch/tools/trajectory_probe.py)
UPDATE_COS_GATE = 0.96

GOLDEN_WIDTHS = (2, 16, 4)  # G_N_RCB, G_N_CHANNEL, D_N_CHANNEL of every golden
FEED_SEEDS = (1234, 5678)  # the warmup and the GAN window's batches
GT_SIZE = 96
FULL_BATCH = 16
# A, K4, K5, K6, K7, and kernel B (K3), which no training step launches:
# read so that every run holds it at 0
COUNTERS = ("coarse_conv_s2d", "packed_trunk_fwd", "packed_trunk_bwd", "fused_trunk",
            "buddy_select", "serving_tail")


def make_batches(n_steps: int, batch: int, size: int, seed: int) -> np.ndarray:
    """(n_steps, batch, size, size, 3) uint8: the goldens' feed (the
    generator's own lines, tools/crosscheck_training_vs_reference.py)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (n_steps, batch, size, size, 3), dtype=np.uint8)


class _VGG19(torch.nn.Module):
    """The VGG19 `features` trunk alone, under torchvision's keys."""

    def __init__(self, features):
        super().__init__()
        self.features = features

    def forward(self, x):
        return self.features(x)


def vgg19_stub() -> torch.nn.Module:
    """The gram-vgg golden's VGG19: torchvision's `features` layout with
    nn.Conv2d's default init drawn after torch.manual_seed(97), the global
    RNG state saved and restored around it (the golden's generator, which
    stores only the weights' digest)."""
    from torch import nn

    layout = [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
              512, 512, 512, 512, "M", 512, 512, 512, 512, "M"]
    rng_state = torch.random.get_rng_state()
    try:
        torch.manual_seed(97)
        mods, cin = [], 3
        for v in layout:
            if v == "M":
                mods.append(nn.MaxPool2d(2, 2))
            else:
                mods += [nn.Conv2d(cin, v, 3, padding=1), nn.ReLU()]
                cin = v
        return _VGG19(nn.Sequential(*mods))
    finally:
        torch.random.set_rng_state(rng_state)


def write_vgg19_npz(path: str, digest=None) -> str:
    """vgg19_stub's weights in tools/convert_vgg19.py's npz format (HWIO
    kernels), held first to a golden's `vgg0_digest` (size, sum of |w|, sum
    of the first 8) where one is given."""
    vgg0 = {k: v.numpy() for k, v in vgg19_stub().state_dict().items()}
    if digest is not None:
        w0 = np.concatenate([np.asarray(v, np.float64).ravel() for v in vgg0.values()])
        size, abssum, head = (float(x) for x in digest)
        if (w0.size != int(size) or not np.isclose(np.abs(w0).sum(), abssum, rtol=1e-12, atol=0)
                or not np.isclose(w0[:8].sum(), head, rtol=1e-12, atol=0)):
            raise ValueError("the VGG19 stub does not match the golden's vgg0_digest")
    np.savez(path, **{k: v.transpose(2, 3, 1, 0) if v.ndim == 4 else v
                      for k, v in vgg0.items()})
    return path


def load_golden(recipe: str, golden_dir: str) -> dict:
    """The recipe's golden from `golden_dir` (the checkout's tests/goldens)."""
    with np.load(os.path.join(golden_dir, RECIPES[recipe][0])) as z:
        return {k: z[k] for k in z.files}


def unpack(data: dict, part: str) -> dict:
    """The state dict stored under `part/` (reference state-dict keys)."""
    return {k[len(part) + 1:]: torch.from_numpy(np.asarray(v))
            for k, v in data.items() if k.startswith(part + "/")}


def meta(data: dict) -> tuple[int, ...]:
    """(warmup steps, GAN steps, batch, steps per epoch, D interval,
    milestone in epochs)."""
    return tuple(int(v) for v in data["meta"])


def full_data(golden_dir: str, seed: int = 0) -> dict:
    """The full-width window's inputs in a golden's layout: the goldens'
    schedule (the st golden's `meta`) at batch 16, the default widths, and G and D initialized as
    the training loops do (`create_gan_state`, a torch generator seeded
    with `seed`). No post-warmup G: the reference run makes it."""
    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.models.discriminator import Discriminator
    from srgan_st_tpu_torch.models.generator import Generator
    from srgan_st_tpu_torch.train.steps import create_gan_state

    golden = meta(load_golden("st", golden_dir))
    cfg = Config()
    state = create_gan_state(cfg, Generator.from_config(cfg), Discriminator.from_config(cfg),
                             golden[3], "cpu", generator=torch.Generator().manual_seed(seed))
    data = {"meta": np.array((*golden[:2], FULL_BATCH, *golden[3:])),
            "widths": np.array((cfg.MODEL.G_N_RCB, cfg.MODEL.G_N_CHANNEL,
                                cfg.MODEL.D_N_CHANNEL))}
    for part, model in (("g0", state.g_model), ("d0", state.d_model)):
        data.update({f"{part}/{k}": v.numpy() for k, v in model.state_dict().items()})
    return data


def make_config(data: dict, recipe: str, work: str, dtype: str = "float32",
                plain: bool = False, trunk: str | None = None):
    """The replay's Config: the data's widths and schedule, the recipe's
    criteria, TPU.COMPUTE_DTYPE `dtype`, TRUNK_MODE `trunk` (None: auto).
    `plain` puts every kernel on its plain version (CONV3_INNER=1, the
    unfused trunk, the buddy specs' "pallas": False). The flagship golden's
    frozen content D (cd0/*) and the VGG19 stub are written into `work`;
    without a cd0 the content D is the fresh seeded one."""
    from srgan_st_tpu_torch.core.config import Config

    _, _, batch, _, d_int, milestone = meta(data)
    cfg = Config()
    cfg.DATA.BATCH_SIZE = batch
    cfg.SCHEDULER.MILESTONES = [milestone]
    cfg.SOLVER.D_UPDATE_INTERVAL = d_int
    cfg.MODEL.G_N_RCB, cfg.MODEL.G_N_CHANNEL, cfg.MODEL.D_N_CHANNEL = (
        int(w) for w in data.get("widths", GOLDEN_WIDTHS))
    cfg.TPU.COMPUTE_DTYPE = dtype
    cfg.TPU.TRUNK_MODE = "unfused" if plain else trunk
    extra = copy.deepcopy(RECIPES[recipe][1])
    if plain:
        cfg.TPU.CONV3_INNER = 1
        for spec in extra.values():
            if spec["kind"] in BUDDY_KINDS:
                spec["pallas"] = False
    cfg.MODEL.G_LOSS.CRITERIONS = {"Adversarial": {"kind": "adversarial"},
                                   "Pixel": {"kind": "pixel", "criterion": "mse"}, **extra}
    cd0 = unpack(data, "cd0")
    if recipe == "flagship" and cd0:
        path = os.path.join(work, "cd0.npz")
        np.savez(path, **{k: t.numpy() for k, t in cd0.items()})
        cfg.MODEL.G_LOSS.DISC_FEATURES_WEIGHTS = path
    if recipe == "gram-vgg":
        cfg.MODEL.G_LOSS.VGG19_WEIGHTS = write_vgg19_npz(os.path.join(work, "vgg0.npz"),
                                                         data.get("vgg0_digest"))
    return cfg


def max_rel(a, b) -> float:
    """Largest relative difference of two traces over their non-NaN steps
    (the NaNs, steps without a D update, must coincide)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    mask = ~np.isnan(a)
    if (mask != ~np.isnan(b)).any():
        raise ValueError("the traces' D-update steps differ")
    a, b = a[mask], b[mask]
    return float(np.max(np.abs(a - b) / np.maximum(np.maximum(np.abs(a), np.abs(b)), 1e-12)))


def update_cos(run, ref, g0: dict) -> dict:
    """Cosine of two runs' warmup updates of G (their `g_warm` minus `g0`,
    a state dict), over the parameters of the head conv (conv1), of the
    trunk, and of the rest (running statistics left out; 0 where either run
    did not move)."""
    parts = {"conv1": [], "trunk": [], "rest": []}
    for k, w0 in g0.items():
        if w0.is_floating_point() and "running_" not in k:
            part = k.split(".")[0]
            parts[part if part in parts else "rest"].append(k)
    out = {}
    for part, keys in parts.items():
        a, b = (torch.cat([(r.g_warm[k].double() - g0[k].double()).ravel() for k in keys])
                for r in (run, ref))
        norms = float(a.norm() * b.norm())
        out[part] = float(a @ b) / norms if norms else 0.0
    return out


@dataclass
class Run:
    losses: dict          # warm_losses, gan_g_losses, gan_d_losses (NaN: no D step)
    g: torch.nn.Module    # the final G and D
    d: torch.nn.Module
    g_warm: dict          # the post-warmup G's state dict, on the CPU
    launches: dict        # kernel launches of the run, graph replays included
    graph_launches: dict  # the part of them that graph replays made
    seconds: float


class _Feed:
    """A window's batches as a training source, `steps_per_epoch` an epoch."""

    def __init__(self, batches, steps_per_epoch: int):
        self.batches, self.spe = batches, steps_per_epoch
        self.epochs = -(-len(batches) // steps_per_epoch)

    def epoch(self, i: int):
        return iter(self.batches[i * self.spe:(i + 1) * self.spe])


class _Recorder:
    """Stands in for a chunk step's `graphs` and keeps every step's metrics
    (a chunk step returns those of its batch 0 alone): runs each step by
    its StepGraphs (None: eagerly) and copies its outputs, which the next
    replay of a graph overwrites."""

    def __init__(self, graphs):
        self.graphs, self.rows = graphs, []

    def run(self, kind, owner, fn, *args):
        out = fn(*args) if self.graphs is None else self.graphs.run(kind, owner, fn, *args)
        self.rows.append({k: v.detach().clone() for k, v in out.items()})
        return out


def _model(cls, cfg, state_dict, dev):
    model = cls.from_config(cfg)
    model.load_state_dict(state_dict)
    return model.to(dev)


def _trace(values) -> np.ndarray:
    return np.array([np.nan if v is None else float(v) for v in values], np.float64)


def _warmup(cfg, state, criterions, feed, spe, form, dev) -> np.ndarray:
    from srgan_st_tpu_torch.train.graphs import step_graphs
    from srgan_st_tpu_torch.train.steps import make_warmup_chunk_step, make_warmup_step
    from srgan_st_tpu_torch.train.utils import iter_chunks, resolve_chunk_steps

    if form == "step":
        step, out = make_warmup_step(cfg, criterions), []
        for gt in feed:
            state, m = step(state, gt)
            out.append(m["G_Loss"])
        return _trace(out)
    rec = _Recorder(step_graphs(cfg, dev))
    chunk_step = make_warmup_chunk_step(cfg, criterions, graphs=rec)
    source, size = _Feed(feed, spe), resolve_chunk_steps(cfg, cfg.LOG_TRAIN_PERIOD, spe)
    for epoch in range(source.epochs):
        for chunk in iter_chunks(source, epoch, size):
            state, _ = chunk_step(state, chunk)
    return _trace(r["G_Loss"] for r in rec.rows)


def _gan(cfg, state, criterions, feed, spe, form, dev) -> tuple[np.ndarray, np.ndarray]:
    from srgan_st_tpu_torch.train.graphs import step_graphs
    from srgan_st_tpu_torch.train.steps import make_gan_chunk_step, make_gan_steps
    from srgan_st_tpu_torch.train.utils import iter_chunks, resolve_chunk_steps

    d_int = cfg.SOLVER.D_UPDATE_INTERVAL
    if form == "step":
        g_step, d_step = make_gan_steps(cfg, criterions)
        g_out, d_out = [], []
        for step, gt in enumerate(feed):
            state, sr, m = g_step(state, gt)
            g_out.append(m["G_Loss"])
            dm = d_step(state, gt, sr)[1] if (step % spe) % d_int == 0 else {}
            d_out.append(dm.get("D_Loss"))
        return _trace(g_out), _trace(d_out)
    # train()'s loop: chunks of D_UPDATE_INTERVAL batches cut per epoch, the
    # D update on the batch 0 of each chunk that starts on an interval
    rec = _Recorder(step_graphs(cfg, dev))
    chunk_step = make_gan_chunk_step(cfg, criterions, graphs=rec)
    source, size = _Feed(feed, spe), resolve_chunk_steps(cfg, d_int, spe)
    for epoch in range(source.epochs):
        batch_num = 0
        for chunk in iter_chunks(source, epoch, size):
            state, _ = chunk_step(state, chunk, batch_num % d_int == 0)
            batch_num += len(chunk)
    return (_trace(r["G_Loss"] for r in rec.rows),
            _trace(r.get("D_Loss") for r in rec.rows))


def replay(data: dict, recipe: str, device=None, dtype: str = "float32",
           form: str = "step", plain: bool = False, trunk: str | None = None) -> Run:
    """The window of `data` (a golden, or `full_data` with the reference's
    g_warm/*) through the port's steps in `form` ("step" or "chunk") on
    `device` (None: CUDA, or raise). The GAN window starts from the data's
    g_warm/* where it has one, else from this run's post-warmup G. The
    launch counters are reset at its start and read at its end."""
    from srgan_st_tpu_torch import kernels
    from srgan_st_tpu_torch.core.device import resolve_device
    from srgan_st_tpu_torch.losses.registry import build_criterions, build_warmup_criterions
    from srgan_st_tpu_torch.models.discriminator import Discriminator
    from srgan_st_tpu_torch.models.generator import Generator
    from srgan_st_tpu_torch.train.steps import (
        GANTrainState, make_d_optimizer, make_g_optimizer,
    )

    if form not in ("step", "chunk"):
        raise ValueError(f"form must be 'step' or 'chunk', not {form!r}")
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as work:
        cfg = make_config(data, recipe, work, dtype, plain, trunk)
        warm_criterions, criterions = build_warmup_criterions(cfg), build_criterions(cfg)
    warm_n, gan_n, batch, spe, _, _ = meta(data)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    g = _model(Generator, cfg, unpack(data, "g0"), dev)
    state = GANTrainState(g_model=g, g_opt=make_g_optimizer(cfg, g.parameters(), spe,
                                                            milestones=False))
    warm = _warmup(cfg, state, warm_criterions,
                   make_batches(warm_n, batch, GT_SIZE, FEED_SEEDS[0]), spe, form, dev)
    g_warm = {k: v.detach().cpu().clone() for k, v in g.state_dict().items()}
    # the GAN window from one post-warmup G: each window carries only its
    # own divergence
    g = _model(Generator, cfg, unpack(data, "g_warm") or g_warm, dev)
    d = _model(Discriminator, cfg, unpack(data, "d0"), dev)
    state = GANTrainState(g_model=g, g_opt=make_g_optimizer(cfg, g.parameters(), spe),
                          d_model=d, d_opt=make_d_optimizer(cfg, d.parameters(), spe))
    gan_g, gan_d = _gan(cfg, state, criterions,
                        make_batches(gan_n, batch, GT_SIZE, FEED_SEEDS[1]), spe, form, dev)
    launches = {k: kernels.launch_counts()[k] for k in COUNTERS}
    replayed = {k: kernels.graph_launch_counts()[k] for k in COUNTERS}
    return Run({"warm_losses": warm, "gan_g_losses": gan_g, "gan_d_losses": gan_d}, g, d,
               g_warm, launches, replayed, time.perf_counter() - t0)


def expected_launches(data: dict, recipe: str, device, form: str, dtype: str = "float32",
                      plain: bool = False, trunk: str | None = None) -> tuple[dict, dict]:
    """(launches, replayed part) that a replay's configuration implies: on
    CUDA kernel A once per warmup and G step, K4 and K5 once per warmup
    and G step where the trunk is "packed" (bf16 and C a multiple of 64:
    the auto trunk of a full-width bf16 train step), K6 once per warmup
    and G step under "fused", K7 once per G step of a buddy recipe; none
    under `plain` or on the CPU. Chunk steps on CUDA replay all but each
    step kind's first call (warmup; G + D and G)."""
    warm_n, gan_n = meta(data)[:2]
    zero = dict.fromkeys(COUNTERS, 0)
    if torch.device(device).type != "cuda" or plain:
        return zero, zero
    full = int(data.get("widths", GOLDEN_WIDTHS)[1]) % 64 == 0
    mode = trunk or ("packed" if dtype == "bfloat16" and full else "unfused")
    every = {"coarse_conv_s2d"} | {"packed": {"packed_trunk_fwd", "packed_trunk_bwd"},
                                   "fused": {"fused_trunk"}}.get(mode, set())
    buddy = any(s["kind"] in BUDDY_KINDS for s in RECIPES[recipe][1].values())
    want = {k: warm_n + gan_n if k in every else
            gan_n if k == "buddy_select" and buddy else 0 for k in COUNTERS}
    if form != "chunk":
        return want, zero
    first = {k: (1 if k in every else 0) + 2 for k in COUNTERS}
    return want, {k: n - first[k] if n else 0 for k, n in want.items()}


def rel_errors(got: dict, ref: dict) -> dict:
    """The JAX tool's five values: the gated first-5-step ones and the
    whole-window warmup and GAN G-loss ones."""
    head = slice(0, 5)
    return {"warm5": max_rel(ref["warm_losses"][head], got["warm_losses"][head]),
            "gan5_g": max_rel(ref["gan_g_losses"][head], got["gan_g_losses"][head]),
            "gan5_d": max_rel(ref["gan_d_losses"][head], got["gan_d_losses"][head]),
            "warm_full": max_rel(ref["warm_losses"], got["warm_losses"]),
            "gan_full_g": max_rel(ref["gan_g_losses"], got["gan_g_losses"])}


def d_steps(data: dict) -> np.ndarray:
    """The GAN window's steps with a D update: (step % steps_per_epoch) %
    D_UPDATE_INTERVAL == 0, the reference's cadence."""
    _, gan_n, _, spe, d_int, _ = meta(data)
    return np.array([(s % spe) % d_int == 0 for s in range(gan_n)])


def _record(config: str, unit: str, device: dict, rels: dict | None, gates: dict | None,
            run: Run, want: tuple[dict, dict], data: dict, mode: dict,
            cos: dict | None = None, **extra) -> dict:
    """One run's line: the JAX tool's keys, the run's `mode` (width,
    recipe, dtype, form, plain, trunk), its launches beside those its mode
    implies, and `ok`: finite traces on the reference's D steps, every gate
    held (`cos`, where given, at UPDATE_COS_GATE), launches (and their
    replayed part) as implied."""
    d = run.losses["gan_d_losses"]
    finite = (np.isfinite(run.losses["warm_losses"]).all()
              and np.isfinite(run.losses["gan_g_losses"]).all()
              and np.array_equal(~np.isnan(d), d_steps(data))
              and np.isfinite(d[d_steps(data)]).all())
    counted = (run.launches, run.graph_launches) == want
    ok = (finite and counted and (gates is None or all(rels[k] < g for k, g in gates.items()))
          and (cos is None or min(cos.values()) >= UPDATE_COS_GATE))
    return {"metric": "onchip_trajectory_max_rel_err",
            "value": None if rels is None else rels["warm5"], "unit": unit,
            "config": config, "device": device, "detail": rels, "gates": gates, **mode,
            **({} if cos is None else {"update_cos": cos, "update_cos_gate": UPDATE_COS_GATE}),
            "launches": run.launches, "graph_launches": run.graph_launches,
            "expected_launches": want[0], "expected_graph_launches": want[1],
            "seconds": run.seconds, **extra, "ok": bool(ok)}


def golden_window(recipes, device, golden_dir: str, dtypes=("float32",),
                  forms=("step",)) -> list[dict]:
    """Each golden of `recipes` (from `golden_dir`) replayed in each of
    `dtypes` and `forms`: one record per run, held to the JAX tool's gates
    and its launch counts."""
    from srgan_st_tpu_torch.utils.profiling import device_record

    card = device_record(device)
    out = []
    for recipe in recipes:
        data = load_golden(recipe, golden_dir)
        for dtype in dtypes:
            for form in forms:
                run = replay(data, recipe, device, dtype, form)
                out.append(_record(
                    recipe + ("-bf16" if dtype == "bfloat16" else "")
                    + ("-chunk" if form == "chunk" else ""),
                    "first-5-step warmup G-loss max rel-err vs the executed-torch-"
                    f"reference golden, {card['name']}", card,
                    rel_errors(run.losses, data), GATES[dtype], run,
                    expected_launches(data, recipe, device, form, dtype), data,
                    _mode("golden", recipe, dtype, form)))
                del run
    return out


@contextlib.contextmanager
def _tf32_off():
    """cuDNN and matmul TF32 off, restored after (the f32 reference)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def reference_run(data: dict, recipe: str, device) -> Run:
    """The full-width reference: f32, every kernel on its plain version,
    eager steps, TF32 off and cuDNN deterministic (under torch's default
    algorithms it does not repeat its own bits past step 0, and the runs
    held to it start their GAN window from its post-warmup G)."""
    from srgan_st_tpu_torch.eval.export import deterministic_cudnn

    with _tf32_off(), deterministic_cudnn():
        return replay(data, recipe, device, "float32", "step", plain=True)


def _mode(width: str, recipe: str, dtype: str, form: str, plain: bool = False,
          trunk: str | None = None) -> dict:
    return {"width": width, "recipe": recipe, "dtype": dtype, "form": form,
            "plain": plain, "trunk": trunk}


def full_window(recipes, device, golden_dir: str, seed: int = 0) -> list[dict]:
    """The full-width window (module docstring): per recipe the f32 plain
    reference, then (a) the shipping bf16 recipe in chunk steps and, for
    flagship, (b) the same under TRUNK_MODE="fused", each held to the
    reference at the bf16 gates and UPDATE_COS_GATE. A missed gate of (a)
    adds the bf16 plain run's values beside it (`split_plain_bf16`)."""
    from srgan_st_tpu_torch.utils.profiling import device_record

    card = device_record(device)
    base, out = full_data(golden_dir, seed), []
    g0 = unpack(base, "g0")
    unit = f"first-5-step warmup G-loss max rel-err vs the f32 plain reference, {card['name']}"
    for recipe in recipes:
        data = dict(base)
        ref = reference_run(data, recipe, device)
        out.append(_record(f"full-{recipe}-f32-plain-reference", "the reference run", card,
                           None, None, ref, expected_launches(data, recipe, device, "step",
                                                              plain=True), data,
                           _mode("full", recipe, "float32", "step", plain=True)))
        data.update({f"g_warm/{k}": v.numpy() for k, v in ref.g_warm.items()})
        cases = [(None, "")] + ([("fused", "-fused")] if recipe == "flagship" else [])
        for trunk, suffix in cases:
            run = replay(data, recipe, device, "bfloat16", "chunk", trunk=trunk)
            rec = _record(f"full-{recipe}-bf16-chunk{suffix}", unit, card,
                          rel_errors(run.losses, ref.losses), GATES["bfloat16"], run,
                          expected_launches(data, recipe, device, "chunk", "bfloat16",
                                            trunk=trunk), data,
                          _mode("full", recipe, "bfloat16", "chunk", trunk=trunk),
                          update_cos(run, ref, g0))
            del run
            if trunk is None and not rec["ok"]:
                split = replay(data, recipe, device, "bfloat16", "chunk", plain=True)
                rec["split_plain_bf16"] = {"detail": rel_errors(split.losses, ref.losses),
                                           "update_cos": update_cos(split, ref, g0)}
                del split
            out.append(rec)
        del ref
    return out


def main(argv=None) -> int:
    from srgan_st_tpu_torch.core.device import resolve_device

    p = argparse.ArgumentParser(prog="python -m srgan_st_tpu_torch.tools.trajectory",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--recipes", nargs="*", default=list(RECIPES), choices=list(RECIPES))
    p.add_argument("--bf16", action="store_true",
                   help='replay under TPU.COMPUTE_DTYPE="bfloat16" at the bf16 gates')
    p.add_argument("--form", choices=("step", "chunk", "both"),
                   help="step functions (the default), chunk steps, or both")
    p.add_argument("--full", action="store_true",
                   help="the full-width window against the port's f32 plain reference")
    p.add_argument("--device", choices=("cuda", "cpu"), default=None,
                   help="the default is the GPU; without one the tool raises")
    p.add_argument("--goldens", default=os.path.join("tests", "goldens"), metavar="DIR",
                   help="the directory of the training_trajectory*.npz goldens")
    args = p.parse_args(argv)
    if args.full and (args.bf16 or args.form):
        p.error("--full runs its own modes; --bf16 and --form do not apply")
    dev = resolve_device(args.device)
    if args.full:
        records = full_window(args.recipes, dev, args.goldens)
    else:
        forms = {"step": ("step",), "chunk": ("chunk",), "both": ("step", "chunk"),
                 None: ("step",)}[args.form]
        records = golden_window(args.recipes, dev, args.goldens,
                                ("bfloat16",) if args.bf16 else ("float32",), forms)
    for rec in records:
        print(json.dumps(rec), flush=True)
    return 0 if all(r["ok"] for r in records) else 1


if __name__ == "__main__":
    sys.exit(main())
