"""Closed-loop training in chunks, the program's training loop: one train
state (G, and in "gan" D, with their Adam states) driven by the program's
chunk step (`make_gan_chunk_step` / `make_warmup_chunk_step` of
srgan_st_tpu_torch/train/steps.py, its steps replayed from CUDA graphs),
a chunk of `chunk_batches` batches a call, D updated at each chunk's start.
The batches are views of a pool of seeded GT patches on the device.

Set-up makes the weights and the pool from the seed, then drives the
state through its first three steps, one batch a call of the same chunk
step (G + D, then G, G in "gan"), keeping what the reference needs to
follow them; a warm chunk later, the window times whole chunks, each
ending synchronized, until `seconds` have passed.

Traffic parameters: phase ("gan" or "warmup"), chunk_batches,
pool_chunks, warm_chunks, first_steps, traced_units."""

from __future__ import annotations

import gc
import math
import time

import torch

from benchmark import compare, harness, seeded, tracing
from benchmark.harness import program_config, sync
from benchmark.reference.train import run_steps


def _host(tensors: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def _stats(sd: dict) -> dict:
    return {k: v for k, v in sd.items() if k.endswith(("running_mean", "running_var"))}


class _Clock:
    """Records the seconds since its last call under each name given."""

    def __init__(self, parts: dict):
        self.parts, self.t = parts, time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.parts[name], self.t = now - self.t, now


class Session:
    """The program's train state, its chunk step and the pool of one
    seed, with the host copies the reference needs."""

    def __init__(self, ctx: harness.Ctx):
        from srgan_st_tpu_torch.losses.registry import build_criterions, build_warmup_criterions
        from srgan_st_tpu_torch.models.discriminator import Discriminator
        from srgan_st_tpu_torch.models.generator import Generator
        from srgan_st_tpu_torch.train.graphs import step_graphs
        from srgan_st_tpu_torch.train.steps import (
            GANTrainState, make_d_optimizer, make_g_optimizer, make_gan_chunk_step,
            make_warmup_chunk_step,
        )

        cfg, mix = ctx.config, ctx.traffic
        self.cfg, self.mix, self.phase = cfg, mix, mix["phase"]
        self.dev = dev = torch.device(ctx.device)
        self.parts: dict[str, float] = {}
        clock = _Clock(self.parts)
        config = program_config(cfg)
        self.content_d = None
        if any(s["kind"] == "content_disc" for s in cfg["criteria"].values()):
            path = seeded.content_d_file(cfg, harness.CACHE, dev)
            config.MODEL.G_LOSS.DISC_FEATURES_WEIGHTS = path
            self.content_d = seeded.load_npz_state(path, "cpu")
            clock("content_d_s")
        gen = seeded.generator_for(ctx.seed, dev)
        g_sd = seeded.generator_state(cfg, gen, dev)
        d_sd = seeded.discriminator_state(cfg, gen, dev) if self.phase == "gan" else None
        sync(dev)
        clock("draws_s")
        # built on the card, so that the constructors' own init (replaced
        # at once by the seeded weights) runs there and not on the host
        with torch.device(dev):
            g = Generator.from_config(config)
            d = Discriminator.from_config(config) if d_sd is not None else None
        g.load_state_dict(g_sd)
        if d is not None:
            d.load_state_dict(d_sd)
        sync(dev)
        clock("modules_s")
        state = GANTrainState(g, make_g_optimizer(config, g.parameters(), 1, milestones=False))
        if d is not None:
            state.d_model, state.d_opt = d, make_d_optimizer(config, d.parameters(), 1)
        clock("optimizers_s")
        self.init = {"g": _host(dict(g.named_parameters())), "g_stats": _host(_stats(g_sd))}
        self.g_sd = _host(g_sd)
        self.d_sd = None
        if d is not None:
            self.init["d"] = _host(dict(d.named_parameters()))
            self.init["d_stats"] = _host(_stats(d_sd))
            self.d_sd = _host(d_sd)
        del g_sd, d_sd
        clock("host_copies_s")

        k = mix["chunk_batches"]
        self.pool = seeded.patch_pool(gen, k * mix["pool_chunks"], cfg["batch_size"],
                                      cfg["gt_image_size"], dev)
        self.chunks = [list(self.pool[i * k:(i + 1) * k]) for i in range(mix["pool_chunks"])]
        sync(dev)
        clock("pool_s")

        self.graphs = step_graphs(config, dev)
        self.state = state
        self.beta1 = {"g": cfg["g_adam"]["beta1"], "d": cfg["d_adam"]["beta1"]}
        if self.phase == "gan":
            chunk_step = make_gan_chunk_step(config, build_criterions(config), None, self.graphs)
            self.step = lambda chunk, d=True: chunk_step(state, chunk, d)[1]
        else:
            chunk_step = make_warmup_chunk_step(config, build_warmup_criterions(config), None,
                                                self.graphs)
            self.step = lambda chunk, d=True: chunk_step(state, chunk)[1]

    def first_steps(self) -> dict:
        """The first steps, one batch a chunk, as the program ran them:
        losses, the first gradient from the optimizers' first moments, the
        BN running statistics after the first, the parameters and
        statistics after the last."""
        t = time.perf_counter()
        state = self.state
        out = {"loss": []}
        nets = {"g": (state.g_model, state.g_opt)}
        if self.phase == "gan":
            nets["d"] = (state.d_model, state.d_opt)
        for i in range(self.mix["first_steps"]):
            m = self.step([self.pool[i]], i == 0)
            loss = {"G": float(m["G_Loss"])}
            if "D_Loss" in m:
                loss["D"] = float(m["D_Loss"])
            out["loss"].append(loss)
            if i == 0:  # an optimizer that took no step holds no first moment
                for net, (model, opt) in nets.items():
                    st = opt.opt.state
                    out[f"{net}_grad"] = _host(
                        {n: (st[p]["exp_avg"] / (1 - self.beta1[net]) if "exp_avg" in st[p]
                             else torch.zeros_like(p)) for n, p in model.named_parameters()})
                    out[f"{net}_stats_first"] = _host(_stats(dict(model.named_buffers())))
        for net, (model, _) in nets.items():
            out[f"{net}_params"] = _host(dict(model.named_parameters()))
            out[f"{net}_stats"] = _host(_stats(dict(model.named_buffers())))
        sync(self.dev)
        self.parts["first_steps_s"] = time.perf_counter() - t
        return out

    def reference(self, batches, quant=None) -> dict:
        """The reference's steps from the same weights on `batches`,
        on the host."""
        dev = self.dev
        ref = run_steps(self.cfg, self.phase,
                        {k: v.to(dev) for k, v in self.g_sd.items()},
                        None if self.d_sd is None else {k: v.to(dev) for k, v in self.d_sd.items()},
                        [b.to(dev) for b in batches],
                        None if self.content_d is None else
                        {k: v.to(dev) for k, v in self.content_d.items()}, quant)
        return {k: (_host(v) if isinstance(v, dict) else v) for k, v in ref.items()}

    def free(self) -> list:
        """Drop the program's state; returns the first batches (host)."""
        first = [self.pool[i].cpu() for i in range(self.mix["first_steps"])]
        self.state = self.step = self.graphs = self.pool = self.chunks = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return first


def run(ctx: harness.Ctx) -> dict:
    dev = torch.device(ctx.device)
    build_s = harness.start(dev)
    s = Session(ctx)
    s.parts["build_s"] = build_s
    prog = s.first_steps()
    t = time.perf_counter()
    for i in range(s.mix["warm_chunks"]):
        s.step(s.chunks[i % len(s.chunks)])
    sync(dev)
    s.parts["warm_s"] = time.perf_counter() - t
    if s.graphs is not None:
        s.parts["capture_s"] = sum(s.graphs.capture_seconds().values())

    k, batch = s.mix["chunk_batches"], ctx.config["batch_size"]
    n = 0
    ends = []
    start = time.perf_counter()
    setup_s = start - ctx.t0
    while True:
        m = s.step(s.chunks[n % len(s.chunks)])
        n += 1
        sync(dev)
        ends.append(time.perf_counter() - start)
        elapsed = ends[-1]
        if elapsed >= ctx.seconds:
            break
    rate = n * k * batch / elapsed
    finite = all(math.isfinite(float(v)) for v in m.values())

    record = None
    if ctx.trace:
        from srgan_st_tpu_torch import kernels

        launches = []

        def unit():
            before = kernels.launch_counts()
            s.step(s.chunks[0])
            sync(dev)
            after = kernels.launch_counts()
            launches.append({key: after[key] - before[key] for key in after})

        record = tracing.profile_units(unit, s.mix["traced_units"])
        record.update(kind="train", phase=s.phase, config=ctx.config, rate=rate,
                      batches=k * s.mix["traced_units"], launches=tracing.summed(launches[1:]))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    first = s.free()
    ref = s.reference(first)
    readings, where = compare.train_readings(prog, ref, s.init)
    ok, checks = harness.judge(readings, ctx.workload["limits"])
    metrics = {"train_patches_per_s": {"value": rate, "unit": "patches/s"},
               "setup_s": {"value": setup_s, "unit": "s"}}
    return {"correct": ok and finite, "attempted": n * k, "failed": 0 if finite else n * k,
            "metrics": metrics, "peak": peak, "record": record, "checks": checks,
            "detail": {"worst_leaf": where, "setup_parts": s.parts, "readings": readings,
                       "chunk_s": [b - a for a, b in zip([0.0, *ends], ends)],
                       "first_losses": prog["loss"], "reference_losses": ref["loss"]}}
