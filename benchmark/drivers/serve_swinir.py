"""Closed-loop serving of one video stream through SwinIR (the real-world
SR model, SwinIR-M x4): the program's eval generator
(`make_generator_apply` of srgan_st_tpu_torch/eval/validate.py under
MODEL.G_ARCH "swinir") upscales one LR frame at a time, batch 1, input and
output on the device; each frame's input is the last output pooled back
to the LR size and mixed with one of 8 seeded noise frames
(`seeded.next_lr`). A frame is timed by CUDA events from its call until
its output is complete; the next is called once it is. The metrics, the
chain and the sample are those of `serve_frames.py`.

Set-up makes the weights (benchmark/seeded_swinir.py) and the first frame
and noise from the seed and runs `warm_frames` frames. The window then
serves frames until `seconds` have passed. A seeded sample of the window's
frames below `sample_below` keeps its input and output for the reference
(benchmark/reference/swinir.py), which runs after the window. The traced
unit's record (kind "serve_swinir") holds the device seconds under each of
the program's regions (benchmark/regions.py).

Traffic parameters: lr_height, lr_width, warm_frames, sample_frames,
sample_below, traced_units, frames_per_unit."""

from __future__ import annotations

import random
import statistics
import time

import torch

from benchmark import compare, harness, regions, seeded, seeded_swinir, tracing
from benchmark.drivers import serve_frames
from benchmark.drivers.serve_rrdb import clamped_share
from benchmark.harness import sync
from benchmark.reference.swinir import upscale


def program_config(cfg: dict):
    """The program's Config for a SwinIR configuration file."""
    from srgan_st_tpu_torch.core.config import Config

    c = Config()
    m = c.MODEL
    m.G_ARCH = "swinir"
    m.G_IN_CHANNEL = m.G_OUT_CHANNEL = cfg["in_chans"]
    m.G_EMBED_DIM, m.G_N_RSTB, m.G_RSTB_DEPTH = (cfg["embed_dim"], len(cfg["depths"]),
                                                 cfg["depths"][0])
    m.G_N_HEADS, m.G_WINDOW = cfg["num_heads"][0], cfg["window_size"]
    m.G_MLP_RATIO, m.G_HR_CHANNEL = float(cfg["mlp_ratio"]), cfg["num_feat"]
    c.DATA.UPSCALE_FACTOR = cfg["upscale"]
    c.TPU.COMPUTE_DTYPE = cfg["compute_dtype"]
    return c


class Session(serve_frames.Session):
    """`serve_frames.Session` (the frame chain, its timing and sample) on
    SwinIR: the program's eval generator of one seed and the seeded weights
    (host) the reference takes."""

    def __init__(self, ctx: harness.Ctx):
        from srgan_st_tpu_torch.eval.validate import make_generator_apply

        cfg, mix = ctx.config, ctx.traffic
        self.cfg, self.mix = cfg, mix
        self.dev = dev = torch.device(ctx.device)
        self.parts: dict[str, float] = {}
        t = time.perf_counter()
        gen = seeded.generator_for(ctx.seed, dev)
        g_sd = seeded_swinir.state(cfg, gen, dev)
        self.g_sd = {k: v.cpu() for k, v in g_sd.items()}
        self.apply = make_generator_apply(program_config(cfg), g_sd, dev)
        del g_sd
        shape = (1, mix["lr_height"], mix["lr_width"], cfg["in_chans"])
        self.first = torch.rand(shape, generator=gen, device=dev)
        self.noise = torch.rand((8, *shape), generator=gen, device=dev)
        self.s = cfg["upscale"]
        rng = random.Random(ctx.seed)
        # frames of the window: the chain's first `warm_frames` are set-up's
        self.sample = set(rng.sample(range(mix["warm_frames"], mix["sample_below"]),
                                     mix["sample_frames"]))
        self.parts["weights_s"] = time.perf_counter() - t
        self.x, self.i = self.first, 0


def frame_readings(g_sd: dict, kept: dict, dev, quant=None) -> dict:
    """The worst frame's gaps between the program's output and the
    reference's, over the kept frames."""
    rms = big = 0.0
    sd = {k: v.to(dev) for k, v in g_sd.items()}
    for x, sr in kept.values():
        ref = upscale(sd, x.to(dev), quant)
        r, m = compare.frame_gaps(sr.to(dev), ref)
        rms, big = max(rms, r), max(big, m)
        del ref
    return {"frame_rms_gap": rms, "frame_max_gap": big}


def run(ctx: harness.Ctx) -> dict:
    dev = torch.device(ctx.device)
    build_s = harness.start(dev)
    s = Session(ctx)
    s.parts["build_s"] = build_s
    t = time.perf_counter()
    with torch.inference_mode():
        for _ in range(s.mix["warm_frames"]):
            s.frame()
        sync(dev)
        s.parts["warm_s"] = time.perf_counter() - t

        kept: dict = {}
        times = []
        start = time.perf_counter()
        setup_s = start - ctx.t0
        while True:
            sr, ms = s.frame(kept)
            times.append(ms)
            elapsed = time.perf_counter() - start
            if elapsed >= ctx.seconds:
                break
        finite = bool(torch.isfinite(sr).all())

        record = None
        if ctx.trace:
            from srgan_st_tpu_torch import kernels

            launches = []
            per_unit = s.mix["frames_per_unit"]

            def unit():
                before = kernels.launch_counts()
                for _ in range(per_unit):
                    s.frame()
                sync(dev)
                after = kernels.launch_counts()
                launches.append({key: after[key] - before[key] for key in after})

            record = regions.profile_units(unit, s.mix["traced_units"])
    n = len(times)
    h, w = s.mix["lr_height"] * s.s, s.mix["lr_width"] * s.s
    mp_per_s = n * h * w / 1e6 / elapsed
    if record is not None:
        record.update(kind="serve_swinir", config=ctx.config, frames_per_s=n / elapsed,
                      lr_size=(s.mix["lr_height"], s.mix["lr_width"]),
                      frames=per_unit * s.mix["traced_units"],
                      launches=tracing.summed(launches[1:]))
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    g_sd = s.g_sd
    s.free()
    readings = frame_readings(g_sd, kept, dev)
    ok, checks = harness.judge(readings, ctx.workload["limits"])
    p95 = statistics.quantiles(times, n=20)[-1] if n >= 2 else times[0]
    metrics = {"serve_hr_mp_per_s": {"value": mp_per_s, "unit": "MP/s"},
               "serve_frame_ms_p95": {"value": p95, "unit": "ms"},
               "setup_s": {"value": setup_s, "unit": "s"}}
    detail = {"frames_compared": sorted(kept), "setup_parts": s.parts,
              "frame_ms_median": statistics.median(times), "frame_ms_max": max(times),
              "clamped_share": clamped_share(kept)}
    if record is not None:
        detail["regions"] = record["regions"]
        detail["labelled_share"] = record["labelled_share"]
    return {"correct": ok and finite and bool(kept), "attempted": n,
            "failed": 0 if finite else n, "metrics": metrics, "peak": peak, "record": record,
            "checks": checks, "detail": detail}
