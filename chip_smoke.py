#!/usr/bin/env python3
"""Smoke run of the PyTorch port (srgan_st_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

From the root of a checkout, with one NVIDIA H100 (sm_90a) and the CUDA
toolkit. In order, each phase printing one JSON line:

  env      torch and CUDA versions, the card and its power limit;
  build    nvcc builds csrc/*.cu from a clean build directory;
  kernel   each hand-written kernel against its plain PyTorch version on
           the same inputs, at the serving path's shapes (and kernel A at
           its training-scale shape), in f32 (TF32 off) and in bf16;
  serve    seeded full-width weights (16 RCB, 64 channels, x4) written as
           a JAX-format npz and served in bf16 through make_infer_fn /
           upscale_image: a 960x540 frame in the composed tail mode and
           with TAIL_MODE="fused", an odd 541x383 frame in both, and the
           960x540 frame through TILED_EVAL. The launch counts are reset
           just before these requests and read just after;
  check    the composed, fused and tiled outputs against each other within
           the network's bf16 envelope, and the CUDA f32 network against
           its CPU run (the plain versions) on a small frame;
  time     each kernel's time at 4K, its bound, its plain version's time
           and a cuDNN yardstick (printed after its gate), and ms per 4K
           frame in both tail modes, by CUDA events (median of 10 after
           warm-up);
  profile  device time by kernel over one 4K frame in each tail mode
           (torch.profiler), and the device's idle share.

Then the card's name and power limit as nvidia-smi prints them, one
{"kernels": [...]} line, and last {"ok": true, "device": {...}}. Any failed
gate raises and the script exits non-zero without that last line; so does
a machine with no GPU, or a directory without the port beside the script.

f32 references run with cuDNN and matmul TF32 off (both default to
TF32 or may, which keeps ~3 decimal digits). bf16 gates use the envelope
method: a kernel fed bf16 inputs is within 2x of what the plain version
itself loses by rounding in bf16, measured against the plain version in
f32 on the same bf16 inputs; a fixed epsilon is wrong for a K=5184
contraction.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
# H100 SXM data sheet: HBM3 bandwidth and dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
LR_4K = (540, 960)                  # LR frame of a 3840x2160 output
LR_ODD = (383, 541)                 # padded to 384x542 by upscale_image
# Kernel A's inputs: the training scale, then the serving path's
# pre-shuffle activations (whole 4K frame; a tile batch of TILED_EVAL's
# 144-px windows; the padded odd frame). The first serving shape is the
# one that is timed.
SHAPE_A_TRAIN = (16, 48, 48, 256)
SHAPE_A_4K = (1, 1080, 1920, 256)
SHAPES_A = (SHAPE_A_TRAIN, SHAPE_A_4K, (16, 288, 288, 256), (1, 768, 1084, 256))
# Kernel B's inputs (the last upsample block's input): 4K, the odd frame,
# whose 542 quarter-resolution columns end in a partial tile
SHAPE_B_4K = (1, 1080, 1920, 64)
SHAPES_B = (SHAPE_B_4K, (1, 768, 1084, 64))


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of fn() over `iters` runs, each between two
    CUDA events, after `warmup` runs."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def envelope_gate(name, shape, got32, ref32, got16, ref16, plain16) -> dict:
    """f32: max|d| <= 1e-4 max|ref|. bf16: max|kernel - ref16| <= 2x the
    envelope max|plain16 - ref16|, where ref16 is the plain version in f32
    on the bf16 inputs and plain16 the plain version computed in bf16."""
    err32, scale = max_abs(got32, ref32), float(ref32.abs().max())
    env, err16 = max_abs(plain16, ref16), max_abs(got16, ref16)
    rec = {"kernel": name, "shape": list(shape), "f32_max_abs_err": err32,
           "f32_tol": 1e-4 * scale, "bf16_max_abs_err": err16,
           "bf16_envelope": env}
    emit("kernel", **rec)
    if not err32 <= 1e-4 * scale:
        raise AssertionError(f"{name} f32 at {shape}: {err32} > 1e-4 * {scale}")
    if not (env > 0 and err16 <= 2 * env):
        raise AssertionError(f"{name} bf16 at {shape}: {err16} > 2 * {env}")
    return rec


def _worst(gated: list[dict]) -> dict:
    """One record for a kernel gated at several shapes: its largest errors."""
    return {"kernel": gated[0]["kernel"],
            "gated_shapes": [g["shape"] for g in gated],
            "f32_max_abs_err": max(g["f32_max_abs_err"] for g in gated),
            "bf16_max_abs_err": max(g["bf16_max_abs_err"] for g in gated)}


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_build() -> None:
    import shutil

    from srgan_st_tpu_torch.kernels import _build

    shutil.rmtree(_build.build_dir(), ignore_errors=True)
    t0 = time.perf_counter()
    done = _build.build(ptxas_verbose=True)
    seconds = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in rec["log"].splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, rec in done.items()}
    emit("build", seconds=seconds, kernels=sorted(done), ptxas=ptxas)


def _coarse_w2(gen, dev):
    """The coarse kernel of a random 9x9 64 -> 3 conv: conv3's own."""
    import torch

    from srgan_st_tpu_torch.ops.subpixel_conv import _coarse_kernel

    w3 = torch.randn(9, 9, 64, 3, generator=gen, device=dev) / (81 * 64) ** 0.5
    return _coarse_kernel(w3, 2)


def phase_kernel_a(gen, dev) -> dict:
    """Kernel A against its plain version at each of SHAPES_A; times at 4K."""
    import torch
    import torch.nn.functional as F

    from srgan_st_tpu_torch.kernels import coarse_conv as cc
    from srgan_st_tpu_torch.ops.subpixel_conv import conv_nhwc, space_to_depth

    gated = []
    for shape in SHAPES_A:
        x = torch.rand(shape, generator=gen, device=dev)
        w2 = _coarse_w2(gen, dev)
        ref32, got32 = cc.coarse_conv_s2d_reference(x, w2), cc.coarse_conv_s2d(x, w2)
        xb, wb = x.bfloat16(), w2.bfloat16()
        del x
        ref16 = cc.coarse_conv_s2d_reference(xb, wb)
        plain16 = space_to_depth(conv_nhwc(xb, wb), 2)
        got16 = cc.coarse_conv_s2d(xb, wb)
        torch.cuda.synchronize()
        gated.append(envelope_gate("coarse_conv_s2d", shape, got32, ref32, got16,
                                   ref16, plain16))
        del ref32, got32, ref16, plain16, got16
        if shape == SHAPE_A_4K:
            x4k, w4k = xb, wb
    rec = _worst(gated)
    xb, wb = x4k, w4k
    b, h, w, c = SHAPE_A_4K
    w_oihw = wb.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    nbytes = xb.numel() * 2 + b * (h // 2) * (w // 2) * 48 * 4 + wb.numel() * 2
    flops = 2 * b * (2 * h) * (2 * w) * 81 * (c // 4) * 3  # the 9x9 64 -> 3 conv
    rec.update(
        shape=list(SHAPE_A_4K),
        ms=cuda_ms(lambda: cc.coarse_conv_s2d(xb, wb)),
        plain_ms=cuda_ms(lambda: cc.coarse_conv_s2d_reference(xb, wb)),
        library_ms=cuda_ms(lambda: F.conv2d(xb.permute(0, 3, 1, 2), w_oihw, padding=2)),
        bytes=nbytes, flops=flops,
        flops_doubly_coarse=2 * b * (h // 2) * (w // 2) * 18 * (2 * c) * 48,
    )
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops)
    emit("kernel_time", **rec)
    return rec


def phase_kernel_b(gen, dev) -> dict:
    """Kernel B against its plain version at each of SHAPES_B; times at 4K."""
    import torch
    import torch.nn.functional as F

    from srgan_st_tpu_torch.kernels import serving_tail as st
    from srgan_st_tpu_torch.ops.subpixel_conv import _coarse_kernel

    b, h, w, c = SHAPE_B_4K
    w_up = torch.randn(3, 3, c, 4 * c, generator=gen, device=dev) / (9 * c) ** 0.5
    b_up = 0.1 * torch.randn(4 * c, generator=gen, device=dev)
    alpha = torch.tensor(0.2, device=dev)
    w3 = torch.randn(9, 9, c, 3, generator=gen, device=dev) * 0.5 / (81 * c) ** 0.5
    b3 = torch.full((3,), 0.5, device=dev)
    gated = []
    for shape in SHAPES_B:
        y = torch.rand(shape, generator=gen, device=dev)
        ref32, got32 = (st.serving_tail_reference(y, w_up, b_up, alpha, w3, b3),
                        st.serving_tail(y, w_up, b_up, alpha, w3, b3))
        y16 = y.bfloat16()
        del y
        ref16 = st.serving_tail_reference(y16.float(), w_up.bfloat16().float(), b_up,
                                          alpha, w3.bfloat16().float(), b3)
        plain16 = st.serving_tail_reference(y16, w_up, b_up, alpha, w3, b3)
        got16 = st.serving_tail(y16, w_up, b_up, alpha, w3, b3)
        torch.cuda.synchronize()
        gated.append(envelope_gate("serving_tail", shape, got32, ref32, got16,
                                   ref16, plain16))
        del ref32, got32, ref16, plain16, got16
        if shape == SHAPE_B_4K:
            yb = y16
    rec = _worst(gated)

    # cuDNN yardstick: up-conv + bias, PReLU, then the coarse conv of conv3
    bf = torch.bfloat16
    wu_oihw = w_up.to(bf).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    w2_oihw = _coarse_kernel(w3.to(bf), 2).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    a16, bu16 = alpha.to(bf), b_up.to(bf)

    def library():
        t = F.conv2d(yb.permute(0, 3, 1, 2), wu_oihw, bu16, padding=1)
        return F.conv2d(torch.where(t >= 0, t, a16 * t), w2_oihw, padding=2)

    nbytes = yb.numel() * 2 + b * (h // 2) * (w // 2) * 48 * 2
    flops = (2 * b * h * w * 9 * c * 4 * c               # 3x3 64 -> 256 up-conv
             + 2 * b * (2 * h) * (2 * w) * 81 * c * 3)   # 9x9 64 -> 3 conv3
    rec.update(
        shape=list(SHAPE_B_4K),
        ms=cuda_ms(lambda: st._launch(yb, w_up, b_up, alpha, w3)),
        wrapper_ms=cuda_ms(lambda: st.serving_tail(yb, w_up, b_up, alpha, w3, b3)),
        plain_ms=cuda_ms(lambda: st.serving_tail_reference(yb, w_up, b_up, alpha, w3, b3)),
        library_ms=cuda_ms(library), bytes=nbytes, flops=flops,
    )
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops)
    emit("kernel_time", **rec)
    return rec


def _serve_fns(gpath, dev):
    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.eval.infer import make_infer_fn

    fns = {}
    for mode, dtype, tail, tiled in (("composed", "bfloat16", None, False),
                                     ("fused", "bfloat16", "fused", False),
                                     ("tiled", "bfloat16", None, True),
                                     ("f32", "float32", None, False)):
        cfg = Config()
        cfg.TPU.COMPUTE_DTYPE, cfg.TPU.TAIL_MODE, cfg.TPU.TILED_EVAL = dtype, tail, tiled
        fns[mode] = make_infer_fn(cfg, gpath=gpath, device=dev)
    return fns


def phase_serve(fns, frames) -> tuple[dict, dict]:
    """The main path: requests through upscale_image, launch counts reset
    just before and read just after."""
    import torch

    from srgan_st_tpu_torch.eval.infer import upscale_image
    from srgan_st_tpu_torch.kernels import launch_counts, reset_launch_counts

    requests = [("composed", "960x540"), ("fused", "960x540"),
                ("composed", "541x383"), ("fused", "541x383"),
                ("tiled", "960x540")]
    need = {"composed": "coarse_conv_s2d", "tiled": "coarse_conv_s2d",
            "fused": "serving_tail"}
    outs = {}
    reset_launch_counts()
    for mode, frame in requests:
        before = launch_counts()
        t0 = time.perf_counter()
        sr = upscale_image(fns[mode], frames[frame], 4)
        seconds = time.perf_counter() - t0
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        lh, lw = frames[frame].shape[:2]
        emit("serve", mode=mode, frame=frame, out_shape=list(sr.shape),
             seconds=seconds, launches=delta)
        if sr.shape != (4 * lh, 4 * lw, 3) or not np.isfinite(sr).all():
            raise AssertionError(f"{mode} {frame}: bad output {sr.shape}")
        if delta[need[mode]] < 1:
            raise AssertionError(f"{mode} {frame} did not launch {need[mode]}")
        outs[(mode, frame)] = sr
    counts = launch_counts()
    emit("serve", launches_total=counts)
    if min(counts.values()) < 1:
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    torch.cuda.synchronize()
    return outs, counts


def phase_check(fns, frames, outs, rng) -> dict:
    """Outputs against each other within the network's bf16 envelope (the
    bf16 composed output against the f32 network on the same frame), and
    the CUDA f32 network against its CPU run on a small frame."""
    import torch

    from srgan_st_tpu_torch.eval.infer import upscale_image

    rec = {}
    for frame, lr in frames.items():
        composed, fused = outs[("composed", frame)], outs[("fused", frame)]
        f32 = upscale_image(fns["f32"], lr, 4)
        env = float(np.abs(composed - f32).max())
        d_fused = float(np.abs(fused - composed).max())
        rec[frame] = {"bf16_envelope": env, "fused_vs_composed": d_fused,
                      "fused_vs_f32": float(np.abs(fused - f32).max())}
        if not (env > 0 and d_fused <= 2 * env):
            raise AssertionError(f"{frame}: fused vs composed {d_fused} > 2 * {env}")
        if frame == "960x540":
            d_tiled = float(np.abs(outs[("tiled", frame)] - composed).max())
            rec[frame]["tiled_vs_whole"] = d_tiled
            if not d_tiled <= env:
                raise AssertionError(f"tiled vs whole {d_tiled} > {env}")
        rec[frame]["unclamped_share"] = float(((f32 > 0) & (f32 < 1)).mean())

    # the CUDA f32 network (kernels) against the CPU one (plain versions)
    cpu = copy.deepcopy(fns["f32"].model).cpu()
    lr = torch.from_numpy(rng.random((1, 32, 40, 3), np.float32))
    with torch.inference_mode():
        want = cpu(lr).numpy()
    got = upscale_image(fns["f32"], lr[0].numpy(), 4)[None]
    d_cpu = float(np.abs(got - want).max())
    rec["f32_cuda_vs_cpu_32x40"] = d_cpu
    emit("check", **rec)
    if not d_cpu <= 1e-4:
        raise AssertionError(f"f32 CUDA vs CPU network: {d_cpu} > 1e-4")
    return rec


def phase_time(fns, rng, dev) -> dict:
    """ms per 4K frame (device input, device output) in both tail modes."""
    import torch

    from srgan_st_tpu_torch.kernels import launch_counts, reset_launch_counts

    x = torch.from_numpy(rng.random((1, *LR_4K, 3), np.float32)).to(dev)
    mp = 4 * LR_4K[0] * 4 * LR_4K[1] / 1e6
    rec = {}
    for mode in ("composed", "fused"):
        reset_launch_counts()
        fns[mode](x)
        per_frame = launch_counts()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: fns[mode](x))
        rec[mode] = {"ms_per_frame": ms, "hr_mp_per_s": mp / (ms / 1e3),
                     "launches_per_frame": per_frame,
                     "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    emit("time", frame="960x540 -> 3840x2160", **rec)
    return rec


def phase_profile(fns, rng, dev) -> dict:
    """Device time by kernel over one 4K frame in each tail mode
    (torch.profiler), and the device's idle share of the window from the
    first kernel's start to the last one's end."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.from_numpy(rng.random((1, *LR_4K, 3), np.float32)).to(dev)
    rec = {}
    for mode in ("composed", "fused"):
        fns[mode](x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fns[mode](x)
            torch.cuda.synchronize()
        by_name, starts, ends = {}, [], []
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
                starts.append(e.time_range.start)
                ends.append(e.time_range.end)
        busy = sum(by_name.values())
        window = (max(ends) - min(starts)) / 1e3 if ends else 0.0
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        rec[mode] = {"device_busy_ms": busy, "device_window_ms": window,
                     "idle_share": 1 - busy / window if window else None,
                     "kernels": len(starts),
                     "top_ms": [[name[:100], ms] for name, ms in top]}
    emit("profile", frame="960x540 -> 3840x2160", **rec)
    return rec


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU; the smoke run needs one", file=sys.stderr)
        return 1
    try:
        import srgan_st_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})", file=sys.stderr)
        return 1
    if os.path.dirname(os.path.dirname(os.path.abspath(srgan_st_tpu_torch.__file__))) != HERE:
        print("chip_smoke: srgan_st_tpu_torch is not the one beside this script",
              file=sys.stderr)
        return 1
    return run(torch.device("cuda"))


def run(dev) -> int:
    """Every phase, on the CUDA device `dev`."""
    import torch

    from srgan_st_tpu_torch.models.generator import random_variables
    from srgan_st_tpu_torch.train.checkpoint import save_variables_npz

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi)
    phase_build()

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rec_a = phase_kernel_a(gen, dev)
    torch.cuda.empty_cache()
    rec_b = phase_kernel_b(gen, dev)
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        gpath = os.path.join(tmp, "g_best.npz")
        save_variables_npz(gpath, random_variables(0))
        fns = _serve_fns(gpath, dev)
    frames = {"960x540": rng.random((*LR_4K, 3), np.float32),
              "541x383": rng.random((*LR_ODD, 3), np.float32)}
    outs, counts = phase_serve(fns, frames)
    phase_check(fns, frames, outs, rng)
    phase_time(fns, rng, dev)
    phase_profile(fns, rng, dev)

    kernels = []
    for rec, name, source, replaces in (
        (rec_a, "coarse_conv_s2d", "srgan_st_tpu_torch/csrc/coarse_conv.cu",
         "srgan_st_tpu/kernels/coarse_conv.py:45 (_kernel), "
         "srgan_st_tpu/kernels/coarse_conv.py:86 (_kernel_tiled)"),
        (rec_b, "serving_tail", "srgan_st_tpu_torch/csrc/serving_tail.cu",
         "srgan_st_tpu/kernels/serving_tail.py:70 (_kernel)"),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": rec["bf16_max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "shape": rec["shape"], "f32_max_abs_err": rec["f32_max_abs_err"],
        })
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
