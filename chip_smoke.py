#!/usr/bin/env python3
"""Smoke run of the PyTorch port (srgan_st_tpu_torch) on one CUDA GPU.

    python3 chip_smoke.py

from the root of a checkout, with one NVIDIA H100 (sm_90a) and the CUDA
toolkit. In order, each phase printing one JSON line:

  env      torch and CUDA versions, the card and its power limit;
  build    nvcc builds csrc/*.cu from a clean build directory; each
           kernel's registers and spills (ptxas) and the bf16 wgmma
           kernels' shared memory (A, B, and K4/K5's conv and wgrad tiles);
           a spill in any instantiation of those fails the run;
  kernel   kernels A and B against their plain PyTorch versions on the
           same inputs, at the serving path's shapes (the viz phase's
           frame among them), kernel A at its
           training-scale shape, and an edge shape each whose quarter
           grid divides no tile, in f32 (TF32 off) and in bf16; a second
           launch must give the same bits; then kernel E (the eval trunk,
           16 blocks and the fusion conv, bf16 only) at every trunk shape
           the serve requests give it and an odd edge shape, within 2x its
           plain version's own bf16 envelope, with a second call's bits,
           and its time at 4K beside its bound, its plain version's and
           the cuDNN blocks' (`--only eval_trunk`: the build and this
           alone); then kernel R (Real-ESRGAN's RRDBs, bf16 only) at
           (1, 37, 53), (2, 64, 96) and the video frame within 2x its plain
           version's envelope, a second call's bits, one RRDB's and the
           23's times at 540p beside the bound, the plain version and the
           cuDNN blocks, the 23's output within the same rule; then
           kernel H (the RRDB generator's HR stage, bf16 only) at (3, 37,
           53), (2, 17, 131) and the video frame, its u2 and frame within
           2x its plain version's envelope, a second pair of calls' bits,
           its time at 540p beside its bound, the plain version and the
           torch HR stage; then the RRDB serving entry
           (make_generator_apply, G_ARCH "rrdb"): one 540p frame's launch
           counts, reset just before it (`--only rrdb_dense`: the build
           and these alone); then kernel W (SwinIR's window attention
           core, bf16 only) at the SwinIR cell's core, (8160, 64, 540), an
           unshifted and a shifted block's, within 2x its plain version's
           distance from float64 and 2^-7 max |v|, a second call's bits,
           its time beside its bound, the plain version and the padded
           scaled_dot_product_attention core the port ran before; then the
           SwinIR serving entry (G_ARCH "swinir", the SwinIR cell's seeded
           weights): one 540p frame's launch counts, reset just before it,
           with scaled_dot_product_attention made to raise, the same frame
           again with the same bits, and kernel H on the (1, 544, 960, 64)
           map that frame gives it, with conv_last's bias plus the mean,
           within 2x its plain version's envelope (`--only swinir`: the
           build and these alone);
  serve    seeded full-width weights (16 RCB, 64 channels, x4) written as
           a JAX-format npz and served in bf16 through make_infer_fn /
           upscale_image: a 960x540 frame in the composed tail mode and
           with TAIL_MODE="fused", an odd 541x383 frame in both, the
           960x540 frame through TILED_EVAL and with TRUNK_MODE="xpack"
           (BatchNorm folded into the trunk's convs), and an odd 61x47
           frame through the x8 self-ensemble (kernels A and E exactly 8
           times each; every request but xpack's runs its trunk as E).
           The launch counts are reset just before these requests and read
           just after;
  check    the composed, fused and tiled outputs against each other within
           the network's bf16 envelope, the xpack and the composed (kernel
           E) outputs against the f32 network within 2x the bf16 blocks'
           (TRUNK_MODE="unfused") envelope, the x8 ensemble against the
           f32 network's ensemble within 2x its frame's envelope, and the
           CUDA f32 network against its CPU run (the plain versions) on a
           small frame;
  time     each kernel's time at 4K on laid-out weights, its bound, its
           design's own floor (the wgmma work its library counts from its
           tiles, at the bf16 peak), the
           achieved bandwidth (A) or tensor rate (B), its plain version's
           time and a cuDNN yardstick (printed after its gate), kernel A's
           time at the training shape, and ms per 4K frame in both tail
           modes and with the xpack trunk, by CUDA events (median of 10
           after warm-up);
  profile  device time by kernel over one 4K frame in each tail mode and
           with the xpack trunk (torch.profiler), and the device's idle
           share;
  viz      the figure tools (viz/) at full width: the comparison figure
           (comparison_crops) of a seeded 256x256 LR frame and its
           1024x1024 GT for gt, bicubic, nearest and two experiments (the
           seeded generator's g_best.npz, bf16), with the composed and with
           the fused tail, launch counts reset before and read after each
           figure (kernel A, or B, once per experiment): each experiment
           crop bit for bit the same crop of a direct make_generator_apply
           call, whose whole frame lies within 2x the bf16 envelope (the
           plain bf16 network, no kernel, against the plain f32 one); the
           feature maps of vgg (a seeded random VGG19 npz, 512x512) and disc
           (96x96, 512x512), f32, each tap within 1e-4 of max|act| of the
           same model on the CPU and each grid within one uint8 level; the
           best-buddy scores of a seeded 765x765 image (2,601 patches
           against a 3,370-patch bank, d = 675) on the card and on the CPU,
           5 targets ranked (k = 6) on the host: equal bank indices, or at
           each rank that differs f64 scores within 1e-6 relative (a near
           tie); every figure's PNGs written with zlib alone, their count and
           bytes.

Then the training slice, bf16 with TRUNK_MODE="packed" unless named:

  kernel   the trunk kernels K4 (forward) and K5 (backward) against their
           plain versions at the training shape (16, 24, 24, 64), n = 16,
           an edge shape (3, 22, 26, 64), n = 2, and two channel tiles
           (2, 12, 16, 128), n = 2, in f32 and bf16, K5 on the residuals K4
           saved; a second run of each must give the same bits (the
           reductions are deterministic). Then their times at the training
           shape (the wrapper, which lays the weights out as a train step
           does, and the launch on weights laid out in advance), bounds,
           the bf16 design's own floor (the wgmma work the library counts),
           the host's time to enqueue one call, plain times, a cuDNN
           yardstick (the unfused trunk of F.conv2d + F.batch_norm +
           F.prelu, forward and autograd backward), and a torch.profiler
           breakdown of one launch and one wrapper call each by CUDA
           kernel; the kernels the profiler sees in one launch must number
           the launches per call that the library reports; then "hybrid"
           (the plain forward, then K5 on its residuals, through
           `hybrid_trunk`) against the plain backward on the same
           residuals at the same shapes, with K5's gates and a second
           run's bits (dal, in bf16: its per-block error rate against the
           f64 evaluation of the same residuals within 2x the plain bf16
           version's), then those gates over 10 seeded draws at each shape
           (`seed_sweep`), each gate's worst ratio and the f64 yardsticks;
  train    seeded full-width G (16 RCB, 64 ch) and D (64 ch), batch 16 of
           synthetic uint8 96x96 patches, through warmup() then train()
           (3 batches each, D_UPDATE_INTERVAL=2) in a temporary working
           directory; launch counts reset just before and read just after
           (K4 = K5 = 1 per G step, kernel A = 1 per G forward); then one
           more G and D step checked for finite losses, moved parameters,
           and D statistics that move in the G step;
  check    one GAN step (G step + D step) with the packed and the unfused
           trunk from the same seeded state: parameters within 2.01 lr
           (Adam's first update moves a weight by less than lr, either way,
           plus the f32 rounding of the weight), losses within 1e-2
           relative (3.4e-4 measured on the H100; each bf16 trunk's
           distance to the f32 step is printed for scale);
  time     ms per warmup step, per G step and per GAN step (G + D), packed
           and unfused, by CUDA events (median of 10), and patches/s; then
           12 packed / unfused GAN step pairs timed in turns, with the
           median, min and max of the per-pair ratio;
  profile  one GAN step of each trunk under torch.profiler;
  data     a patches.pack.npy the size of DIV2K tiled at 96^2 (130,208
           patches, 3.6 GB, written with open_memmap, each patch's first 8
           bytes its index), which DATA.DEVICE_CACHE="auto" copies to the
           card: for epochs 0 and 1 the resident and the host path give the
           (seed, epoch) permutation's indices in the same order, and the
           first and last batches bit for bit; ms per batch fetch to the
           card, host and resident, in turns; train() (Adversarial, bf16,
           packed, full width, global batch 16, 24 batches an epoch) from the
           pack with DEVICE_CACHE on and off, 2 runs each in turns, its G and
           GAN step times from the batches' hand-out times and patches/s at
           the reference cadence, K4 = K5 = 1 per G step; then, from a pack
           of 120^2 tiles with DATA.AUGMENT, the card's crop + augment equal
           to the CPU function given the same draws (gt bit for bit, lr
           within one 1/255 level) and a warmup() from that pack;
  dist     two gloo ranks on the one card through warmup() and train()
           (3 + 3 batches, full width, global batch 16): (a) sync-BN (f32,
           the unfused trunk) against one process on the global batch:
           losses within 1e-2 relative, parameters within 2.01 lr per Adam
           update, running statistics within 1e-3 relative, both ranks bit
           for bit; (b) LOCAL_BN (bf16, packed): K4 and K5 once per rank per
           G step, kernel A once per G forward, running statistics and
           parameters bit-identical across the ranks; (c) a one-rank NCCL
           group through train's command-line entry; (d) the tiled eval of a
           960x540 frame over the two ranks, bit for bit the one-rank output;
           per-rank GAN step ms, noted as two ranks sharing one card; (e)
           the LOCAL_BN run and the NCCL run with EXP.ORBAX_CHECKPOINTS
           (torch.distributed.checkpoint train states): both gloo ranks save
           collectively (rank 1 with NaN metrics) and see is_best, and
           train()'s `last/` and a save_epoch directory restore into fresh
           states bit for bit (parameters, running statistics, Adam moments
           and counts, step), the NCCL run's also equal to its npz weights;
           the save and restore seconds; then a save of another state into
           the save_epoch directory whose DCP writer raises partway on rank
           1 (rank 0 in the one-rank runs): every rank sees DCP's
           CheckpointException, the old `last/` stays, and a fresh state
           restores it bit for bit;
  soak     srgan_st_tpu_torch.tools.soak at a cut size (1,600 patches, 2
           warmup and 4 GAN epochs, full width, bf16, packed, graph steps):
           warmup() and the GAN phase (Adversarial + Pixel + PatchwiseST +
           ContentDiscriminator) as subprocesses from a seeded pack, the
           uninterrupted run beside a `.state.pt` run SIGKILLed after 3 log
           lines of epoch 3 and a DCP run SIGKILLed while a data file of
           `last` is written (seen on disk), each relaunched: the resume
           epoch, Test/PSNR for every epoch, a best PSNR that never fell, a
           whole checkpoint set, final g_last / d_last bit for bit the
           uninterrupted run's; A, K4 and K5 in every training child, K7
           in every GAN child; the phase's seconds;
  loss_study  tools/loss_study.py's table (4 perturbations x 5 losses x 6
           strengths of a 96x96 patch) on the card against the CPU: within
           1e-4 of each curve's largest value, or a buddy loss whose picks
           differ from the CPU's only at f64 near ties; K7 once per buddy
           loss call.

Then the structure-tensor loss study (`run`, job 1: Adversarial +
PatchwiseST + ContentDiscriminator), bf16:

  kernel   the buddy selection K7 against its plain version on the
           PatchwiseST features of a seeded batch at its shape (16, 1024, 27)
           x (16, 1344, 27), bf16 and f32, on the Gram features (d = 9), at
           an edge shape whose N and M divide no tile, on a duplicate-heavy
           bank, on a near-tie bank (kernels/_checks.py near_tie_bank: two
           rows per patch that the f32 expansion's rounding orders; every
           index must be the f64-best row, which the refine of the kernels
           and of the plain version gives, and the plain version's), and
           in l1 at a small shape; then gate (a) over 10 more seeded
           batches of PatchwiseST features, bf16 and f32, beside the rows
           where the f32 expansion alone misses the f64 best by more than
           the gate's rtol. Gates: (a) each index equal to
           the plain version's, or its f64 score within 1e-6 relative of the
           f64 minimum; (b) on the duplicate-heavy bank, no index into the
           copied half and the f64 argmin on every row that is not a near
           tie; (c) the gathered rows are bank rows bit for bit. Each case
           names the variant that ran (bf16 l2: "mma", the tensor-core
           kernel; f32 and l1: "simt"). Then its time, the SIMT kernel's on
           the same bf16 inputs (its C entry: the design before), the plain
           version's and the library composition's (two torch.baddbmm +
           torch.argmin: the plain version without its refine), by CUDA events
           around one call, and their device times (`device_ms`: calls
           queued behind device work; one K7 call is shorter on the device
           than on the host);
  kernel   the whole-trunk forward K6 against its plain version at
           TRUNK_SHAPES, f32 and bf16 (the K4 gates), y, the residuals and
           the stats, a second run's bits, and in bf16 the bits of K4's
           outputs on the same inputs; its grid and grid barriers a call;
           its wrapper and launch times in turns with K4's, beside the cuDNN
           trunk's, the device times of both launches, a profile of one
           launch, and where its convs spend their time (its probe: tiles,
           barrier, moment sums, per conv);
  run      main.py's job 1 (`python -m srgan_st_tpu_torch run --job_index
           1`) at full width in a temporary directory, 3 batches, with
           TRUNK_MODE "fused" and then "unfused", then jobs 3 and 4 with
           "packed", then the ContentVGG jobs 0 ("packed") and 2 ("xpack",
           which is "packed" in training)
           on a seeded random VGG19 written in tools/convert_vgg19.py's npz
           format (MODEL.G_LOSS.VGG19_WEIGHTS); launch counts reset just
           before each and read just after (K7 = 1 per G step of jobs 0
           and 1, K6 = 1 per G step forward under "fused", K4 = K5 = 1 per
           G step under "packed" and "xpack", kernel A = 1 per G forward);
  check    one GAN step from the same seeded state with each of two
           trunks, within the train gates above: job 1 fused / unfused,
           job 0 packed / unfused, job 2 xpack / unfused;
  time     ms per warmup, G and GAN step of job 1 (fused, packed, unfused)
           and job 0 (packed, unfused), and patches/s; 12 packed /
           unfused GAN step pairs of job 0 in turns; a profile of job 1's
           fused and job 0's packed GAN step, and ContentVGG's share of
           job 0's device time (its forward and sr backward on the step's
           batch, over the packed GAN step's busy time).

Then the trajectory replay (srgan_st_tpu_torch/tools/trajectory.py), with
torch's default TF32 switches, as the port's training runs:

  trajectory  the four training goldens (the executed reference's 20
           warmup + 20 GAN steps at a 2 RCB / 16 ch G, 4 ch D, batch 8)
           replayed in f32 and in bf16, each through the step functions and
           through the chunk steps replayed from CUDA graphs, held to the
           JAX tool's gates on the first 5 steps (f32 2e-3 / 1.5e-2 / 5e-2,
           bf16 4e-2 / 1.5e-1 / 3e-1: warmup G, GAN G, GAN D loss); then the
           full-width window of the same recipes (16 RCB / 64 ch, batch 16,
           torch-seeded weights), each against the port's f32 plain
           reference on the card (every kernel on its plain version, TF32
           off, eager steps): the shipping bf16 recipe in chunk steps for
           each, and flagship under TRUNK_MODE="fused", at the bf16 gates.
           Every run's launch counts, reset at its start and read at its
           end: kernel A once per warmup and G step, K7 once per G step of
           flagship, gram-vgg and bb and none in st, K4 = K5 = once per
           warmup and G step of the full-width shipping runs, K6 once per
           warmup and G step of the fused run and nowhere else, nothing in
           the references; one line with every max_rel beside its gate.

Then the rest of serving, last (after a torch.export in the process,
torch.profiler misses a kernel of K4 or K5, which the trunk profiles gate):

  baseline the bicubic baseline (EXP.NAME "bicubic") through test() on the
           synthetic pairs, on the card and on the CPU: the same PSNR/SSIM;
  artifact full-width bf16 torch.export artifacts, fixed at the 4K frame
           and dynamic (checked at an odd and a batched size), exported,
           saved and loaded on the card, bit for bit the live plain path
           with cuDNN on deterministic algorithms; ms per 4K frame of the
           fixed artifact and the live plain path.

Then the card's name and power limit as nvidia-smi prints them, one
{"kernels": [...]} line (a row for each of the TPU kernels K1-K7), and last
{"ok": true, "device": {...}}. Any failed
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

try:  # the port's timers and one-call profile; main() reports a missing port
    from srgan_st_tpu_torch.utils.profiling import cuda_ms, device_ms, profile_once
except ImportError:
    pass

HERE = os.path.dirname(os.path.abspath(__file__))
# H100 SXM data sheet: HBM3 bandwidth and dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
LR_4K = (540, 960)                  # LR frame of a 3840x2160 output
LR_ODD = (383, 541)                 # padded to 384x542 by upscale_image
LR_ENSEMBLE = (47, 61)              # the x8 ensemble's odd frame (both orientations)
VIZ_LR = (256, 256)  # the comparison figure's LR frame (its GT is 1024x1024)
# Kernel A's inputs: the training scale, then the serving path's
# pre-shuffle activations (whole 4K frame; a tile batch of TILED_EVAL's
# 144-px windows; the padded odd frame; the viz phase's frame). The first
# serving shape is the one that is timed.
SHAPE_A_TRAIN = (16, 48, 48, 256)
SHAPE_A_4K = (1, 1080, 1920, 256)
# an edge shape: a 13 x 70 quarter grid divides neither of the bf16 kernel's
# 8 x 64 tile sides (nor the f32 kernel's 2 x 64); then the trajectory
# goldens' training shape (batch 8, 4 x 16 channels: K = 2C = 128)
SHAPES_A = (SHAPE_A_TRAIN, SHAPE_A_4K, (16, 288, 288, 256), (1, 768, 1084, 256),
            (1, 2 * VIZ_LR[0], 2 * VIZ_LR[1], 256), (1, 26, 140, 256), (8, 48, 48, 64))
# Kernel B's inputs (the last upsample block's input): 4K, the odd frame,
# whose 542 quarter-resolution columns end in a partial tile, the viz
# phase's frame, and an edge shape whose 5 x 31 quarter grid divides neither
# side of the bf16 kernel's 4 x 30 tile (nor the f32 kernel's 2 x 16)
SHAPE_B_4K = (1, 1080, 1920, 64)
SHAPES_B = (SHAPE_B_4K, (1, 768, 1084, 64), (1, 2 * VIZ_LR[0], 2 * VIZ_LR[1], 64),
            (1, 10, 62, 64))

# Kernel E's inputs (the eval trunk's stem output): the 4K frame, the padded
# odd frame, a tile batch of TILED_EVAL's 144-px windows, the x8 ensemble's
# odd frame in both orientations, a two-frame batch, and an odd edge shape
# narrower than one 64-pixel row tile
SHAPE_E_4K = (1, *LR_4K, 64)
SHAPES_E = (SHAPE_E_4K, (1, 384, 542, 64), (16, 72, 72, 64), (1, *LR_ENSEMBLE, 64),
            (1, LR_ENSEMBLE[1], LR_ENSEMBLE[0], 64), (2, 96, 96, 64), (1, 37, 53, 64))
E_BLOCKS = 16
# kernel R: the gated shapes (2 RRDBs; 1 at the video cell's frame), and
# the published trunk's RRDBs for the timing
SHAPE_R_4K = (1, *LR_4K, 64)
SHAPES_R = ((1, 37, 53, 64), (2, 64, 96, 64), SHAPE_R_4K)
# kernel H's inputs (the trunk's output): a batch of odd tiles narrower
# than one 64-pixel tile, rows ending in a partial tile, the video frame
SHAPES_H = ((3, 37, 53, 64), (2, 17, 131, 64), SHAPE_R_4K)
R_BLOCKS = 23

# The trunk kernels' inputs: the training shape, then an edge shape whose
# pixel count and width do not divide the kernels' 64-pixel tiles, then two
# 64-channel tiles (the bf16 kernels' N tiles and K chunks)
TRUNK_SHAPES = (((16, 24, 24, 64), 16), ((3, 22, 26, 64), 2), ((2, 12, 16, 128), 2))
EPS = 1e-5
TRAIN_STEPS = 3  # batches per epoch of warmup() and train() in the train phase
TRUNK_PAIRS = 12  # packed / unfused GAN step pairs timed in turns
HYBRID_SEEDS = 10  # seeded draws at each TRUNK_SHAPES entry of the hybrid sweep


_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line of a phase, with the seconds since the script started."""
    print(json.dumps({"phase": phase, "elapsed_s": round(time.perf_counter() - _T0, 1),
                      **fields}), flush=True)


def host_ms(fn, iters: int = 10) -> float:
    """Median milliseconds the host takes to enqueue fn() (no synchronize
    inside the timed span), each call after the device went idle."""
    import torch

    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def envelope_gate(name, shape, got32, ref32, got16, ref16, plain16, same_bits) -> dict:
    """f32: max|d| <= 1e-4 max|ref|. bf16: max|kernel - ref16| <= 2x the
    envelope max|plain16 - ref16|, where ref16 is the plain version in f32
    on the bf16 inputs and plain16 the plain version computed in bf16.
    same_bits: {dtype: a second launch gave the same bits}."""
    err32, scale = max_abs(got32, ref32), float(ref32.abs().max())
    env, err16 = max_abs(plain16, ref16), max_abs(got16, ref16)
    rec = {"kernel": name, "shape": list(shape), "f32_max_abs_err": err32,
           "f32_tol": 1e-4 * scale, "bf16_max_abs_err": err16,
           "bf16_envelope": env, "bitwise_repeatable": same_bits}
    emit("kernel", **rec)
    if not err32 <= 1e-4 * scale:
        raise AssertionError(f"{name} f32 at {shape}: {err32} > 1e-4 * {scale}")
    if not (env > 0 and err16 <= 2 * env):
        raise AssertionError(f"{name} bf16 at {shape}: {err16} > 2 * {env}")
    if not all(same_bits.values()):
        raise AssertionError(f"{name} at {shape}: a second launch changed bits {same_bits}")
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


# the kernels ptxas reports by name, and the bf16 wgmma kernels whose
# dynamic shared memory the library reports (`<C entry>(*args)`, K4/K5's at
# the training shape's width and channels)
KERNEL_FUNCS = ("coarse_conv_wgmma", "coarse_conv_kernel", "serving_tail_wgmma",
                "serving_tail_kernel", "trunk_conv_wgmma", "trunk_wgrad_wgmma",
                "fused_trunk_wgmma", "buddy_mma_kernel", "eval_trunk_conv", "rrdb_dense_conv",
                "rrdb_hr_conv", "swin_attn_kernel")
WGMMA_SMEM = {"coarse_conv_wgmma": ("coarse_conv", "coarse_conv_s2d_bf16_smem", ()),
              "serving_tail_wgmma": ("serving_tail", "serving_tail_bf16_smem", ()),
              "trunk_conv_wgmma": ("packed_trunk", "packed_trunk_conv_smem", (24, 64)),
              "trunk_wgrad_wgmma": ("packed_trunk", "packed_trunk_wgrad_smem", (24, 64)),
              "fused_trunk_wgmma": ("fused_trunk", "fused_trunk_bf16_smem", (24, 64)),
              "eval_trunk_conv": ("eval_trunk", "eval_trunk_smem", ()),
              "rrdb_dense_conv": ("rrdb_dense", "rrdb_dense_smem", ()),
              "rrdb_hr_conv": ("rrdb_hr", "rrdb_hr_smem", ())}


def _ptxas_functions(log: str) -> dict:
    """{function: {"registers", "spill_stores", "spill_loads"}} from nvcc's
    -Xptxas -v output, functions named by KERNEL_FUNCS where one matches (the
    instantiations of a template as name/1, name/2, ...)."""
    import re

    out, fn = {}, None
    for ln in log.splitlines():
        if "Function properties for" in ln:
            mangled = ln.split("for", 1)[1].strip()
            fn = next((k for k in KERNEL_FUNCS if k in mangled), mangled)
            if fn in out:
                fn += f"/{sum(1 for k in out if k.split('/')[0] == fn)}"
            out[fn] = {}
        elif fn and "spill stores" in ln:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            out[fn].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif fn and "Used" in ln and "registers" in ln:
            out[fn]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
    return out


def phase_build() -> None:
    import shutil

    from srgan_st_tpu_torch.kernels import _build

    shutil.rmtree(_build.build_dir(), ignore_errors=True)
    t0 = time.perf_counter()
    done = _build.build(ptxas_verbose=True)
    seconds = time.perf_counter() - t0
    funcs = {}
    for rec in done.values():
        funcs.update(_ptxas_functions(rec["log"]))
    import ctypes

    for fn, (lib, entry, args) in WGMMA_SMEM.items():
        funcs[fn]["dynamic_smem_bytes"] = _build.load(
            lib, {entry: [ctypes.c_int] * len(args)})[entry](*args)
    ptxas = {name: [ln.strip() for ln in rec["log"].splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, rec in done.items()}
    emit("build", seconds=seconds, kernels=sorted(done), functions=funcs, ptxas=ptxas)
    # every instantiation of a bf16 wgmma kernel
    spilled = {fn: rec for fn, rec in funcs.items()
               if fn.split("/")[0] in WGMMA_SMEM and rec.get("spill_stores", 1)}
    if spilled:
        raise AssertionError(f"a bf16 wgmma kernel spills: {spilled}")


def _coarse_w2(gen, dev, c: int = 256):
    """The coarse kernel of a random 9x9 c/4 -> 3 conv (conv3's own) for a
    pre-shuffle activation of c channels."""
    import torch

    from srgan_st_tpu_torch.ops.subpixel_conv import _coarse_kernel

    cin = c // 4
    w3 = torch.randn(9, 9, cin, 3, generator=gen, device=dev) / (81 * cin) ** 0.5
    return _coarse_kernel(w3, 2)


def design_flops(lib: str, entry: str, *dims: int) -> float:
    """The MMA work of one bf16 launch at `dims`, as the kernel library
    counts it from its own tiles (`<C entry>_mma_flops`)."""
    import ctypes

    from srgan_st_tpu_torch.kernels import _build

    fn = getattr(_build.load(lib, {entry: [ctypes.c_int] * len(dims)
                                   + [ctypes.POINTER(ctypes.c_double)]}), entry)
    out = ctypes.c_double()
    _build.check(fn(*dims, ctypes.byref(out)), entry)
    return out.value


def phase_kernel_a(gen, dev) -> dict:
    """Kernel A against its plain version at each of SHAPES_A, with a second
    launch's bits; times at 4K and at the training shape."""
    import torch
    import torch.nn.functional as F

    from srgan_st_tpu_torch.kernels import coarse_conv as cc
    from srgan_st_tpu_torch.ops.subpixel_conv import conv_nhwc, space_to_depth

    gated, kept = [], {}
    for shape in SHAPES_A:
        x = torch.rand(shape, generator=gen, device=dev)
        w2 = _coarse_w2(gen, dev, shape[3])
        ref32, got32 = cc.coarse_conv_s2d_reference(x, w2), cc.coarse_conv_s2d(x, w2)
        same32 = torch.equal(got32, cc.coarse_conv_s2d(x, w2))
        xb, wb = x.bfloat16(), w2.bfloat16()
        del x
        ref16 = cc.coarse_conv_s2d_reference(xb, wb)
        plain16 = space_to_depth(conv_nhwc(xb, wb), 2)
        got16 = cc.coarse_conv_s2d(xb, wb)
        same16 = torch.equal(got16, cc.coarse_conv_s2d(xb, wb))
        torch.cuda.synchronize()
        gated.append(envelope_gate("coarse_conv_s2d", shape, got32, ref32, got16, ref16,
                                   plain16, {"f32": same32, "bf16": same16}))
        del ref32, got32, ref16, plain16, got16
        if shape in (SHAPE_A_4K, SHAPE_A_TRAIN):
            kept[shape] = (xb, wb)
    rec = _worst(gated)
    xb, wb = kept[SHAPE_A_4K]
    b, h, w, c = SHAPE_A_4K
    wt = cc._layout(wb, dev, torch.bfloat16)  # laid out once, as KernelWeights does
    w_oihw = wb.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    nbytes = xb.numel() * 2 + b * (h // 2) * (w // 2) * 48 * 4 + wb.numel() * 2
    flops = 2 * b * (2 * h) * (2 * w) * 81 * (c // 4) * 3  # the 9x9 64 -> 3 conv
    own = design_flops("coarse_conv", "coarse_conv_s2d_bf16_mma_flops", b, h, w, c)
    xt, wtt = kept[SHAPE_A_TRAIN]
    wt_train = cc._layout(wtt, dev, torch.bfloat16)
    rec.update(
        shape=list(SHAPE_A_4K),
        ms=cuda_ms(lambda: cc.coarse_conv_s2d(xb, wb, wt)),
        wrapper_ms=cuda_ms(lambda: cc.coarse_conv_s2d(xb, wb)),
        plain_ms=cuda_ms(lambda: cc.coarse_conv_s2d_reference(xb, wb)),
        library_ms=cuda_ms(lambda: F.conv2d(xb.permute(0, 3, 1, 2), w_oihw, padding=2)),
        bytes=nbytes, flops=flops,
        flops_doubly_coarse=2 * b * (h // 2) * (w // 2) * 18 * (2 * c) * 48,
        design_flops=own, floor_ms=own / BF16_FLOPS * 1e3,
        train_shape=list(SHAPE_A_TRAIN),
        train_ms=cuda_ms(lambda: cc.coarse_conv_s2d(xt, wtt, wt_train)),
    )
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops)
    rec["achieved_gb_per_s"] = nbytes / (rec["ms"] / 1e3) / 1e9
    rec["achieved_design_tflop_per_s"] = own / (rec["ms"] / 1e3) / 1e12
    rec["ms_over_library_ms"] = rec["ms"] / rec["library_ms"]
    emit("kernel_time", **rec)
    return rec


def phase_kernel_b(gen, dev) -> dict:
    """Kernel B against its plain version at each of SHAPES_B, with a second
    launch's bits; times at 4K (`ms`: the launch on laid-out weights;
    `wrapper_ms`: serving_tail with its output permutation and b3)."""
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
        same32 = torch.equal(got32, st.serving_tail(y, w_up, b_up, alpha, w3, b3))
        y16 = y.bfloat16()
        del y
        ref16 = st.serving_tail_reference(y16.float(), w_up.bfloat16().float(), b_up,
                                          alpha, w3.bfloat16().float(), b3)
        plain16 = st.serving_tail_reference(y16, w_up, b_up, alpha, w3, b3)
        got16 = st.serving_tail(y16, w_up, b_up, alpha, w3, b3)
        same16 = torch.equal(got16, st.serving_tail(y16, w_up, b_up, alpha, w3, b3))
        torch.cuda.synchronize()
        gated.append(envelope_gate("serving_tail", shape, got32, ref32, got16,
                                   ref16, plain16, {"f32": same32, "bf16": same16}))
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

    tail_weights = st.TailWeights()  # laid out once, as the generator keeps them
    nbytes = yb.numel() * 2 + b * (h // 2) * (w // 2) * 48 * 2
    flops = (2 * b * h * w * 9 * c * 4 * c               # 3x3 64 -> 256 up-conv
             + 2 * b * (2 * h) * (2 * w) * 81 * c * 3)   # 9x9 64 -> 3 conv3
    own = design_flops("serving_tail", "serving_tail_bf16_mma_flops", b, h, w)
    rec.update(
        shape=list(SHAPE_B_4K),
        ms=cuda_ms(lambda: st._launch(yb, w_up, b_up, alpha, w3, tail_weights)),
        wrapper_ms=cuda_ms(lambda: st.serving_tail(yb, w_up, b_up, alpha, w3, b3)),
        plain_ms=cuda_ms(lambda: st.serving_tail_reference(yb, w_up, b_up, alpha, w3, b3)),
        library_ms=cuda_ms(library), bytes=nbytes, flops=flops,
        design_flops=own, floor_ms=own / BF16_FLOPS * 1e3,
    )
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops)
    rec["achieved_tflop_per_s"] = flops / (rec["ms"] / 1e3) / 1e12
    rec["achieved_design_tflop_per_s"] = own / (rec["ms"] / 1e3) / 1e12
    rec["ms_over_library_ms"] = rec["ms"] / rec["library_ms"]
    emit("kernel_time", **rec)
    return rec


def _eval_trunk_operands(gen, dev, n: int):
    """Random eval trunk operands of n blocks at 64 channels (HWIO kernels
    N(0, 1/fan_in), BatchNorms with non-trivial running statistics as
    their f32 affine, slopes in [0.1, 0.3]) and the Generator whose g.trunk
    region they are (its blocks: the cuDNN yardstick)."""
    import torch

    from srgan_st_tpu_torch.models.generator import Generator

    g = Generator(num_rcb=n, dtype=torch.bfloat16, trunk_mode="unfused").to(dev).eval()
    with torch.no_grad():
        for p in g.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device=dev) / (p[0].numel() ** 0.5))
        for m in g.modules():
            if hasattr(m, "running_var"):
                m.weight.uniform_(0.5, 1.0, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
        for blk in g.trunk:
            blk.rcb[2].weight.uniform_(0.1, 0.3, generator=gen)
    return g, g._eval_trunk_operands()


def phase_kernel_e(gen, dev) -> dict:
    """Kernel E (16 blocks and the fusion conv) against its plain version at
    each of SHAPES_E (bf16: within 2x the plain version's own bf16 envelope
    of the plain version in f32 on the same operands; a second call's
    bits), then at 4K its time (`ms`: the call on laid-out operands;
    `wrapper_ms` lays them out), the plain version's, the cuDNN blocks'
    (the g.trunk region of the unfused eval generator), the bound and the
    design's floor. No profile here: a process's later profiles lose
    device events, and the K4/K5 phase counts its kernels in one (the
    card test of a served frame counts kernel E's)."""
    import torch

    from srgan_st_tpu_torch.kernels import eval_trunk as et

    g, (ws, scale, shift, als, laid) = _eval_trunk_operands(gen, dev, E_BLOCKS)
    ws16 = ws.bfloat16().float()
    gated = []
    for shape in SHAPES_E:
        x = (torch.rand(shape, generator=gen, device=dev) - 0.5).bfloat16()
        before = et.launches
        got = et.eval_trunk(x, ws, scale, shift, als, laid)
        same = torch.equal(got, et.eval_trunk(x, ws, scale, shift, als, laid))
        torch.cuda.synchronize()
        plain16 = et.eval_trunk_reference(x, ws, scale, shift, als)
        ref32 = et.eval_trunk_reference(x.float(), ws16, scale, shift, als)
        env, err = max_abs(plain16, ref32), max_abs(got, ref32)
        rec = {"kernel": "eval_trunk", "shape": list(shape), "bf16_max_abs_err": err,
               "bf16_envelope": env, "vs_plain_bf16": max_abs(got, plain16),
               "calls": et.launches - before, "bitwise_repeatable": same}
        emit("kernel", **rec)
        if not (env > 0 and err <= 2 * env and bool(torch.isfinite(got.float()).all())):
            raise AssertionError(f"eval_trunk bf16 at {shape}: {err} > 2 * {env}")
        if not same or rec["calls"] != 2:
            raise AssertionError(f"eval_trunk at {shape}: {rec}")
        gated.append(rec)
        del got, plain16, ref32
    rec = {"kernel": "eval_trunk", "gated_shapes": [r["shape"] for r in gated],
           "bf16_max_abs_err": max(r["bf16_max_abs_err"] for r in gated),
           "vs_plain_bf16": max(r["vs_plain_bf16"] for r in gated)}
    b, h, w, c = SHAPE_E_4K
    x = (torch.rand(SHAPE_E_4K, generator=gen, device=dev) - 0.5).bfloat16()
    m = 2 * E_BLOCKS + 1
    flops = 2.0 * b * h * w * 9 * c * c * m
    nbytes = 2 * (2 * x.numel() + m * 9 * c * c)
    own = design_flops("eval_trunk", "eval_trunk_bf16_mma_flops", E_BLOCKS, b, h, w)

    def blocks():
        y = g._trunk(x, False, "unfused").permute(0, 3, 1, 2)
        return g.conv2[1](g.conv2[0](y), False) + x.permute(0, 3, 1, 2)

    with torch.inference_mode():
        rec.update(
            shape=list(SHAPE_E_4K), n=E_BLOCKS,
            ms=cuda_ms(lambda: et._launch(x, ws, scale, shift, als, laid)),
            wrapper_ms=cuda_ms(lambda: et.eval_trunk(x, ws, scale, shift, als)),
            plain_ms=cuda_ms(lambda: et.eval_trunk_reference(x, ws, scale, shift, als), iters=3),
            library_ms=cuda_ms(blocks), bytes=nbytes, flops=flops,
            design_flops=own, floor_ms=own / BF16_FLOPS * 1e3,
            launch_host_ms=host_ms(lambda: et._launch(x, ws, scale, shift, als, laid)))
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops)
    rec["roofline_share"] = rec["bound_ms"] / rec["ms"]
    rec["achieved_tflop_per_s"] = flops / (rec["ms"] / 1e3) / 1e12
    rec["ms_over_library_ms"] = rec["ms"] / rec["library_ms"]
    emit("kernel_time", **rec)
    return rec


def rrdb_operands(gen, dev, n: int):
    """Random operands of n RRDBs at the published widths (HWIO kernels N(0,
    4 / fan_in), the benchmark cell's gain; biases N(0, 0.05^2)), drawn by
    the torch generator `gen` on `dev`."""
    import torch

    from srgan_st_tpu_torch.kernels.rrdb_dense import conv_channels

    ws, bs = [], []
    for _ in range(3 * n):
        for cin, cout in conv_channels(64, 32):
            ws.append(torch.randn((3, 3, cin, cout), generator=gen, device=dev)
                      * (2.0 / (9 * cin) ** 0.5))
            bs.append(0.05 * torch.randn(cout, generator=gen, device=dev))
    return ws, bs


def hr_operands(gen, dev):
    """Random operands of the RRDB generator's HR stage at the published
    widths, conv_up1, conv_up2, conv_hr, conv_last: HWIO kernels N(0, 2 /
    fan_in) (conv_last's N(0, 1 / fan_in)), biases N(0, 0.05^2) (conv_last's
    0.5, so that the clamped frame is mostly inside (0, 1) and clamped on
    both sides), drawn by the torch generator `gen` on `dev`."""
    import torch

    ws, bs = [], []
    for cout, gain in ((64, 2.0), (64, 2.0), (64, 2.0), (3, 1.0)):
        ws.append(torch.randn((3, 3, 64, cout), generator=gen, device=dev) * (gain / 576) ** 0.5)
        bs.append(0.05 * torch.randn(cout, generator=gen, device=dev))
    bs[3] = bs[3] + 0.5
    return ws, bs


def _rrdb_model(gen, dev):
    """The published RRDB generator (23 RRDBs), bf16 on `dev`, its dense
    convs `rrdb_operands`' draw."""
    import torch

    from srgan_st_tpu_torch.models.rrdb import RRDBNet

    model = RRDBNet(num_block=R_BLOCKS, dtype=torch.bfloat16).to(dev).eval()
    ws, bs = rrdb_operands(gen, dev, R_BLOCKS)
    with torch.no_grad():
        for conv, wk, bk in zip(model._dense_convs, ws, bs):
            conv.weight.copy_(wk.permute(3, 2, 0, 1))
            conv.bias.copy_(bk)
    return model


def phase_kernel_r(gen, dev) -> dict:
    """Kernel R (the RRDBs of Real-ESRGAN's trunk, bf16 only) against its
    plain version at each of SHAPES_R (2 RRDBs; 1 at the video frame):
    within 2x the plain version's own bf16 envelope of the plain version in
    f32 on the same operands, and of the plain version in bf16 (the two
    differ by their f32 sums' order: a rounding flipped here and there,
    carried through 30 convs), and a second call's bits. Then at (1, 540,
    960, 64) the time of one RRDB (`ms`, laid-out operands) and of the
    published trunk's 23
    (`trunk_ms`; `wrapper_ms` lays the operands out), the 23's output held
    to their plain version's by the same envelope rule, their bound (compute:
    2 x 239,616 multiply-adds a pixel a dense block), the design's floor,
    the plain version's time, the cuDNN blocks' (RRDBNet's modules: the
    `torch.cat` copies, cuDNN convs, separate bias, LeakyReLU and residual
    passes) as `library_ms`, and the host's enqueue of one trunk call."""
    import torch

    from srgan_st_tpu_torch.kernels import rrdb_dense as R
    from srgan_st_tpu_torch.models.rrdb import RES_SCALE, SLOPE

    gated = []
    for shape in SHAPES_R:
        n = 1 if shape == SHAPE_R_4K else 2
        ws, bs = rrdb_operands(gen, dev, n)
        x = (torch.rand(shape, generator=gen, device=dev) - 0.5).bfloat16()
        before = R.launches
        got = R.rrdb_dense(x, ws, bs, SLOPE, RES_SCALE)
        same = torch.equal(got, R.rrdb_dense(x, ws, bs, SLOPE, RES_SCALE))
        torch.cuda.synchronize()
        plain16 = R.rrdb_dense_reference(x, ws, bs, SLOPE, RES_SCALE)
        ref32 = R.rrdb_dense_reference(x.float(), [w.bfloat16().float() for w in ws], bs,
                                       SLOPE, RES_SCALE)
        env, err = max_abs(plain16, ref32), max_abs(got, ref32)
        rec = {"kernel": "rrdb_dense", "shape": list(shape), "rrdbs": n,
               "bf16_max_abs_err": err, "bf16_envelope": env,
               "vs_plain_bf16": max_abs(got, plain16), "max_abs_ref": float(ref32.abs().max()),
               "calls": R.launches - before, "bitwise_repeatable": same}
        emit("kernel", **rec)
        if not (env > 0 and err <= 2 * env and rec["vs_plain_bf16"] <= 2 * env
                and bool(torch.isfinite(got.float()).all())):
            raise AssertionError(f"rrdb_dense bf16 at {shape}: {rec}")
        if not same or rec["calls"] != 2:
            raise AssertionError(f"rrdb_dense at {shape}: {rec}")
        gated.append(rec)
        del got, plain16, ref32
    rec = {"kernel": "rrdb_dense", "gated_shapes": [r["shape"] for r in gated],
           "bf16_max_abs_err": max(r["bf16_max_abs_err"] for r in gated),
           "vs_plain_bf16": max(r["vs_plain_bf16"] for r in gated)}
    b, h, w, c = SHAPE_R_4K
    x = (torch.rand(SHAPE_R_4K, generator=gen, device=dev) - 0.5).bfloat16()
    model = _rrdb_model(gen, dev)
    ws, bs, laid = model._dense_weights.get(
        [(cv._parameters["weight"], cv._parameters["bias"]) for cv in model._dense_convs])
    one = ws[:15], bs[:15], R.layout(ws[:15], bs[:15])
    macs = 3 * b * h * w * 239_616  # an RRDB
    conv_bytes = 3 * b * h * w * 1_664  # an RRDB's convs, each prefix read once
    own = design_flops("rrdb_dense", "rrdb_dense_bf16_mma_flops", 1, b, h, w)
    xn = x.permute(0, 3, 1, 2)
    with torch.inference_mode():
        rec.update(
            shape=list(SHAPE_R_4K), n=1, trunk_n=R_BLOCKS,
            ms=cuda_ms(lambda: R.rrdb_dense(x, *one[:2], SLOPE, RES_SCALE, one[2])),
            trunk_ms=cuda_ms(lambda: R.rrdb_dense(x, ws, bs, SLOPE, RES_SCALE, laid), iters=5),
            wrapper_ms=cuda_ms(lambda: R.rrdb_dense(x, ws, bs, SLOPE, RES_SCALE), iters=3),
            plain_ms=cuda_ms(lambda: R.rrdb_dense_reference(x, *one[:2], SLOPE, RES_SCALE),
                             iters=3),
            trunk_plain_ms=cuda_ms(lambda: R.rrdb_dense_reference(x, ws, bs, SLOPE, RES_SCALE),
                                   iters=1, warmup=1),
            library_ms=cuda_ms(lambda: model.body[0](xn)),
            trunk_library_ms=cuda_ms(lambda: model.body(xn), iters=5),
            launch_host_ms=host_ms(lambda: R.rrdb_dense(x, ws, bs, SLOPE, RES_SCALE, laid)),
            flops=2.0 * macs, trunk_flops=2.0 * macs * R_BLOCKS,
            conv_bytes=conv_bytes, design_flops=own, floor_ms=own / BF16_FLOPS * 1e3)
    rec["bound_ms"], rec["bound_by"] = bound_ms(0, rec["flops"])
    rec["trunk_bound_ms"] = rec["bound_ms"] * R_BLOCKS
    rec["conv_bytes_ms"] = conv_bytes / HBM_BYTES_PER_S * 1e3
    rec["roofline_share"] = rec["bound_ms"] / rec["ms"]
    rec["trunk_roofline_share"] = rec["trunk_bound_ms"] / rec["trunk_ms"]
    rec["achieved_tflop_per_s"] = rec["trunk_flops"] / (rec["trunk_ms"] / 1e3) / 1e12
    rec["ms_over_library_ms"] = rec["ms"] / rec["library_ms"]
    rec["trunk_ms_over_library_ms"] = rec["trunk_ms"] / rec["trunk_library_ms"]
    # the timed 23 against their plain version, in bf16 and in f32
    with torch.inference_mode():
        got = R.rrdb_dense(x, ws, bs, SLOPE, RES_SCALE, laid)
        plain16 = R.rrdb_dense_reference(x, ws, bs, SLOPE, RES_SCALE)
        ref32 = R.rrdb_dense_reference(x.float(), [w.bfloat16().float() for w in ws], bs,
                                       SLOPE, RES_SCALE)
    env = max_abs(plain16, ref32)
    rec.update(trunk_bf16_max_abs_err=max_abs(got, ref32), trunk_bf16_envelope=env,
               trunk_vs_plain_bf16=max_abs(got, plain16),
               trunk_max_abs_ref=float(ref32.abs().max()))
    emit("kernel_time", **rec)
    if not (env > 0 and rec["trunk_bf16_max_abs_err"] <= 2 * env
            and rec["trunk_vs_plain_bf16"] <= 2 * env and bool(torch.isfinite(got.float()).all())):
        raise AssertionError(f"rrdb_dense bf16, the 23 RRDBs at {SHAPE_R_4K}: {rec}")
    del got, plain16, ref32
    rec["kernel_h"] = _kernel_h(gen, dev, model)
    return rec


def _torch_hr_stage(model, xn):
    """The RRDB generator's HR stage as its modules compute it (nearest x2
    copies, cuDNN convs each with a bias pass, LeakyReLU passes, the
    clamp): xn the NCHW trunk output -> the NHWC float32 frame."""
    import torch
    import torch.nn.functional as F

    from srgan_st_tpu_torch.models.rrdb import lrelu

    feat = xn
    for conv in (model.conv_up1, model.conv_up2):
        feat = lrelu(conv(F.interpolate(feat, scale_factor=2, mode="nearest")))
    out = model.conv_last(lrelu(model.conv_hr(feat)))
    return torch.clamp(out.float(), 0.0, 1.0).permute(0, 2, 3, 1)


def _kernel_h(gen, dev, model) -> dict:
    """Kernel H (the RRDB generator's HR stage, bf16 only) against its
    plain version at each of SHAPES_H: the upsample call's u2 (read back
    from its planes) and the frame within 2x the plain version's own bf16
    envelope of the plain version in f32, and of the plain version in
    bf16; a second pair of calls' bits. Then at (1, 540, 960, 64) the time
    of both calls on laid-out operands (`ms`; `upsample_ms`, `tail_ms`
    apart; `wrapper_ms` lays the operands out), the bound (benchmark/
    work_rrdb.py `hr_stage`'s count: 1.404 TFLOP as nine-tap convs; 4.94
    GB, each conv's input once before the nearest x2, its output once, the
    frame in float32), the plain version's time, the modules' HR stage on
    the same weights as `library_ms`, and the host's enqueue of both calls.
    `model` is the published RRDB generator; its HR convs take the draw."""
    import torch

    from srgan_st_tpu_torch.kernels import rrdb_hr as H
    from srgan_st_tpu_torch.models.rrdb import SLOPE

    ws, bs = hr_operands(gen, dev)
    laid = H.layout(ws, bs)
    gated = []
    for shape in SHAPES_H:
        x = (torch.rand(shape, generator=gen, device=dev) - 0.5).bfloat16()
        before = H.launches
        up = H.rrdb_hr_upsample(x, ws, bs, SLOPE, laid)
        got = H.rrdb_hr_tail(up, ws, bs, SLOPE, laid)
        same = torch.equal(got, H.rrdb_hr_tail(H.rrdb_hr_upsample(x, ws, bs, SLOPE), ws, bs,
                                               SLOPE))
        torch.cuda.synchronize()
        u16 = H.upsample_reference(x, ws, bs, SLOPE)
        u32 = H.upsample_reference(x.float(), ws, bs, SLOPE)
        plain16 = H.rrdb_hr_reference(x, ws, bs, SLOPE)
        ref32 = H.rrdb_hr_reference(x.float(), ws, bs, SLOPE)
        env, u_env = max_abs(plain16, ref32), max_abs(u16, u32)
        rec = {"kernel": "rrdb_hr", "shape": list(shape),
               "bf16_max_abs_err": max_abs(got, ref32), "bf16_envelope": env,
               "vs_plain_bf16": max_abs(got, plain16),
               "u2_bf16_max_abs_err": max_abs(up.nhwc(), u32), "u2_bf16_envelope": u_env,
               "u2_vs_plain_bf16": max_abs(up.nhwc(), u16),
               "calls": H.launches - before, "bitwise_repeatable": same}
        emit("kernel", **rec)
        if not (env > 0 and u_env > 0 and rec["bf16_max_abs_err"] <= 2 * env
                and rec["vs_plain_bf16"] <= 2 * env and rec["u2_bf16_max_abs_err"] <= 2 * u_env
                and rec["u2_vs_plain_bf16"] <= 2 * u_env and bool(torch.isfinite(got).all())):
            raise AssertionError(f"rrdb_hr bf16 at {shape}: {rec}")
        if not same or rec["calls"] != 4:
            raise AssertionError(f"rrdb_hr at {shape}: {rec}")
        gated.append(rec)
        del up, got, u16, u32, plain16, ref32
    rec = {"kernel": "rrdb_hr", "gated_shapes": [r["shape"] for r in gated],
           "bf16_max_abs_err": max(r["bf16_max_abs_err"] for r in gated),
           "vs_plain_bf16": max(r["vs_plain_bf16"] for r in gated)}
    with torch.no_grad():
        for conv, wk, bk in zip(model._hr_convs, ws, bs):
            conv.weight.copy_(wk.permute(3, 2, 0, 1))
            conv.bias.copy_(bk)
    b, h, w, c = SHAPE_R_4K
    hw = b * h * w
    macs = 9 * c * (c * 4 * hw + 2 * c * 16 * hw + 3 * 16 * hw)
    nbytes = 2 * (c * hw * (5 + 20 + 32 + 16) + 9 * c * (3 * c + 3)) + 4 * 16 * hw * 3
    x = (torch.rand(SHAPE_R_4K, generator=gen, device=dev) - 0.5).bfloat16()
    up = H.rrdb_hr_upsample(x, ws, bs, SLOPE, laid)
    xn = x.permute(0, 3, 1, 2)

    def both(lay=laid):
        return H.rrdb_hr_tail(H.rrdb_hr_upsample(x, ws, bs, SLOPE, lay), ws, bs, SLOPE, lay)
    with torch.inference_mode():
        rec.update(
            shape=list(SHAPE_R_4K), ms=cuda_ms(both),
            upsample_ms=cuda_ms(lambda: H.rrdb_hr_upsample(x, ws, bs, SLOPE, laid)),
            tail_ms=cuda_ms(lambda: H.rrdb_hr_tail(up, ws, bs, SLOPE, laid)),
            wrapper_ms=cuda_ms(lambda: both(None)),
            plain_ms=cuda_ms(lambda: H.rrdb_hr_reference(x, ws, bs, SLOPE), iters=3),
            library_ms=cuda_ms(lambda: _torch_hr_stage(model, xn)),
            launch_host_ms=host_ms(both), flops=2.0 * macs, bytes=nbytes)
        lib = _torch_hr_stage(model, xn)
        rec["vs_library"] = max_abs(both(), lib)
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, rec["flops"])
    rec["roofline_share"] = rec["bound_ms"] / rec["ms"]
    rec["ms_over_library_ms"] = rec["ms"] / rec["library_ms"]
    emit("kernel_time", **rec)
    return rec


def phase_serve_rrdb(gen, dev) -> dict:
    """The RRDB generator's serving entry, as the video cell reaches kernel
    R and H: `make_generator_apply` under MODEL.G_ARCH "rrdb" (bf16, the
    published widths and depth, `_rrdb_model`'s weights), one 540p frame
    warmed, then the launch counts reset just before one frame and read
    just after: kernel R once, as often as the trunk, kernel H twice (one
    call in `g.upsample`, one in `g.tail`), and no other kernel of the port.
    Beside it the bare model's frame: the same counts and, the same kernels
    on the same weights, the same frame."""
    import torch

    from srgan_st_tpu_torch import kernels
    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.eval.validate import make_generator_apply

    model = _rrdb_model(gen, dev)
    cfg = Config()
    cfg.MODEL.G_ARCH = "rrdb"
    cfg.MODEL.G_N_CHANNEL, cfg.MODEL.G_N_RCB, cfg.MODEL.G_N_GROW = 64, R_BLOCKS, 32
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    fn = make_generator_apply(cfg, model.state_dict(), dev)
    lr = torch.rand(1, *LR_4K, 3, generator=gen, device=dev)
    fn(lr)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    sr = fn(lr)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    before = kernels.launch_counts()
    with torch.inference_mode():
        bare = model(lr)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    rec = {"frame": list(LR_4K), "launches": counts,
           "bare_model_launches": {k: after[k] - before[k] for k in after
                                   if after[k] != before[k]},
           "served_vs_bare_max_abs": max_abs(sr, bare), "out_shape": list(sr.shape)}
    emit("serve", mode="rrdb", **rec)
    want = {**{k: 0 for k in counts}, "rrdb_dense": 1, "rrdb_hr": 2, "rrdb_trunk": 1}
    if counts != want or rec["bare_model_launches"] != {"rrdb_dense": 1, "rrdb_hr": 2,
                                                        "rrdb_trunk": 1}:
        raise AssertionError(f"rrdb frame launches: served {counts}, bare model "
                             f"{rec['bare_model_launches']}")
    if sr.shape != (1, 4 * LR_4K[0], 4 * LR_4K[1], 3) or not bool(torch.isfinite(sr).all()):
        raise AssertionError(f"rrdb served frame: bad output {tuple(sr.shape)}")
    return rec


def phase_kernel_w(dev) -> dict:
    """Kernel W (SwinIR's window attention core, bf16 only) at the SwinIR
    cell's core, (8160, 64, 540) (a 540p frame padded to 544 rows), heads
    of 30, qkv N(0, 1.5^2) and a bias table N(0, 2^2): an unshifted
    block's core and a shifted one's (its last 187 windows masked by the
    labels of SwinIR's plan), each within 2x its plain version's own
    distance from float64 and within 2^-7 max |v| (p and the output each
    rounded once to bf16), with a second call's bits. Then the shifted
    core's time (`ms`) beside its bound (benchmark/work_swinir.py
    `attn_core`: q, k, v read once, the output written once, the additive
    tensors' share; 0.754 GB, 0.225 ms), the plain version's time, and as
    `library_ms` the core the port ran before kernel W: heads zero-padded
    to 32, torch's scaled_dot_product_attention on its memory-efficient
    backend twice (the bias broadcast over the windows the mask misses,
    bias plus mask over the 187, both bf16) and the output transposed into
    place; CUDA events, median of 10."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from benchmark import harness, work_swinir
    from srgan_st_tpu_torch.kernels import swin_attn as W
    from srgan_st_tpu_torch.models import swinir as S

    gen = torch.Generator(device=dev)  # its own: the later phases' draws stay as they were
    gen.manual_seed(23)
    hp, wp, heads, hd = 544, 960, 6, 30
    nw, scale = hp * wp // 64, hd ** -0.5
    lab = S.shift_labels(hp, wp, 8, 4, dev)
    labels = lab[(lab != lab[:, :1]).any(1)]
    split = nw - labels.shape[0]
    qkv = (torch.randn(nw, 64, 3 * heads * hd, generator=gen, device=dev) * 1.5).bfloat16()
    table = torch.randn(225, heads, generator=gen, device=dev) * 2
    index = S.relative_position_index(8).to(dev)
    rec = {"kernel": "swin_attn", "shape": list(qkv.shape), "edge_windows": labels.shape[0]}
    for name, lb in (("unshifted", None), ("shifted", labels)):
        before = W.launches
        got = W.swin_attn(qkv, table, index, heads, scale, lb)
        same = torch.equal(got, W.swin_attn(qkv, table, index, heads, scale, lb))
        torch.cuda.synchronize()
        q, k, v = qkv.view(nw, 64, 3, heads, hd).permute(2, 0, 3, 1, 4).double()
        s = q @ k.transpose(-2, -1) * scale + W.table_bias(table, index).double()
        if lb is not None:
            s[split:] += W.label_mask(lb).double().unsqueeze(1)
        want = (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(nw, 64, heads * hd)
        del s
        plain = W.swin_attn_reference(qkv, table, index, heads, scale, lb)
        err, env = max_abs(got.double(), want), max_abs(plain.double(), want)
        vmax = float(v.abs().max())
        rec[name] = {"bf16_max_abs_err": err, "plain_vs_f64": env, "max_abs_v": vmax,
                     "calls": W.launches - before, "bitwise_repeatable": same}
        del want, plain, q, k, v
        if not (0 < env and err <= 2 * env and err <= 2.0 ** -7 * vmax and same
                and rec[name]["calls"] == 2):
            raise AssertionError(f"swin_attn {name} at {tuple(qkv.shape)}: {rec[name]}")
    bias = W.table_bias(table, index).unsqueeze(0)
    bias16 = bias.bfloat16().contiguous()
    edge16 = (bias + W.label_mask(labels).unsqueeze(1)).bfloat16().contiguous()

    def library():
        q, k, v = F.pad(qkv.view(nw, 64, 3, heads, hd), (0, -hd % 8)).permute(2, 0, 3, 1, 4)
        out = qkv.new_empty(nw, 64, heads, hd)
        with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
            for a, b, m in ((0, split, bias16), (split, nw, edge16)):
                o = F.scaled_dot_product_attention(q[a:b], k[a:b], v[a:b], attn_mask=m,
                                                   scale=scale)
                out[a:b] = o[..., :hd].transpose(1, 2)
        return out.view(nw, 64, heads * hd)
    cfg = harness.load_json("configs", "swinir_m_realsr_x4.json")
    flops, nbytes = work_swinir.attn_core(*LR_4K, cfg)
    with torch.inference_mode():
        rec.update(ms=cuda_ms(lambda: W.swin_attn(qkv, table, index, heads, scale, labels)),
                   unshifted_ms=cuda_ms(lambda: W.swin_attn(qkv, table, index, heads, scale)),
                   plain_ms=cuda_ms(lambda: W.swin_attn_reference(qkv, table, index, heads,
                                                                  scale, labels), iters=3),
                   library_ms=cuda_ms(library), flops=flops, bytes=nbytes)
        rec["vs_library"] = max_abs(W.swin_attn(qkv, table, index, heads, scale, labels),
                                    library())
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops)
    rec["roofline_share"] = rec["bound_ms"] / rec["ms"]
    rec["achieved_tb_per_s"] = nbytes / rec["ms"] / 1e9
    rec["ms_over_library_ms"] = rec["ms"] / rec["library_ms"]
    emit("kernel_time", **rec)
    return rec


def phase_serve_swinir(dev) -> dict:
    """SwinIR's serving entry, as the SwinIR video cell reaches it:
    `make_generator_apply` under MODEL.G_ARCH "swinir" (bf16, the published
    widths, the cell's seeded weights: benchmark/seeded_swinir.py), one 540p
    frame warmed, then the launch counts reset just before one frame and
    read just after, with torch's scaled_dot_product_attention made to
    raise: one trunk, 36 attention cores, each kernel W, kernel H twice and
    no other kernel of the port. The same frame again gives the same bits.
    Then kernel H on the map that frame gives it, (1, 544, 960, 64) (the
    frame padded to the window), with the model's own operands (conv_last's
    bias plus the mean, `_hr_weights`): its u2 and frame within 2x the
    plain version's own bf16 envelope of the plain version in f32
    (`_kernel_h`'s rule), and its frame cropped equal to the served one."""
    import torch
    import torch.nn.functional as F

    from benchmark import harness, seeded_swinir
    from benchmark.drivers.serve_swinir import program_config
    from srgan_st_tpu_torch import kernels
    from srgan_st_tpu_torch.eval.validate import make_generator_apply
    from srgan_st_tpu_torch.kernels import rrdb_hr as H
    from srgan_st_tpu_torch.models.rrdb import SLOPE

    gen = torch.Generator(device=dev)  # its own: the later phases' draws stay as they were
    gen.manual_seed(22)
    cfg = harness.load_json("configs", "swinir_m_realsr_x4.json")
    fn = make_generator_apply(program_config(cfg), seeded_swinir.state(cfg, gen, dev), dev)
    model = fn.model
    lr = torch.rand(1, *LR_4K, 3, generator=gen, device=dev)
    fn(lr)
    torch.cuda.synchronize()
    seen = []
    upsample, sdpa = H.rrdb_hr_upsample, F.scaled_dot_product_attention

    def keep(x, *args):
        seen.append(x)
        return upsample(x, *args)

    def refused(*args, **kwargs):
        raise AssertionError("the port called scaled_dot_product_attention")
    H.rrdb_hr_upsample, F.scaled_dot_product_attention = keep, refused
    try:
        kernels.reset_launch_counts()
        sr = fn(lr)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
    finally:
        H.rrdb_hr_upsample, F.scaled_dot_product_attention = upsample, sdpa
    rec = {"frame": list(LR_4K), "launches": counts, "out_shape": list(sr.shape),
           "again_same_bits": torch.equal(fn(lr), sr)}
    # kernel H at the map the frame gave it, with the model's operands
    x = seen[0]
    hp = -(-LR_4K[0] // model.window) * model.window
    ws, bs, laid = model._hr_weights.get(
        [(cv._parameters["weight"], cv._parameters["bias"]) for cv in model._hr_convs])
    with torch.inference_mode():
        up = H.rrdb_hr_upsample(x, ws, bs, SLOPE, laid)
        got = H.rrdb_hr_tail(up, ws, bs, SLOPE, laid)
        torch.cuda.synchronize()
        u16 = H.upsample_reference(x, ws, bs, SLOPE)
        u32 = H.upsample_reference(x.float(), ws, bs, SLOPE)
        plain16 = H.rrdb_hr_reference(x, ws, bs, SLOPE)
        ref32 = H.rrdb_hr_reference(x.float(), ws, bs, SLOPE)
    env, u_env = max_abs(plain16, ref32), max_abs(u16, u32)
    rec["kernel_h"] = {
        "shape": list(x.shape), "offset": list(model._hr_weights.offset),
        "bf16_max_abs_err": max_abs(got, ref32), "bf16_envelope": env,
        "vs_plain_bf16": max_abs(got, plain16),
        "u2_bf16_max_abs_err": max_abs(up.nhwc(), u32), "u2_bf16_envelope": u_env,
        "u2_vs_plain_bf16": max_abs(up.nhwc(), u16),
        "clamped_share": float(((ref32 <= 0) | (ref32 >= 1)).float().mean()),
        "served_same_bits": torch.equal(got[:, :sr.shape[1], :sr.shape[2]], sr)}
    emit("serve", mode="swinir", **rec)
    kh = rec["kernel_h"]
    want = {**{k: 0 for k in counts}, "swin_trunk": 1, "window_attn": 36, "swin_attn": 36,
            "rrdb_hr": 2}
    if counts != want:
        raise AssertionError(f"swinir frame launches: {counts}")
    if sr.shape != (1, 4 * LR_4K[0], 4 * LR_4K[1], 3) or not bool(torch.isfinite(sr).all()):
        raise AssertionError(f"swinir served frame: bad output {tuple(sr.shape)}")
    if not rec["again_same_bits"]:
        raise AssertionError(f"swinir served frame: a second call changed bits {rec}")
    if tuple(x.shape) != (1, hp, LR_4K[1], 64) or not (
            env > 0 and u_env > 0 and kh["bf16_max_abs_err"] <= 2 * env
            and kh["vs_plain_bf16"] <= 2 * env and kh["u2_bf16_max_abs_err"] <= 2 * u_env
            and kh["u2_vs_plain_bf16"] <= 2 * u_env and kh["served_same_bits"]
            and bool(torch.isfinite(got).all())):
        raise AssertionError(f"rrdb_hr on the swinir frame's map: {kh}")
    return rec


def _serve_fns(gpath, dev):
    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.eval.ensemble import self_ensemble
    from srgan_st_tpu_torch.eval.infer import make_infer_fn

    fns = {}
    for mode, dtype, tail, tiled, trunk in (("composed", "bfloat16", None, False, None),
                                            ("fused", "bfloat16", "fused", False, None),
                                            ("tiled", "bfloat16", None, True, None),
                                            ("xpack", "bfloat16", None, False, "xpack"),
                                            ("unfused", "bfloat16", None, False, "unfused"),
                                            ("f32", "float32", None, False, None)):
        cfg = Config()
        cfg.TPU.COMPUTE_DTYPE, cfg.TPU.TAIL_MODE, cfg.TPU.TILED_EVAL = dtype, tail, tiled
        cfg.TPU.TRUNK_MODE = trunk
        fns[mode] = make_infer_fn(cfg, gpath=gpath, device=dev)
    fns["ensemble"] = self_ensemble(fns["composed"])
    return fns


def phase_serve(fns, frames) -> tuple[dict, dict]:
    """The main path: requests through upscale_image, launch counts reset
    just before and read just after."""
    import torch

    from srgan_st_tpu_torch.eval.infer import upscale_image
    from srgan_st_tpu_torch.kernels import launch_counts, reset_launch_counts

    requests = [("composed", "960x540"), ("fused", "960x540"),
                ("composed", "541x383"), ("fused", "541x383"),
                ("tiled", "960x540"), ("xpack", "960x540"), ("ensemble", "61x47")]
    need = {"composed": "coarse_conv_s2d", "tiled": "coarse_conv_s2d",
            "fused": "serving_tail", "xpack": "coarse_conv_s2d",
            "ensemble": "coarse_conv_s2d"}
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
        if mode == "ensemble" and delta != {**{k: 0 for k in delta}, need[mode]: 8,
                                             "eval_trunk": 8}:
            raise AssertionError(f"the x8 ensemble launched {delta}, not kernels A and E "
                                 "8 times each")
        if mode != "xpack" and delta["eval_trunk"] < 1:
            raise AssertionError(f"{mode} {frame} did not launch eval_trunk")
        outs[(mode, frame)] = sr
    counts = launch_counts()
    emit("serve", launches_total=counts)
    if min(counts["coarse_conv_s2d"], counts["serving_tail"], counts["eval_trunk"]) < 1:
        raise AssertionError(f"a kernel of the path never launched: {counts}")
    torch.cuda.synchronize()
    return outs, counts


def phase_check(fns, frames, outs, rng) -> dict:
    """Outputs against each other within the network's bf16 envelope (the
    bf16 composed output against the f32 network on the same frame), and
    the CUDA f32 network against its CPU run on a small frame."""
    import torch

    from srgan_st_tpu_torch.eval.ensemble import self_ensemble
    from srgan_st_tpu_torch.eval.infer import upscale_image

    rec = {}
    for frame in ("960x540", "541x383"):
        lr = frames[frame]
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
            # the BN-folded trunk's and kernel E's bf16 outputs against the
            # f32 network, within 2x the bf16 blocks' envelope
            blocks = float(np.abs(upscale_image(fns["unfused"], lr, 4) - f32).max())
            d_xpack = float(np.abs(outs[("xpack", frame)] - f32).max())
            rec[frame].update(xpack_vs_f32=d_xpack, blocks_envelope=blocks)
            if not (d_xpack <= 2 * blocks and env <= 2 * blocks):
                raise AssertionError(f"xpack vs f32 {d_xpack}, kernel E's {env}: over "
                                     f"2 * {blocks}")
        rec[frame]["unclamped_share"] = float(((f32 > 0) & (f32 < 1)).mean())

    # the x8 ensemble of the bf16 network against that of the f32 one, in
    # the bf16 envelope of one forward on the same frame
    lr = frames["61x47"]
    env = float(np.abs(upscale_image(fns["composed"], lr, 4)
                       - upscale_image(fns["f32"], lr, 4)).max())
    d_ens = float(np.abs(outs[("ensemble", "61x47")]
                         - upscale_image(self_ensemble(fns["f32"]), lr, 4)).max())
    rec["61x47"] = {"bf16_envelope": env, "ensemble_vs_f32_ensemble": d_ens}
    if not (env > 0 and d_ens <= 2 * env):
        raise AssertionError(f"x8 ensemble vs its f32 ensemble {d_ens} > 2 * {env}")

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
    """ms per 4K frame (device input, device output) in both tail modes and
    with the BN-folded trunk (TRUNK_MODE="xpack", composed tail)."""
    import torch

    from srgan_st_tpu_torch.kernels import launch_counts, reset_launch_counts

    x = torch.from_numpy(rng.random((1, *LR_4K, 3), np.float32)).to(dev)
    mp = 4 * LR_4K[0] * 4 * LR_4K[1] / 1e6
    rec = {}
    for mode in ("composed", "fused", "xpack"):
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


VIZ_BUDDY = 765  # the notebook's 15 * 51 crop: 2,601 targets, a 3,370-patch bank
VIZ_TARGETS = 5  # buddy targets ranked on the card and on the CPU
VIZ_K = 6


def _viz_crops(dev, work: str) -> dict:
    """The comparison figure (viz/save_image_patch.py comparison_crops) of
    the seeded frame: gt, bicubic, nearest and two experiments, whose
    g_best.npz are the full-width generator's seeded weights; bf16 with the
    composed and with the fused tail, launch counts reset before and read
    after each figure. Each experiment crop equals the same crop of a
    direct make_generator_apply call, and that call's whole frame lies
    within 2x the bf16 envelope: the plain bf16 network (plain versions,
    no kernel) against the plain f32 network on the same frame."""
    import torch

    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.eval.export import plain_eval_generator
    from srgan_st_tpu_torch.eval.validate import make_generator_apply
    from srgan_st_tpu_torch.kernels import launch_counts, reset_launch_counts
    from srgan_st_tpu_torch.models.generator import random_variables
    from srgan_st_tpu_torch.ops.resize import resize_bicubic
    from srgan_st_tpu_torch.train.checkpoint import load_params_npz, save_variables_npz
    from srgan_st_tpu_torch.viz.save_image_patch import comparison_crops, write_rgb_png

    exps = ["smoke-viz-a", "smoke-viz-b"]
    root = os.path.join(work, "results")
    for seed, name in enumerate(exps):
        save_variables_npz(os.path.join(root, name, "g_best.npz"), random_variables(seed))
    rng = np.random.default_rng(11)
    gt = rng.integers(0, 256, (4 * VIZ_LR[0], 4 * VIZ_LR[1], 3), np.uint8)
    lr = resize_bicubic(torch.from_numpy(gt[None].astype(np.float32) / 255), 0.25)[0].numpy()
    y, x, size = VIZ_LR[0], 2 * VIZ_LR[1], 96  # HR pixels; inside the frame
    names = ["gt", "bicubic", "nearest", *exps]

    def sr_of(cfg, name):
        fn = make_generator_apply(cfg, load_params_npz(os.path.join(root, name, "g_best.npz")),
                                  device=dev)
        return fn(lr[None])[0].float().cpu().numpy()

    def plain_sr(dtype, name):
        cfg = Config()
        cfg.TPU.COMPUTE_DTYPE = dtype
        net = plain_eval_generator(cfg, load_params_npz(os.path.join(root, name, "g_best.npz")),
                                   True, dev)
        with torch.inference_mode():
            return net(torch.from_numpy(lr[None]).to(dev))[0].float().cpu().numpy()

    reset_launch_counts()
    refs = {name: plain_sr("float32", name) for name in exps}
    envs = {name: float(np.abs(plain_sr("bfloat16", name) - refs[name]).max()) for name in exps}
    plain_launches = launch_counts()
    rec, bad, files = {"figures": {}, "bf16_envelope": envs}, [], []
    if any(plain_launches.values()):
        bad.append(f"the plain networks launched a kernel: {plain_launches}")
    for tail in ("composed", "fused"):
        cfg = Config()
        cfg.TPU.COMPUTE_DTYPE = "bfloat16"
        cfg.TPU.TAIL_MODE = "fused" if tail == "fused" else None
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        boxed, crops = comparison_crops(cfg, names, gt, lr, y, x, size, root, dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        fig = {"seconds": seconds, "launches": launches, "experiments": {}}
        kernel = "serving_tail" if tail == "fused" else "coarse_conv_s2d"
        if launches[kernel] != len(exps):
            bad.append(f"{tail}: {kernel} launched {launches[kernel]} times, not once "
                       f"per experiment ({len(exps)})")
        for name in exps:
            direct = sr_of(cfg, name)
            want = np.clip(np.round(direct * 255), 0, 255).astype(np.uint8)[y:y + size,
                                                                            x:x + size]
            diff = np.abs(direct - refs[name])
            e = {"equals_direct_call": bool(np.array_equal(crops[name], want)),
                 "frame_vs_f32": float(diff.max()),
                 "crop_vs_f32": float(diff[y:y + size, x:x + size].max())}
            fig["experiments"][name] = e
            if not (e["equals_direct_call"] and envs[name] > 0
                    and e["frame_vs_f32"] <= 2 * envs[name]):
                bad.append(f"{tail} {name}: {e}, envelope {envs[name]}")
        if not (np.array_equal(crops["gt"], gt[y:y + size, x:x + size])
                and all(c.shape == (size, size, 3) for c in crops.values())
                and (boxed[y:y + size, x:x + 3] == (255, 0, 0)).all()):
            bad.append(f"{tail}: the gt crop, a crop's shape or the box")
        for name, img in (("gt_box", boxed), *crops.items()):
            files.append(os.path.join(work, f"crops_{tail}_{name}.png"))
            write_rgb_png(files[-1], img)
        rec["figures"][tail] = fig
    rec["launches"] = {k: sum(f["launches"][k] for f in rec["figures"].values())
                       for k in rec["figures"]["composed"]["launches"]}
    return {"rec": rec, "bad": bad, "files": files}


def _viz_features(dev, work: str) -> dict:
    """viz/feature_maps.py on the card (f32, TF32 off) against the same
    models on the CPU: vgg (the seeded random VGG19 npz, a 512x512 image)
    and disc (96x96 and 512x512): each tap within 1e-4 of max|act|, each
    grid within one uint8 level."""
    import torch

    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.viz.feature_maps import activation_grids, feature_maps
    from srgan_st_tpu_torch.viz.save_image_patch import write_rgb_png

    cfg = Config()
    cfg.MODEL.G_LOSS.VGG19_WEIGHTS = write_vgg_npz(os.path.join(work, "vgg19.npz"))
    rng = np.random.default_rng(12)
    rec, bad, files = {}, [], []
    for extractor, size in (("vgg", 512), ("disc", 96), ("disc", 512)):
        img = rng.random((size, size, 3), np.float32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = feature_maps(cfg, img, extractor, device=dev)
        grids = activation_grids(got)
        seconds = time.perf_counter() - t0
        want = feature_maps(cfg, img, extractor, device="cpu")
        want_grids = activation_grids(want)
        taps = {}
        for tap, w in want.items():
            scale = float(w.abs().max())
            err = float((got[tap].cpu() - w).abs().max())
            level = int(np.abs(grids[tap].astype(int) - want_grids[tap].astype(int)).max())
            taps[tap] = {"shape": list(w.shape), "max_abs_err": err, "max_abs": scale,
                         "grid_levels": level}
            if not (err <= 1e-4 * scale and level <= 1 and got[tap].is_cuda):
                bad.append(f"{extractor} {size} {tap}: {taps[tap]}")
            files.append(os.path.join(work, f"fm_{extractor}{size}_{tap.replace('.', '_')}.png"))
            write_rgb_png(files[-1], grids[tap])
        rec[f"{extractor}_{size}"] = {"seconds": seconds, "taps": taps}
    return {"rec": rec, "bad": bad, "files": files}


def _viz_buddies(dev, work: str) -> dict:
    """viz/buddy_illustration.py's cores on a seeded 765x765 image: the
    bank and the scores on the card and on the CPU, VIZ_TARGETS targets
    ranked (k = VIZ_K) on the host from each; gate: the bank indices equal
    the CPU's, or at each rank where they differ the f64 score of the
    card's index lies within 1e-6 relative of the f64 score of the CPU's
    (the near-tie rule of kernels/_checks.py); then one illustration's
    images."""
    import torch

    from srgan_st_tpu_torch.viz.buddy_illustration import (
        buddy_bank, buddy_scores, illustrate, rank_buddies,
    )
    from srgan_st_tpu_torch.viz.save_image_patch import write_rgb_png

    img = np.random.default_rng(13).random((VIZ_BUDDY, VIZ_BUDDY, 3), np.float32)
    img = np.round(img * 255) / 255  # a decoded 8-bit image
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bank = buddy_bank(img, 15, dev)
    score = buddy_scores(bank)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    cpu_bank = buddy_bank(img, 15, "cpu")
    cpu_score = buddy_scores(cpu_bank)
    n, m = cpu_score.shape
    p64 = cpu_bank["patches"][0].double().numpy()
    b64 = cpu_bank["bank"][0].double().numpy()
    targets = np.random.default_rng(14).choice(n, VIZ_TARGETS, replace=False)
    rec = {"patches": n, "bank": m, "d": int(p64.shape[1]),
           "parts": [list(p) for p in bank["parts"]], "score_seconds": score_s, "targets": {}}
    bad = []
    for t in targets.tolist():
        got, _ = rank_buddies(score[t].cpu().numpy(), t, VIZ_K)
        want, _ = rank_buddies(cpu_score[t].numpy(), t, VIZ_K)
        f64 = 2.0 * ((b64 - p64[t]) ** 2).sum(1)
        ties = [(r, int(g), int(w)) for r, (g, w) in enumerate(zip(got, want)) if g != w]
        ok = all(abs(f64[g] - f64[w]) <= 1e-6 * abs(f64[w]) for _, g, w in ties)
        rec["targets"][str(t)] = {"card": got.tolist(), "cpu": want.tolist(),
                                  "near_ties": ties}
        if not ok:
            bad.append(f"target {t}: {rec['targets'][str(t)]}")
    t0 = time.perf_counter()
    meta = illustrate(img, int(targets[0]), VIZ_K, device=dev)
    rec["illustration_seconds"] = time.perf_counter() - t0
    files = []
    for suffix, image in meta["images"].items():
        files.append(os.path.join(work, f"buddy_{suffix}.png"))
        write_rgb_png(files[-1], image)
    if [b["bank_index"] for b in meta["buddies"]] != rec["targets"][str(targets[0])]["card"]:
        bad.append("the illustration's buddies are not the ranked ones")
    return {"rec": rec, "bad": bad, "files": files}


def phase_viz(dev) -> dict:
    """The figure tools (viz/) at full width on the card: the comparison
    crops of two experiments through the serving path (kernels A and B),
    the content losses' feature maps, the best-buddy ranking; every figure's
    PNGs written with zlib alone to a temporary directory."""
    rec, bad, files = {}, [], []
    with tempfile.TemporaryDirectory() as work:
        for part, fn in (("crops", _viz_crops), ("feature_maps", _viz_features),
                         ("buddies", _viz_buddies)):
            t0 = time.perf_counter()
            r = fn(dev, work)
            rec[part] = {**r["rec"], "part_seconds": time.perf_counter() - t0}
            bad += r["bad"]
            files += r["files"]
        rec["pngs"] = {"count": len(files), "bytes": sum(os.path.getsize(f) for f in files)}
    emit("viz", **rec)
    if bad:
        raise AssertionError(f"viz phase: {bad}")
    return rec["crops"]


def phase_baseline(dev) -> dict:
    """The bicubic baseline through test() on the synthetic pairs (the
    substitution of EXP.NAME "bicubic"), on the card and on the CPU: the
    same PSNR and SSIM."""
    import contextlib
    import io

    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.eval.validate import test

    rec = {}
    with tempfile.TemporaryDirectory() as tmp:
        for device in (dev, "cpu"):
            cfg = Config()
            cfg.EXP.NAME, cfg.DATA.SYNTHETIC = "bicubic", True
            cfg.DATA.TEST_SR_IMAGES_DIR = tmp
            with contextlib.redirect_stdout(io.StringIO()):
                rec[str(device)] = test(cfg, save_images=False, device=device)
    (p_gpu, s_gpu), (p_cpu, s_cpu) = rec[str(dev)], rec["cpu"]
    emit("baseline", exp_name="bicubic", pairs="synthetic", psnr_ssim=rec)
    if not (np.isfinite(p_gpu) and abs(p_gpu - p_cpu) <= 1e-2 and abs(s_gpu - s_cpu) <= 1e-4):
        raise AssertionError(f"bicubic baseline on the card vs the CPU: {rec}")
    return rec


def phase_artifact(rng, dev) -> dict:
    """Full-width bf16 artifacts, fixed at the 4K frame and dynamic, exported
    (export_generator checks the program against the live module), saved,
    loaded on the card, and held bit for bit to the live plain path with
    cuDNN on deterministic algorithms, no hand-written kernel launched by
    either; then ms per 4K frame of the fixed one and of the live plain
    path."""
    import torch

    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.eval import export as ex
    from srgan_st_tpu_torch.kernels import launch_counts
    from srgan_st_tpu_torch.models.generator import random_variables

    cfg = Config()
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    variables = random_variables(0)
    rec = {}
    with tempfile.TemporaryDirectory() as tmp:
        for kind, fixed, sizes in (("fixed", (1, *LR_4K), [(1, *LR_4K)]),
                                   ("dynamic", None, [(1, 67, 101), (2, 64, 96)])):
            t0 = time.perf_counter()
            blob, meta = ex.export_generator(cfg, variables, fixed_shape=fixed, device=dev)
            path = os.path.join(tmp, f"{kind}.srganx")
            ex.save_artifact(path, blob, meta)
            run = ex.load_runner(path, device=dev)
            seconds = time.perf_counter() - t0
            live = ex.plain_eval_generator(cfg, variables, fixed is None, dev)
            equal = {}
            before = launch_counts()
            for b, h, w in sizes:
                x = torch.from_numpy(rng.random((b, h, w, 3), np.float32)).to(dev)
                with torch.inference_mode(), ex.deterministic_cudnn():
                    got, want = run(x), live(x)
                equal[f"{b}x{h}x{w}"] = bool(got.shape == (b, 4 * h, 4 * w, 3)
                                             and torch.equal(got, want))
            launched = {k: v - before[k] for k, v in launch_counts().items() if v != before[k]}
            rec[kind] = {"seconds": seconds, "bytes": os.path.getsize(path), "meta": meta,
                         "bit_exact": equal, "kernel_launches": launched}
            if kind == "fixed":
                with torch.inference_mode():
                    rec[kind]["ms_per_frame"] = cuda_ms(lambda: run(x))
                    rec[kind]["live_plain_ms_per_frame"] = cuda_ms(lambda: live(x))
            del run, live
    emit("artifact", **rec)
    if not all(all(r["bit_exact"].values()) and not r["kernel_launches"] for r in rec.values()):
        raise AssertionError(f"an artifact differs from the live plain path, or a "
                             f"hand-written kernel ran: {rec}")
    return rec


def phase_profile(fns, rng, dev) -> dict:
    """Device time by kernel over one 4K frame in each tail mode and with
    the BN-folded trunk."""
    import torch

    x = torch.from_numpy(rng.random((1, *LR_4K, 3), np.float32)).to(dev)
    rec = {mode: profile_once(lambda: fns[mode](x)) for mode in ("composed", "fused", "xpack")}
    emit("profile", frame="960x540 -> 3840x2160", **rec)
    return rec


# ---------------------------------------------------------------------------
# the training slice

def _rel(got, ref) -> float:
    return max_abs(got, ref) / max(float(ref.float().abs().max()), 1e-30)


def _trunk_inputs(gen, dev, shape, n):
    """x, the stacked block parameters (as the Generator passes them) and a
    cotangent dy, all f32."""
    import torch

    c = shape[-1]

    def r(*s):
        return torch.randn(*s, generator=gen, device=dev)

    params = [r(n, 3, 3, c, c) * 0.05, r(n, 3, 3, c, c) * 0.05, 1 + 0.1 * r(n, c),
              0.1 * r(n, c), 1 + 0.1 * r(n, c), 0.1 * r(n, c), 0.25 + 0.01 * r(n)]
    return r(*shape), params, r(*shape)


def _bwd_params(p):
    """(w1s, w2s, g1s, b1s, g2s, als): what the backward reads."""
    return (p[0], p[1], p[2], p[3], p[4], p[6])


GRAD_NAMES = ("dx", "dw1", "dw2", "dg1", "db1", "dg2", "db2", "dal")


def _hybrid_grads(x, p, dy):
    """The 8 gradients of TRUNK_MODE "hybrid" (the plain forward, then K5 on
    its residuals) through `hybrid_trunk`, the entry the Generator calls."""
    from srgan_st_tpu_torch.kernels import packed_trunk as pt

    xg = x.detach().clone().requires_grad_()
    pg = [t.detach().clone().requires_grad_() for t in p]
    y, _ = pt.hybrid_trunk(xg, *pg, EPS)
    y.backward(dy)
    return [xg.grad] + [t.grad for t in pg]


def phase_kernel_trunk(gen, dev) -> tuple[dict, dict]:
    """K4 and K5 against their plain versions at TRUNK_SHAPES. f32 (TF32
    off): y and stats within 1e-4 max|ref|, every gradient within 1e-3
    max|ref| (K5 fed the residuals K4 saved, so that both versions take the
    same PReLU branches; the sums run in another order over up to 9,216
    pixels). bf16: within 2x the plain version's bf16-vs-f32 envelope on
    the same inputs. Each kernel run twice must give the same bits. Then
    "hybrid" (the plain forward, then K5 on its residuals) against the
    plain backward on the same residuals, with K5's gates and bits."""
    import torch

    from srgan_st_tpu_torch.kernels import packed_trunk as pt

    fwd_rec, bwd_rec = {"errors": []}, {"errors": []}
    for shape, n in TRUNK_SHAPES:
        x, p, dy = _trunk_inputs(gen, dev, shape, n)
        bp = _bwd_params(p)
        got = pt._launch_fwd(x, *p, EPS)
        ref = pt._reference_forward(x, *p, EPS)
        gb = pt._launch_bwd(dy, *got[1:], *bp, EPS)
        rb = pt._reference_backward(dy, *got[1:], *bp, EPS)
        f32_fwd = {"y": _rel(got[0], ref[0]), "stats": _rel(got[4], ref[4])}
        f32_bwd = {k: _rel(a, b) for k, a, b in zip(GRAD_NAMES, gb, rb)}

        xb, dyb = x.bfloat16(), dy.bfloat16()
        p16 = [p[0].bfloat16().float(), p[1].bfloat16().float(), *p[2:]]
        got16 = pt._launch_fwd(xb, *p, EPS)
        plain16 = pt._reference_forward(xb, *p, EPS)
        ref32 = pt._reference_forward(xb.float(), *p16, EPS)
        res16 = got16[1:]
        res32 = [t.float() for t in res16[:3]] + [res16[3]]
        gb16 = pt._launch_bwd(dyb, *res16, *bp, EPS)
        pb16 = pt._reference_backward(dyb, *res16, *bp, EPS)
        rb32 = pt._reference_backward(dyb.float(), *res32, *_bwd_params(p16), EPS)
        deterministic = {
            "fwd": all(torch.equal(a, b) for a, b in
                       zip(got16, pt._launch_fwd(xb, *p, EPS))),
            "bwd": all(torch.equal(a, b) for a, b in
                       zip(gb16, pt._launch_bwd(dyb, *res16, *bp, EPS)))}
        torch.cuda.synchronize()
        bf16_fwd = {k: (max_abs(got16[i], ref32[i]), max_abs(plain16[i], ref32[i]))
                    for k, i in (("y", 0), ("stats", 4))}
        bf16_bwd = {k: (max_abs(a, r), max_abs(b, r))
                    for k, a, b, r in zip(GRAD_NAMES, gb16, pb16, rb32)}
        rec = {"shape": list(shape), "n": n, "f32_rel_err_fwd": f32_fwd,
               "f32_rel_err_bwd": f32_bwd, "bf16_err_and_envelope_fwd": bf16_fwd,
               "bf16_err_and_envelope_bwd": bf16_bwd, "bitwise_repeatable": deterministic}
        emit("kernel", kernel="packed_trunk", **rec)
        bad = ([k for k, e in f32_fwd.items() if not e <= 1e-4]
               + [k for k, e in f32_bwd.items() if not e <= 1e-3]
               + [k for k, (e, env) in {**bf16_fwd, **bf16_bwd}.items()
                  if not (env > 0 and e <= 2 * env)]
               + [k for k, ok in deterministic.items() if not ok])
        if bad:
            raise AssertionError(f"packed_trunk at {shape}, n={n}: {bad} out of bounds")
        # hybrid: K5 on the plain forward's residuals
        hrec = _hybrid_case(x, p, dy, bits=True)
        emit("kernel", kernel="hybrid_trunk", shape=list(shape), n=n, **hrec)
        bad = [f"{k} {g}" for k, r in hrec["ratios"].items() for g in ("f32", "bf16")
               if not r[g] <= 1] + [k for k, ok in hrec["bitwise_repeatable"].items() if not ok]
        if bad:
            raise AssertionError(f"hybrid_trunk at {shape}, n={n}: {bad} out of bounds")
        fwd_rec["errors"].append({"shape": list(shape), "f32_rel": f32_fwd, "bf16": bf16_fwd})
        bwd_rec["errors"].append({"shape": list(shape), "f32_rel": f32_bwd, "bf16": bf16_bwd})
        if shape == TRUNK_SHAPES[0][0]:
            timed = (xb, p, dyb, res16)
        del got, ref, gb, rb, got16, plain16, ref32, gb16, pb16, rb32
    _time_trunk(*timed, fwd_rec, bwd_rec)
    return fwd_rec, bwd_rec


def _sweep_draw(dev, shape, n, seed):
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(1000 + seed)
    return _trunk_inputs(gen, dev, shape, n)


def _hybrid_case(x, p, dy, bits: bool = False) -> dict:
    """The "hybrid" gates on one draw, as ratios of error to bound per
    gradient (a gate holds at <= 1). f32 (TF32 off): within 1e-3 max|ref|
    of the plain backward on the plain forward's residuals. bf16: within 2x
    the plain version's bf16-vs-f32 envelope, except dal: its per-block
    error rate against the f64 evaluation of the same residuals within 2x
    the plain bf16 version's (kernels/_checks.py dal_gate_ratio; dal is a
    signed sum of ~B*H*W*C products, whose error over max|dal| a cancelling
    sum inflates). Beside them, the f32 and bf16 errors of the kernel and of
    the plain version against f64, over max|f64|. `bits`: a second run of
    each gives the same bits."""
    import torch

    from srgan_st_tpu_torch.kernels import packed_trunk as pt
    from srgan_st_tpu_torch.kernels._checks import dal_gate_ratio, trunk_backward_f64

    def rel64(a, ref):
        return float((a.double() - ref).abs().max() / ref.abs().max().clamp(min=1e-300))

    bp = _bwd_params(p)
    hy = _hybrid_grads(x, p, dy)
    ref = pt._reference_forward(x, *p, EPS)
    hrb = pt._reference_backward(dy, *ref[1:], *bp, EPS)
    h64 = trunk_backward_f64(dy, *ref[1:], *bp, EPS)
    xb, dyb = x.bfloat16(), dy.bfloat16()
    p16 = [p[0].bfloat16().float(), p[1].bfloat16().float(), *p[2:]]
    hy16 = _hybrid_grads(xb, p, dyb)
    plain16 = pt._reference_forward(xb, *p, EPS)
    hres32 = [t.float() for t in plain16[1:4]] + [plain16[4]]
    hpb16 = pt._reference_backward(dyb, *plain16[1:], *bp, EPS)
    hrb32 = pt._reference_backward(dyb.float(), *hres32, *_bwd_params(p16), EPS)
    h64_16 = trunk_backward_f64(dyb, *plain16[1:], *_bwd_params(p16), EPS)
    ratios = {}
    for i, k in enumerate(GRAD_NAMES):
        env = max_abs(hpb16[i], hrb32[i])
        if k == "dal":
            r16 = dal_gate_ratio(hy16[i], hpb16[i], h64_16[i], h64_16[8])
        else:
            r16 = max_abs(hy16[i], hrb32[i]) / (2 * env) if env > 0 else float("inf")
        ratios[k] = {"f32": _rel(hy[i], hrb[i]) / 1e-3, "bf16": r16,
                     "f32_kernel_vs_f64": rel64(hy[i], h64[i]),
                     "f32_plain_vs_f64": rel64(hrb[i], h64[i]),
                     "bf16_kernel_vs_f64": rel64(hy16[i], h64_16[i]),
                     "bf16_plain_vs_f64": rel64(hpb16[i], h64_16[i])}
    rec = {"ratios": ratios}
    if bits:
        rec["bitwise_repeatable"] = {
            "f32": all(torch.equal(a, b) for a, b in zip(hy, _hybrid_grads(x, p, dy))),
            "bf16": all(torch.equal(a, b) for a, b in zip(hy16, _hybrid_grads(xb, p, dyb)))}
    torch.cuda.synchronize()
    return rec


def phase_hybrid_sweep(dev) -> dict:
    """The "hybrid" gates (_hybrid_case) over HYBRID_SEEDS seeded draws at
    each TRUNK_SHAPES entry, f32 and bf16: per gradient, the worst ratio of
    each gate and the worst of each f64 yardstick, and every draw that
    failed a gate."""
    worst, failures = {}, []
    for shape, n in TRUNK_SHAPES:
        for seed in range(HYBRID_SEEDS):
            ratios = _hybrid_case(*_sweep_draw(dev, shape, n, seed))["ratios"]
            for k, r in ratios.items():
                w = worst.setdefault(k, dict.fromkeys(r, 0.0))
                for g, v in r.items():
                    w[g] = max(w[g], v)
                failures += [{"shape": list(shape), "seed": seed, "grad": k, "gate": g, **r}
                             for g in ("f32", "bf16") if not r[g] <= 1]
    rec = {"case": "seed_sweep", "seeds": HYBRID_SEEDS,
           "shapes": [[list(s), n] for s, n in TRUNK_SHAPES],
           "worst_ratio": worst, "failures": failures}
    emit("kernel", kernel="hybrid_trunk", **rec)
    if failures:
        raise AssertionError(f"hybrid_trunk seed sweep: {len(failures)} gate failures")
    return rec


def _cudnn_trunk(x, p):
    """The yardstick: the unfused trunk as cuDNN convs, cuDNN train-mode
    BatchNorm and F.prelu, in x's dtype (bf16), channels_last."""
    import torch
    import torch.nn.functional as F

    w1s, w2s, g1s, b1s, g2s, b2s, als = p
    h = x.permute(0, 3, 1, 2)
    for i in range(w1s.shape[0]):
        t = F.conv2d(h, w1s[i], padding=1)
        t = F.batch_norm(t, None, None, g1s[i], b1s[i], training=True, eps=EPS)
        t = F.prelu(t, als[i:i + 1])
        t = F.conv2d(t, w2s[i], padding=1)
        h = h + F.batch_norm(t, None, None, g2s[i], b2s[i], training=True, eps=EPS)
    return h


def _time_trunk(xb, p, dyb, res16, fwd_rec, bwd_rec) -> None:
    import torch

    from srgan_st_tpu_torch.kernels import packed_trunk as pt

    bp = _bwd_params(p)
    n, b, h, w, c = res16[0].shape
    act = b * h * w * c
    conv_flops = 2 * b * h * w * 9 * c * c  # one 3x3 conv
    weights = 2 * n * 9 * c * c
    f_bytes = _trunk_fwd_bytes(n, b, h, w, c)
    # backward: read dy, the residuals, stats, weights; write dx, dW (f32),
    # the BN and slope gradients
    b_bytes = (2 * act + 3 * 2 * n * act + 4 * n * 4 * c + 2 * weights
               + 2 * act + 4 * weights + 4 * n * (4 * c + 1))
    lib = _cudnn_inputs(xb, p)
    for t in lib:
        t.requires_grad_()
    xl = xb.detach().clone().requires_grad_()
    dyl = dyb.permute(0, 3, 1, 2)

    def lib_fwd_bwd():
        torch.autograd.backward(_cudnn_trunk(xl, lib), dyl)

    lib_fwd = cuda_ms(lambda: _cudnn_trunk(xl, lib))
    lib_total = cuda_ms(lib_fwd_bwd)
    # `ms`: the wrapper, which lays the weights out on every call, as a
    # train step does (the optimizer changes them between steps);
    # `launch_ms`: the launch on weights laid out in advance
    wf = pt._layout_fwd(p[0], p[1], xb.device, xb.dtype)
    wb = pt._layout_bwd(p[0], p[1], xb.device, xb.dtype)
    launch_fwd = lambda: pt._launch_fwd(xb, *p, EPS, weights=wf)  # noqa: E731
    launch_bwd = lambda: pt._launch_bwd(dyb, *res16, *bp, EPS, weights=wb)  # noqa: E731
    wrap_fwd = lambda: pt._launch_fwd(xb, *p, EPS)  # noqa: E731
    wrap_bwd = lambda: pt._launch_bwd(dyb, *res16, *bp, EPS)  # noqa: E731
    for rec, nbytes, flops, wrap, launch, plain, backward in (
        (fwd_rec, f_bytes, 2 * n * conv_flops, wrap_fwd, launch_fwd,
         lambda: pt._reference_forward(xb, *p, EPS), False),
        (bwd_rec, b_bytes, 4 * n * conv_flops, wrap_bwd, launch_bwd,
         lambda: pt._reference_backward(dyb, *res16, *bp, EPS), True),
    ):
        own = design_flops("packed_trunk", "packed_trunk_bf16_mma_flops", n, b, h, w, c,
                           int(backward))
        rec.update(shape=[b, h, w, c], n=n, ms=cuda_ms(wrap), launch_ms=cuda_ms(launch),
                   plain_ms=cuda_ms(plain, iters=5), host_enqueue_ms=host_ms(wrap),
                   bytes=nbytes, flops=flops,
                   launches_per_call=pt.launches_per_call(n, xb.dtype, backward),
                   design_flops=own, floor_ms=own / BF16_FLOPS * 1e3)
        rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops)
        # one call of each: the kernels alone (on laid-out weights), then
        # the wrapper; the kernels the profiler sees must be those the
        # library says it launches
        rec["profile"] = profile_once(launch, 20)
        rec["wrapper_profile"] = profile_once(wrap, 20)
        if rec["profile"]["kernels"] != rec["launches_per_call"]:
            raise AssertionError(
                f"packed_trunk {'bwd' if backward else 'fwd'}: the profiler saw "
                f"{rec['profile']['kernels']} kernels in one call, the library "
                f"reports {rec['launches_per_call']}")
    fwd_rec["library_ms"] = lib_fwd
    bwd_rec["library_ms"] = lib_total - lib_fwd
    bwd_rec["library_fwd_bwd_ms"] = lib_total
    emit("kernel_time", kernel="packed_trunk_fwd",
         **{k: v for k, v in fwd_rec.items() if k != "errors"})
    emit("kernel_time", kernel="packed_trunk_bwd",
         **{k: v for k, v in bwd_rec.items() if k != "errors"})


def _train_config(trunk: str, name: str):
    from srgan_st_tpu_torch.core.config import Config, apply_overrides

    return apply_overrides(Config(), [
        "TPU.COMPUTE_DTYPE=bfloat16", f"TPU.TRUNK_MODE={trunk}", "DATA.SYNTHETIC=true",
        f"DATA.SYNTHETIC_N_BATCHES={TRAIN_STEPS}", "EXP.N_EPOCHS=1",
        "SOLVER.D_UPDATE_INTERVAL=2", "LOG_TRAIN_PERIOD=1", f"EXP.NAME={name}"])


def _gan_state(cfg, dev):
    from srgan_st_tpu_torch.models.discriminator import Discriminator
    from srgan_st_tpu_torch.models.generator import Generator
    from srgan_st_tpu_torch.train.steps import create_gan_state

    return create_gan_state(cfg, Generator.from_config(cfg),
                            Discriminator.from_config(cfg), TRAIN_STEPS, dev)


def _flat(module):
    import torch

    return torch.cat([p.detach().float().reshape(-1) for p in module.parameters()])


def _running(module):
    import torch

    return torch.cat([b.detach().float().reshape(-1) for name, b in module.named_buffers()
                      if name.endswith(("running_mean", "running_var"))])


def phase_train(dev, batch) -> dict:
    """The slice's main path: warmup() then train() at full width, launch
    counts reset just before and read just after; then one more G and D
    step checked."""
    import torch

    from srgan_st_tpu_torch.kernels import launch_counts, reset_launch_counts
    from srgan_st_tpu_torch.losses.registry import build_criterions
    from srgan_st_tpu_torch.train.steps import make_gan_steps
    from srgan_st_tpu_torch.train.train import train
    from srgan_st_tpu_torch.train.warmup import warmup

    cfg_w, cfg_t = _train_config("packed", "smoke-warmup"), _train_config("packed", "smoke-train")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            reset_launch_counts()
            t0 = time.perf_counter()
            warmup(cfg_w, device=dev)
            after_warmup = launch_counts()
            state = train(cfg_t, device=dev)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = launch_counts()
            files = sorted(os.listdir(os.path.join(tmp, "results", "smoke-train")))
        finally:
            os.chdir(cwd)
    # per phase: TRAIN_STEPS G steps (one K4 and one K5 each) and
    # TRAIN_STEPS + 3 G forwards (the steps and the 3 validation pairs, whose
    # eval trunk is kernel E)
    steps = TRAIN_STEPS
    want = {"packed_trunk_fwd": 2 * steps, "packed_trunk_bwd": 2 * steps,
            "coarse_conv_s2d": 2 * (steps + 3), "serving_tail": 0, "fused_trunk": 0,
            "buddy_select": 0, "eval_trunk": 2 * 3, "rrdb_dense": 0, "rrdb_hr": 0,
            "rrdb_trunk": 0, "swin_attn": 0, "swin_trunk": 0, "window_attn": 0}
    fresh = _gan_state(cfg_t, dev)
    moved = {"g": bool((_flat(state.g_model) != _flat(fresh.g_model)).any()),
             "d": bool((_flat(state.d_model) != _flat(fresh.d_model)).any())}
    g_step, d_step = make_gan_steps(cfg_t, build_criterions(cfg_t))
    d_params, d_stats = _flat(state.d_model), _running(state.d_model)
    g_params = _flat(state.g_model)
    state, sr, g_metrics = g_step(state, batch)
    d_stats_move_in_g_step = bool((_running(state.d_model) != d_stats).any())
    d_params_fixed_in_g_step = bool(torch.equal(_flat(state.d_model), d_params))
    g_params_move = bool((_flat(state.g_model) != g_params).any())
    state, d_metrics = d_step(state, batch, sr)
    metrics = {k: float(v) for k, v in {**g_metrics, **d_metrics}.items()}
    finite = all(np.isfinite(v) for v in metrics.values()) and bool(
        torch.isfinite(_flat(state.g_model)).all() and torch.isfinite(_flat(state.d_model)).all())
    rec = {"seconds": seconds, "launches_after_warmup": after_warmup,
           "launches_total": counts, "launches_expected": want, "results_files": files,
           "params_moved_by_training": moved, "step_metrics": metrics,
           "d_stats_move_in_g_step": d_stats_move_in_g_step,
           "d_params_fixed_in_g_step": d_params_fixed_in_g_step,
           "g_params_move": g_params_move, "finite": finite}
    emit("train", **rec)
    if counts != want or after_warmup["packed_trunk_fwd"] != steps:
        raise AssertionError(f"train launches {counts}, expected {want}")
    if not (all(moved.values()) and finite and d_stats_move_in_g_step
            and d_params_fixed_in_g_step and g_params_move):
        raise AssertionError(f"train checks failed: {rec}")
    return rec


def phase_check_train(dev, batch) -> dict:
    """One GAN step, packed vs unfused trunk, from the same seeded state."""
    from srgan_st_tpu_torch.losses.registry import build_criterions
    from srgan_st_tpu_torch.train.steps import make_gan_steps

    out = {}
    for trunk in ("packed", "unfused", "f32"):
        cfg = _train_config("unfused" if trunk == "f32" else trunk, "check")
        if trunk == "f32":
            cfg.TPU.COMPUTE_DTYPE = "float32"
        state = _gan_state(cfg, dev)
        g_step, d_step = make_gan_steps(cfg, build_criterions(cfg))
        state, sr, gm = g_step(state, batch)
        state, dm = d_step(state, batch, sr)
        out[trunk] = ({k: float(v) for k, v in {**gm, **dm}.items()},
                      _flat(state.g_model), _flat(state.d_model))
    lr = _train_config("packed", "check").SOLVER.G_BASE_LR

    def loss_rel(a, b):
        return max(abs(v - out[b][0][k]) / abs(out[b][0][k])
                   for k, v in out[a][0].items() if "Probability" not in k)

    rec = {"losses": {t: o[0] for t, o in out.items()},
           "loss_rel_diff": loss_rel("packed", "unfused"),
           "g_param_max_diff": max_abs(out["packed"][1], out["unfused"][1]),
           "d_param_max_diff": max_abs(out["packed"][2], out["unfused"][2]),
           "param_bound": 2.01 * lr,
           # for scale: each bf16 trunk against the f32 unfused step
           "loss_rel_diff_vs_f32": {t: loss_rel(t, "f32") for t in ("packed", "unfused")},
           "g_param_max_diff_vs_f32": {t: max_abs(out[t][1], out["f32"][1])
                                       for t in ("packed", "unfused")}}
    emit("check", train=rec)
    if not (rec["loss_rel_diff"] <= 1e-2 and rec["g_param_max_diff"] <= 2.01 * lr
            and rec["d_param_max_diff"] <= 2.01 * lr):
        raise AssertionError(f"packed vs unfused GAN step out of bounds: {rec}")
    return rec


def phase_time_train(dev, batch) -> dict:
    """ms per warmup step, G step and GAN step (G + D) for both trunks;
    the batch is already on the device (data loading is set-up)."""
    import torch

    from srgan_st_tpu_torch.losses.registry import build_criterions, build_warmup_criterions
    from srgan_st_tpu_torch.models.generator import Generator
    from srgan_st_tpu_torch.train.steps import (
        create_generator_state, make_gan_steps, make_warmup_step,
    )

    def make_gan(state, g_step, d_step):
        def gan():
            _, sr, _ = g_step(state, batch)
            d_step(state, batch, sr)
        return gan

    rec, profiles, gans = {}, {}, {}
    for trunk in ("packed", "unfused"):
        cfg = _train_config(trunk, "time")
        w_state = create_generator_state(cfg, Generator.from_config(cfg), TRAIN_STEPS,
                                         dev, milestones=False)
        w_step = make_warmup_step(cfg, build_warmup_criterions(cfg))
        state = _gan_state(cfg, dev)
        g_step, d_step = make_gan_steps(cfg, build_criterions(cfg))
        gan = gans[trunk] = make_gan(state, g_step, d_step)

        torch.cuda.reset_peak_memory_stats()
        warm_ms = cuda_ms(lambda: w_step(w_state, batch))
        g_ms = cuda_ms(lambda: g_step(state, batch))
        gan_ms = cuda_ms(gan)
        b = batch.shape[0]
        rec[trunk] = {"ms_per_warmup_step": warm_ms, "ms_per_g_step": g_ms,
                      "ms_per_gan_step": gan_ms,
                      "patches_per_s_warmup": b / (warm_ms / 1e3),
                      "patches_per_s_gan_step": b / (gan_ms / 1e3),
                      "patches_per_s_d_every_100": b / ((g_ms + (gan_ms - g_ms) / 100) / 1e3),
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        profiles[trunk] = profile_once(gan)
    # packed and unfused GAN steps in turns (ABAB) in this process: the
    # per-pair ratio is free of the drift between machines and over time
    times = {"packed": [], "unfused": []}
    for _ in range(TRUNK_PAIRS):
        for trunk in times:
            times[trunk].append(cuda_ms(gans[trunk], iters=1, warmup=0))
    ratios = [a / b for a, b in zip(times["packed"], times["unfused"])]
    rec["paired_gan_step"] = {
        "pairs": TRUNK_PAIRS, "packed_ms": times["packed"], "unfused_ms": times["unfused"],
        "ratio_packed_over_unfused": {"median": float(np.median(ratios)),
                                      "min": min(ratios), "max": max(ratios)}}
    emit("time", train="batch 16, 96x96 GT, x4, bf16", **rec)
    emit("profile", train="one GAN step (G + D)", **profiles)
    return rec


# ---------------------------------------------------------------------------
# the data pipeline (packed archive, resident pack, crops, augmentation)

# DIV2K's 800 training images tiled at 96^2, as the JAX package sizes its
# HBM-resident pack (~3.6 GB, srgan_st_tpu/data/pipeline.py:370-374)
PACK_PATCHES = 130_208
DATA_STEPS = 24  # batches of each capped train() epoch from the pack
DATA_RUNS = 2  # train() runs per DEVICE_CACHE setting, in turns
FETCH_BATCHES = 200  # batches per fetch timing


def _write_pack(path: str, n: int, size: int, seed: int = 0) -> None:
    """A uint8 (n, size, size, 3) pack written with open_memmap: a seeded
    4,096-patch block repeated, each patch's first 8 bytes its index
    (little-endian int64), so that order checks are exact."""
    block = np.random.default_rng(seed).integers(0, 256, (4096, size, size, 3), np.uint8)
    pack = np.lib.format.open_memmap(path, mode="w+", dtype=np.uint8, shape=(n, size, size, 3))
    for i in range(0, n, len(block)):
        k = min(len(block), n - i)
        chunk = block[:k].copy()
        chunk.reshape(k, -1)[:, :8] = np.arange(i, i + k, dtype="<i8").view(np.uint8).reshape(k, 8)
        pack[i:i + k] = chunk
    pack.flush()
    del pack


def _codes(batch):
    """The patch indices coded in a batch's first bytes (numpy int64)."""
    import torch

    head = batch.reshape(batch.shape[0], -1)[:, :8]
    if isinstance(head, torch.Tensor):
        head = head.cpu().numpy()
    return np.ascontiguousarray(head).view("<i8")[:, 0]


class _CappedSource:
    """The first `k` batches of each epoch of `source`, with the host time
    at which each was handed to the training loop (and the time the loop
    asked for one more), each stamp after a device synchronize: replayed
    graph steps leave the host far ahead of the device, so an unsynchronized
    stamp would time the enqueue. The epoch's set-up (the resident copy)
    comes before the first stamp."""

    def __init__(self, source, k: int):
        self.source, self.k, self.stamps = source, k, []

    def __len__(self) -> int:
        return self.k

    def epoch(self, epoch_idx=None):
        it = self.source.epoch(epoch_idx)
        import torch

        for _, batch in zip(range(self.k), it):
            torch.cuda.synchronize()
            self.stamps.append(time.perf_counter())
            yield batch
        torch.cuda.synchronize()
        self.stamps.append(time.perf_counter())
        it.close()


def _capped_train(entry, cfg, dev, k: int):
    """warmup() or train() (`entry`) with its source capped at k batches an
    epoch and the synthetic validation pairs (the machine has no PIL to
    decode a test set), in a temporary directory. Returns (state, the
    capped source, launch counts, seconds)."""
    import importlib

    import torch

    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.data import pipeline
    from srgan_st_tpu_torch.kernels import launch_counts, reset_launch_counts
    from srgan_st_tpu_torch.train.utils import make_test_pairs

    module = importlib.import_module(entry.__module__)
    capped = []

    def source(config, device=None):
        capped.append(_CappedSource(pipeline.make_train_source(config, device), k))
        return capped[-1]

    def pairs(config):
        synthetic = Config()
        synthetic.DATA.SYNTHETIC = True
        return make_test_pairs(synthetic)

    saved = module.make_train_source, module.make_test_pairs
    module.make_train_source, module.make_test_pairs = source, pairs
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            reset_launch_counts()
            t0 = time.perf_counter()
            state = entry(cfg, device=dev)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = launch_counts()
        finally:
            os.chdir(cwd)
            module.make_train_source, module.make_test_pairs = saved
    return state, capped[0], counts, seconds


def _stamped_step_times(stamps) -> dict:
    """ms per G step and per GAN step from a capped epoch's stamps: the
    interval after batch i is step i (a D step too on even i, with
    D_UPDATE_INTERVAL=2) and the next fetch; batch 0 (its log line waits
    for the device) is left out."""
    gaps = np.diff(np.asarray(stamps)) * 1e3
    g_ms = float(np.median(gaps[1::2]))
    gan_ms = float(np.median(gaps[2::2]))
    return {"ms_per_g_step": g_ms, "ms_per_gan_step": gan_ms,
            "patches_per_s_d_every_100": 16 / ((g_ms + (gan_ms - g_ms) / 100) / 1e3)}


def phase_data(dev) -> dict:
    """The packed archive at DIV2K's size, its resident copy and the train
    step's crops and augmentation on the card."""
    import torch

    from srgan_st_tpu_torch.core.config import Config, apply_overrides
    from srgan_st_tpu_torch.data.pipeline import PackedPatchSource
    from srgan_st_tpu_torch.train.steps import _prepare_batch, draw_augment
    from srgan_st_tpu_torch.train.train import train
    from srgan_st_tpu_torch.train.warmup import warmup

    rec = {}
    with tempfile.TemporaryDirectory() as tmp:
        pack = os.path.join(tmp, "patches.pack.npy")
        t0 = time.perf_counter()
        _write_pack(pack, PACK_PATCHES, 96)
        rec["pack"] = {"patches": PACK_PATCHES, "bytes": os.path.getsize(pack),
                       "write_seconds": time.perf_counter() - t0, "cut": None}
        auto = PackedPatchSource(pack, 16, device=dev)
        rec["pack"]["auto_takes_the_resident_pack"] = auto.device_cache
        # (1) order: the resident and the host path, epochs 0 and 1
        order = {}
        for epoch in (0, 1):
            host = PackedPatchSource(pack, 16, device_cache=False, device=dev)
            res = PackedPatchSource(pack, 16, device_cache=True, device=dev)
            want = np.random.default_rng((0, epoch)).permutation(PACK_PATCHES)[:len(host) * 16]
            host_codes, res_heads, ends = [], [], {}
            for b, (hb, rb) in enumerate(zip(host.epoch(epoch), res.epoch(epoch))):
                host_codes.append(_codes(hb))
                res_heads.append(rb.reshape(16, -1)[:, :8].clone())
                if b in (0, len(host) - 1):
                    ends[b] = bool(torch.equal(torch.from_numpy(hb).to(dev), rb))
            res_codes = _codes(torch.cat(res_heads))
            host_codes = np.concatenate(host_codes)
            order[epoch] = {"batches": len(host), "host_is_permutation": bool(
                np.array_equal(host_codes, want)), "resident_equals_host": bool(
                np.array_equal(res_codes, host_codes)), "first_last_batch_bits": ends}
        rec["order"] = order
        # (2) ms per batch fetch, to a batch on the card, in turns
        fetch = {"host": [], "resident": []}
        for _ in range(2):
            for kind in fetch:
                src = PackedPatchSource(pack, 16, device_cache=kind == "resident", device=dev)
                it = src.epoch(5)
                next(it)  # the resident copy, the prefetch thread's start
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _, b in zip(range(FETCH_BATCHES), it):
                    torch.as_tensor(b).to(dev, non_blocking=False)
                torch.cuda.synchronize()
                fetch[kind].append((time.perf_counter() - t0) * 1e3 / FETCH_BATCHES)
                it.close()
        rec["ms_per_batch_fetch"] = fetch
        # (3) train() from the pack, DEVICE_CACHE on and off, and on with
        # the eager steps (TPU.CUDA_GRAPHS=false), in turns; one batch a
        # chunk, so that each stamp interval is one step
        runs = {"true": [], "false": [], "true/eager": []}
        for _ in range(DATA_RUNS):
            for arm in runs:
                cache, _, eager = arm.partition("/")
                cfg = apply_overrides(Config(), [
                    "TPU.COMPUTE_DTYPE=bfloat16", "TPU.TRUNK_MODE=packed",
                    f"DATA.TRAIN_GT_IMAGES_DIR={tmp}", f"DATA.DEVICE_CACHE={cache}",
                    "EXP.N_EPOCHS=1", "SOLVER.D_UPDATE_INTERVAL=2", "EXP.NAME=smoke-data",
                    "TPU.CHUNK_STEPS=1", f"TPU.CUDA_GRAPHS={not eager}"])
                _, capped, counts, seconds = _capped_train(train, cfg, dev, DATA_STEPS)
                runs[arm].append({**_stamped_step_times(capped.stamps), "seconds": seconds,
                                  "launches": counts})
        eager_runs = runs.pop("true/eager")
        rec["train"] = {"steps_per_run": DATA_STEPS, "device_cache": runs,
                        "device_cache_eager_steps": eager_runs}
        want_counts = {"packed_trunk_fwd": DATA_STEPS, "packed_trunk_bwd": DATA_STEPS,
                       "coarse_conv_s2d": DATA_STEPS + 3, "serving_tail": 0,
                       "fused_trunk": 0, "buddy_select": 0, "eval_trunk": 3,
                       "rrdb_dense": 0, "rrdb_hr": 0, "rrdb_trunk": 0,
                       "swin_attn": 0, "swin_trunk": 0, "window_attn": 0}
        del auto
    # (4) 120^2 tiles, crop + augment on the card against the CPU function
    with tempfile.TemporaryDirectory() as tmp:
        pack = os.path.join(tmp, "patches.pack.npy")
        _write_pack(pack, 64, 120, seed=1)
        cfg = apply_overrides(Config(), ["DATA.TILE_SIZE=120", "DATA.AUGMENT=true"])
        batch = next(PackedPatchSource(pack, 16, device_cache=True, device=dev).epoch(0))
        draws = draw_augment(cfg, 3, 0, 16, (120, 120), True)
        gt_c, lr_c = _prepare_batch(batch, cfg, dev, **draws)
        gt_p, lr_p = _prepare_batch(batch.cpu(), cfg, "cpu", **draws)
        lr_diff = (lr_c.cpu() - lr_p).abs()
        aug = {"gt_bits_equal": bool(torch.equal(gt_c.cpu(), gt_p)),
               "lr_max_abs_diff": float(lr_diff.max()),
               "lr_equal_fraction": float((lr_diff == 0).float().mean()),
               "flips": int(draws["flip"].sum()), "rot_counts": torch.bincount(
                   draws["rot"], minlength=4).tolist()}
        # warmup() from this pack through the entry point, cropped and augmented
        wcfg = apply_overrides(Config(), [
            "TPU.COMPUTE_DTYPE=bfloat16", f"DATA.TRAIN_GT_IMAGES_DIR={tmp}",
            "DATA.TILE_SIZE=120", "DATA.AUGMENT=true", "EXP.N_EPOCHS=1",
            "EXP.NAME=smoke-augment", "LOG_TRAIN_PERIOD=1"])
        state, _, counts, _ = _capped_train(warmup, wcfg, dev, 4)
        aug["warmup_launches"] = counts
        aug["warmup_finite"] = bool(torch.isfinite(_flat(state.g_model)).all())
    rec["crop_augment"] = aug
    emit("data", **rec)
    bad = [e for e, o in order.items() if not (o["host_is_permutation"]
           and o["resident_equals_host"] and all(o["first_last_batch_bits"].values()))]
    bad += [f"{c} launches {r['launches']}" for c, rs in [*runs.items(), ("eager", eager_runs)]
            for r in rs if r["launches"] != want_counts]
    if not rec["pack"]["auto_takes_the_resident_pack"]:
        bad.append("DEVICE_CACHE=auto did not take the pack")
    if not (aug["gt_bits_equal"] and aug["lr_max_abs_diff"] <= 1 / 255 + 1e-6
            and aug["warmup_finite"] and aug["warmup_launches"]["packed_trunk_fwd"] == 4):
        bad.append(f"crop/augment {aug}")
    if bad:
        raise AssertionError(f"data phase: {bad}")
    return rec


# ---------------------------------------------------------------------------
# multi-GPU training: two gloo ranks on one card, a one-rank NCCL group

DIST_STEPS = 3  # batches per epoch of warmup() and train() in the dist phase
DIST_TIMED = 5  # GAN steps timed per rank


def _dist_sets(dtype: str, local_bn: bool, name: str, graphs: bool = False,
               dcp: bool = False) -> list[str]:
    """The dist runs' overrides: one batch a chunk (a log line a batch),
    CUDA graphs off (gloo collectives cannot be captured) unless `graphs`,
    and with `dcp` the train states as DCP directories
    (EXP.ORBAX_CHECKPOINTS)."""
    return [f"TPU.COMPUTE_DTYPE={dtype}", f"TPU.LOCAL_BN={local_bn}", "DATA.SYNTHETIC=true",
            f"DATA.SYNTHETIC_N_BATCHES={DIST_STEPS}", "EXP.N_EPOCHS=1",
            "SOLVER.D_UPDATE_INTERVAL=2", "LOG_TRAIN_PERIOD=1", f"EXP.NAME={name}",
            "TPU.CHUNK_STEPS=1", f"TPU.CUDA_GRAPHS={graphs}", f"EXP.ORBAX_CHECKPOINTS={dcp}"]


def _fresh_gan_state(cfg, dev, mesh):
    """A GAN state of `cfg` from another seed than the runs' (DATA.SEED)."""
    import torch

    from srgan_st_tpu_torch.models.discriminator import Discriminator
    from srgan_st_tpu_torch.models.generator import Generator
    from srgan_st_tpu_torch.train.steps import create_gan_state

    return create_gan_state(cfg, Generator.from_config(cfg, group=mesh),
                            Discriminator.from_config(cfg, group=mesh), DIST_STEPS, dev,
                            generator=torch.Generator().manual_seed(99))


def _ckpt_case(cfg, state, dev, mesh) -> dict:
    """EXP.ORBAX_CHECKPOINTS on the card, called by every rank: (a) the DCP
    `last/` that train() saved at its epoch's end, restored into a fresh
    state, against `state` (what it saved); (b) save_epoch of `state` into
    a new directory, rank 0 with metrics and the others with NaN (is_best
    on every rank: the metrics are broadcast), restored into another fresh
    state. Bit for bit: every parameter, running statistic, Adam moment and
    step count, update count and `step`. Then (c) `_torn_save`: a save that
    fails partway leaves (b)'s `last/`."""
    import torch

    from srgan_st_tpu_torch.parallel.distributed import process_info
    from srgan_st_tpu_torch.train.checkpoint import CheckpointPolicy, train_state_arrays

    saved = train_state_arrays(state)
    rank = process_info()[0]
    rec = {"tensors": len(saved), "bytes": int(sum(v.nbytes for v in saved.values()))}
    for case, results in (("train_last", f"results/{cfg.EXP.NAME}"),
                          ("save_epoch", f"results/{cfg.EXP.NAME}-dcp")):
        policy = CheckpointPolicy(results, use_orbax=True)
        if case == "save_epoch":
            metrics = (28.0, 0.8) if rank == 0 else (float("nan"), float("nan"))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec["is_best"] = policy.save_epoch(state, 1, *metrics)
            rec["save_seconds"] = time.perf_counter() - t0
        fresh = _fresh_gan_state(cfg, dev, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restored = policy.restore_latest(fresh)
        torch.cuda.synchronize()
        got = train_state_arrays(fresh)
        rec[case] = {"collective": policy.collective, "restored": restored,
                     "restore_seconds": time.perf_counter() - t0,
                     "bit_identical": got.keys() == saved.keys() and all(
                         np.array_equal(got[k], saved[k]) for k in saved),
                     "moments": sum(".moments." in k for k in got)}
    rec["torn"] = _torn_save(cfg, state, saved, dev, mesh, rank)
    rec["ok"] = bool(rec["is_best"] and all(
        rec[c]["restored"] and rec[c]["bit_identical"] and rec[c]["moments"] > 0
        for c in ("train_last", "save_epoch")) and rec["torn"]["ok"])
    return rec


def _torn_save(cfg, state, saved: dict, dev, mesh, rank: int) -> dict:
    """After `_ckpt_case`'s save_epoch: a save_epoch of another state (fresh
    weights, one step on) into the same directory that fails partway on
    rank 1 (on rank 0 without a group): DCP's file writer raises at that
    rank's third item, as a crash would stop it. Every rank must see DCP's
    CheckpointException (a BaseException), the old `last/` must stay, and a
    fresh state must restore it: `saved` bit for bit."""
    import torch
    import torch.distributed.checkpoint.filesystem as fs

    from srgan_st_tpu_torch.train.checkpoint import CheckpointPolicy, train_state_arrays

    results = f"results/{cfg.EXP.NAME}-dcp"
    policy = CheckpointPolicy(results, use_orbax=True)
    failing = 1 if policy.collective else 0
    other = _fresh_gan_state(cfg, dev, mesh)
    other.step = state.step + 1
    real, calls = fs._write_item, [0]

    def write_item(*args, **kwargs):
        calls[0] += 1
        if rank == failing and calls[0] > 2:
            raise OSError("the disk was lost mid-save")
        return real(*args, **kwargs)

    raised = None
    fs._write_item = write_item
    try:
        policy.save_epoch(other, 2, 27.0 if rank == 0 else float("nan"), float("nan"))
    except BaseException as e:  # noqa: BLE001 - DCP's CheckpointException is no Exception
        raised = type(e).__name__
    finally:
        fs._write_item = real
    left = sorted(os.listdir(results))
    fresh = _fresh_gan_state(cfg, dev, mesh)
    restored = policy.restore_latest(fresh)
    torch.cuda.synchronize()
    got = train_state_arrays(fresh)
    same = got.keys() == saved.keys() and all(np.array_equal(got[k], saved[k]) for k in saved)
    return {"failing_rank": failing, "raised": raised, "left": left, "restored": restored,
            "bit_identical": same, "ok": bool(raised == "CheckpointException" and restored
                                              and same and "last" in left)}


def _dist_run(sets: list[str], dev) -> dict:
    """warmup() then train() with `sets` in the working directory: the
    losses they print, their final states (numpy), the launch counts and
    the ms of DIST_TIMED more GAN steps on this rank's share of a batch."""
    import contextlib
    import io
    import re

    import torch

    from srgan_st_tpu_torch.core.config import Config, apply_overrides
    from srgan_st_tpu_torch.kernels import launch_counts, reset_launch_counts
    from srgan_st_tpu_torch.losses.registry import build_criterions
    from srgan_st_tpu_torch.parallel.mesh import make_mesh
    from srgan_st_tpu_torch.train.steps import make_gan_steps
    from srgan_st_tpu_torch.train.train import train
    from srgan_st_tpu_torch.train.warmup import warmup

    log = io.StringIO()
    reset_launch_counts()
    name = apply_overrides(Config(), sets).EXP.NAME
    with contextlib.redirect_stdout(log):
        w = warmup(apply_overrides(Config(), sets + [f"EXP.NAME={name}-warmup"]), device=dev)
        t = train(apply_overrides(Config(), sets), device=dev)
    torch.cuda.synchronize()
    counts = launch_counts()
    text = log.getvalue()
    losses = {"G": [float(v) for v in re.findall(r"\[G loss: ([^\]]+)\]", text)],
              "D": [float(v) for v in re.findall(r"\[D loss: ([^\]]+)\]", text)]}
    states = {f"{p}/{k}": v.detach().float().cpu().numpy().copy()  # before the timed steps
              for p, m in (("w", w.g_model), ("g", t.g_model), ("d", t.d_model))
              for k, v in m.state_dict().items() if not k.endswith("num_batches_tracked")}
    cfg = apply_overrides(Config(), sets)
    mesh = make_mesh(cfg)
    ckpt = _ckpt_case(cfg, t, dev, mesh) if cfg.EXP.ORBAX_CHECKPOINTS else None
    g_step, d_step = make_gan_steps(cfg, build_criterions(cfg), mesh)
    batch = torch.from_numpy(np.random.default_rng(9).integers(
        0, 256, (16, 96, 96, 3), np.uint8)[mesh.batch_slice(16)]).to(dev)

    def gan():
        _, sr, _ = g_step(t, batch)
        d_step(t, batch, sr)

    gan()
    mesh.barrier()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DIST_TIMED):
        gan()
    torch.cuda.synchronize()
    gan_ms = (time.perf_counter() - t0) * 1e3 / DIST_TIMED
    return {"losses": losses, "states": states, "launches": counts, "ms_per_gan_step": gan_ms,
            "ckpt": ckpt}


def _nccl_ckpt(argv: list[str]) -> None:
    """After train's command-line run in the one-rank NCCL group (argv its
    arguments): its DCP `last/` restored into a fresh state holds the G and
    D weights of its g_last.npz / d_last.npz bit for bit, then
    `_ckpt_case` on that state; prints one "CKPT {...}" line."""
    import torch

    from srgan_st_tpu_torch.core.config import parse_driver_cli
    from srgan_st_tpu_torch.parallel.mesh import make_mesh
    from srgan_st_tpu_torch.train.checkpoint import (
        CheckpointPolicy, _flatten, load_params_npz, variables_from_discriminator_state_dict,
        variables_from_generator_state_dict,
    )

    cfg, device = parse_driver_cli(argv, "")
    dev, mesh = torch.device(device), make_mesh(cfg)
    results = f"results/{cfg.EXP.NAME}"
    state = _fresh_gan_state(cfg, dev, mesh)
    restored = CheckpointPolicy(results, use_orbax=True).restore_latest(state)
    same = True
    for key, to_vars in (("g", variables_from_generator_state_dict),
                         ("d", variables_from_discriminator_state_dict)):
        want = _flatten(load_params_npz(os.path.join(results, f"{key}_last.npz")))
        got = _flatten(to_vars(getattr(state, f"{key}_model").state_dict()))
        same &= got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)
    rec = _ckpt_case(cfg, state, dev, mesh)
    rec.update(restored_train_last=restored, equals_npz_weights=bool(same),
               ok=bool(rec["ok"] and restored and same))
    print("CKPT " + json.dumps(rec), flush=True)


def _dist_child(work: str, device: str) -> int:
    """One of two gloo ranks on `device` (SRGAN_ST_* variables set by
    phase_dist): sync-BN (f32, unfused) and LOCAL_BN (bf16, packed) runs of
    warmup() + train(), and the tiled eval of the frame over the ranks."""
    import torch
    import torch.distributed as dist

    from srgan_st_tpu_torch.core.config import Config, apply_overrides
    from srgan_st_tpu_torch.eval.tiled import TiledApplier, generator_halo
    from srgan_st_tpu_torch.eval.validate import make_generator_apply
    from srgan_st_tpu_torch.parallel.distributed import initialize_distributed, process_info
    from srgan_st_tpu_torch.parallel.mesh import make_mesh
    from srgan_st_tpu_torch.train.checkpoint import load_params_npz

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    assert initialize_distributed(device=dev, backend="gloo")
    rank = process_info()[0]
    out = {}
    for case, sets in (("sync", _dist_sets("float32", False, "smoke-dist-sync")),
                       ("local", _dist_sets("bfloat16", True, "smoke-dist-local", dcp=True))):
        r = _dist_run(sets, dev)
        out.update({f"{case}/{k}": v for k, v in r.pop("states").items()})
        out[f"{case}/record"] = json.dumps(r)
    cfg = apply_overrides(Config(), ["TPU.COMPUTE_DTYPE=bfloat16"])
    apply_fn = make_generator_apply(cfg, load_params_npz(os.path.join(work, "g.npz")),
                                    device=dev)
    tiled = TiledApplier(apply_fn, 4, halo=generator_halo(), mesh=make_mesh(cfg))
    t0 = time.perf_counter()
    out["tiled"] = tiled(np.load(os.path.join(work, "frame.npy")))
    out["tiled_seconds"] = np.array(time.perf_counter() - t0)
    np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()
    return 0


def _run_procs(cmds: list[tuple[list[str], dict, str]], timeout: float) -> list[tuple]:
    """Start one Python process per (args, env, cwd), stdout and stderr to
    temporary files, and wait for all within `timeout` s. When one fails
    or time runs out the rest are killed, so that a failed rank fails the
    phase at once. Returns (returncode, stdout, stderr) per process."""
    procs, files = [], []
    for i, (args, env, cwd) in enumerate(cmds):
        out, err = (tempfile.TemporaryFile("w+") for _ in range(2))
        files.append((out, err))
        procs.append(subprocess.Popen([sys.executable, *args], env={**os.environ, **env},
                                      cwd=cwd, stdout=out, stderr=err, text=True))
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if time.monotonic() > deadline or any(p.returncode for p in procs):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    results = []
    for p, (out, err) in zip(procs, files):
        out.seek(0)
        err.seek(0)
        results.append((p.returncode, out.read(), err.read()))
        out.close()
        err.close()
    return results


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_dist(dev) -> dict:
    """Two gloo ranks on cuda:0 through warmup() / train(): (a) sync-BN (f32,
    the unfused trunk, as the trunk gate requires) against one process on
    the global batch; (b) LOCAL_BN (bf16, the packed trunk): K4 and K5 once
    per rank per G step, kernel A once per G forward, running statistics
    bit-identical across the ranks; (c) a one-rank NCCL group through
    train's entry point; (d) the tiled eval of a 960x540 frame over the two
    ranks, bit for bit the one-rank output. Two ranks share one card: their
    step times are no scaling number."""
    from srgan_st_tpu_torch.core.config import Config, apply_overrides
    from srgan_st_tpu_torch.eval.tiled import TiledApplier, generator_halo
    from srgan_st_tpu_torch.eval.validate import make_generator_apply
    from srgan_st_tpu_torch.models.generator import random_variables
    from srgan_st_tpu_torch.train.checkpoint import load_params_npz, save_variables_npz

    rec, bad = {}, []
    lr = _train_config("packed", "x").SOLVER.G_BASE_LR
    with tempfile.TemporaryDirectory() as work:
        cfg = apply_overrides(Config(), ["TPU.COMPUTE_DTYPE=bfloat16"])
        save_variables_npz(os.path.join(work, "g.npz"), random_variables(0))
        frame = np.random.default_rng(3).random((1, *LR_4K, 3), np.float32)
        np.save(os.path.join(work, "frame.npy"), frame)
        # the ranks share one working directory, as processes of a run share
        # a file system (the coordinator writes, every rank may resume); the
        # one-rank NCCL group (c) runs beside them, through train's
        # command-line entry
        port, cmds, shared = _free_port(), [], tempfile.mkdtemp(dir=work)
        for rank in range(2):
            cmds.append((["-c", f"import sys; sys.path.insert(0, {HERE!r}); import chip_smoke; "
                                f"sys.exit(chip_smoke._dist_child({work!r}, 'cuda:0'))"],
                         {"SRGAN_ST_COORDINATOR": f"127.0.0.1:{port}",
                          "SRGAN_ST_NUM_PROCESSES": "2", "SRGAN_ST_PROCESS_ID": str(rank),
                          # half the cores each: spinning threads of a rank that
                          # waits in a collective starve the other rank's host ops
                          "OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 2) // 2))},
                         shared))
        code = ("import sys; from srgan_st_tpu_torch.train.train import cli; "
                "cli(sys.argv[1:]); import torch.distributed as d; "
                "print('BACKEND', d.get_backend(), d.get_world_size()); "
                "import chip_smoke; chip_smoke._nccl_ckpt(sys.argv[1:])")
        argv = ["-c", code, "--device", "cuda"]
        for item in _dist_sets("bfloat16", False, "smoke-nccl", graphs=True, dcp=True):
            argv += ["--set", item]
        nccl_dir = tempfile.mkdtemp(dir=work)
        cmds.append((argv, {"SRGAN_ST_COORDINATOR": f"127.0.0.1:{_free_port()}",
                            "SRGAN_ST_NUM_PROCESSES": "1", "SRGAN_ST_PROCESS_ID": "0",
                            "PYTHONPATH": HERE}, nccl_dir))
        t0 = time.perf_counter()
        results = _run_procs(cmds, 600)
        rec["processes_seconds"] = time.perf_counter() - t0
        rc, out, err = results[2] if len(results) > 2 else (None, "", "")
        ckpt_lines = [ln for ln in out.splitlines() if ln.startswith("CKPT ")]
        nccl = {"rc": rc, "backend_line": [ln for ln in out.splitlines()
                                           if ln.startswith("BACKEND")],
                "ckpt": json.loads(ckpt_lines[0][5:]) if ckpt_lines else None,
                "results_files": sorted(os.listdir(os.path.join(nccl_dir, "results",
                                                                "smoke-nccl")))
                if rc == 0 else [], "stderr": err[-2000:] if rc else ""}
        if [r[0] for r in results] != [0, 0, 0]:
            raise AssertionError(f"dist: a process failed: {[(r[0], r[2][-3000:]) for r in results]}")
        ranks = [dict(np.load(os.path.join(work, f"rank{r}.npz"))) for r in range(2)]
        # the one-rank runs of the same steps, in this process
        one = {}
        for case, sets in (("sync", _dist_sets("float32", False, "smoke-dist-sync")),
                           ("local", _dist_sets("bfloat16", True, "smoke-dist-local", dcp=True))):
            cwd = os.getcwd()
            os.chdir(tempfile.mkdtemp(dir=work))
            try:
                one[case] = _dist_run(sets, dev)
            finally:
                os.chdir(cwd)
        tiled1 = TiledApplier(make_generator_apply(cfg, load_params_npz(
            os.path.join(work, "g.npz")), device=dev), 4, halo=generator_halo())(frame)
    # (a) sync-BN against one process
    sync = [json.loads(str(r["sync/record"])) for r in ranks]
    keys = [k[5:] for k in ranks[0] if k.startswith("sync/") and k != "sync/record"]
    ref = one["sync"]
    loss_rel = max(abs(a - b) / abs(b) for kind in ("G", "D")
                   for a, b in zip(sync[0]["losses"][kind], ref["losses"][kind]))
    params = [k for k in keys if "running" not in k]
    running = [k for k in keys if "running" in k]
    # Adam moves a weight by at most ~1.004 lr an update (b1 0.9, b2 0.999,
    # up to 3 updates), either way: 2.01 lr per update bounds two runs
    updates = {"w": DIST_STEPS, "g": DIST_STEPS, "d": -(-DIST_STEPS // 2)}
    diffs = {m: max(float(np.abs(ranks[0]["sync/" + k] - ref["states"][k]).max())
                    for k in params if k.startswith(m + "/")) for m in updates}
    a = {"loss_rel_diff": loss_rel,
         "losses_logged": {k: len(v) for k, v in sync[0]["losses"].items()},
         "param_max_diff": diffs,
         "param_bound": {m: 2.01 * n * lr for m, n in updates.items()},
         "running_max_rel_diff": max(
             float(np.abs(ranks[0]["sync/" + k] - ref["states"][k]).max()
                   / max(np.abs(ref["states"][k]).max(), 1e-30)) for k in running),
         "ranks_bit_identical": all(np.array_equal(ranks[0]["sync/" + k], ranks[1]["sync/" + k])
                                    for k in keys),
         "ms_per_gan_step_per_rank": [s["ms_per_gan_step"] for s in sync],
         "ms_per_gan_step_one_rank": ref["ms_per_gan_step"]}
    if not (loss_rel <= 1e-2 and all(diffs[m] <= a["param_bound"][m] for m in updates)
            and a["running_max_rel_diff"] <= 1e-3 and a["ranks_bit_identical"]
            and a["losses_logged"] == {"G": 2 * DIST_STEPS, "D": DIST_STEPS}):
        bad.append(f"sync-BN {a}")
    # (b) LOCAL_BN: the kernel trunk per rank
    local = [json.loads(str(r["local/record"])) for r in ranks]
    lkeys = [k[6:] for k in ranks[0] if k.startswith("local/") and k != "local/record"]
    g_steps = 2 * DIST_STEPS  # warmup's and train's
    want = [{"packed_trunk_fwd": g_steps, "packed_trunk_bwd": g_steps,
             "coarse_conv_s2d": g_steps + (6 if r == 0 else 0), "serving_tail": 0,
             "fused_trunk": 0, "buddy_select": 0, "eval_trunk": 6 if r == 0 else 0,
             "rrdb_dense": 0, "rrdb_hr": 0, "rrdb_trunk": 0,
             "swin_attn": 0, "swin_trunk": 0, "window_attn": 0}
            for r in range(2)]
    b = {"launches_per_rank": [s["launches"] for s in local], "launches_expected": want,
         "launches_one_rank": one["local"]["launches"],
         "running_bit_identical": all(np.array_equal(ranks[0]["local/" + k],
                                                     ranks[1]["local/" + k])
                                      for k in lkeys if "running" in k),
         "params_bit_identical": all(np.array_equal(ranks[0]["local/" + k],
                                                    ranks[1]["local/" + k])
                                     for k in lkeys if "running" not in k),
         "finite": all(np.isfinite(ranks[0]["local/" + k]).all() for k in lkeys),
         "ms_per_gan_step_per_rank": [s["ms_per_gan_step"] for s in local],
         "ms_per_gan_step_one_rank": one["local"]["ms_per_gan_step"]}
    if not (b["launches_per_rank"] == want and b["running_bit_identical"]
            and b["params_bit_identical"] and b["finite"]):
        bad.append(f"LOCAL_BN {b}")
    # (e) EXP.ORBAX_CHECKPOINTS in the LOCAL_BN run: collective DCP saves and
    # restores on both gloo ranks, a single-process one in the one-rank run
    e = {"per_rank": [s["ckpt"] for s in local], "one_rank": one["local"]["ckpt"]}
    if not (all(c["ok"] and c["train_last"]["collective"] for c in e["per_rank"])
            and e["one_rank"]["ok"] and not e["one_rank"]["train_last"]["collective"]):
        bad.append(f"DCP checkpoints {e}")
    # (d) tiled eval
    d = {"shape": list(tiled1.shape), "rank_outputs_equal_one_rank": [
        bool(np.array_equal(r["tiled"], tiled1)) for r in ranks],
        "seconds_per_rank": [float(r["tiled_seconds"]) for r in ranks]}
    if not all(d["rank_outputs_equal_one_rank"]):
        bad.append(f"tiled {d}")
    if not (rc == 0 and nccl["backend_line"] == ["BACKEND nccl 1"]
            and "g_last.npz" in nccl["results_files"] and "last" in nccl["results_files"]
            and nccl["ckpt"] is not None and nccl["ckpt"]["ok"]):
        bad.append(f"nccl {nccl}")
    rec.update(note="two ranks share one card: no scaling number", sync_bn=a,
               local_bn=b, nccl_one_rank=nccl, tiled=d, dcp_checkpoints=e)
    emit("dist", **rec)
    if bad:
        raise AssertionError(f"dist phase: {bad}")
    return rec


# ---------------------------------------------------------------------------
# crash safety: the kill/resume soak, and the loss-sensitivity study

# the soak at a cut size (tools/soak.py's full size: 12,800 patches, 10 + 10
# epochs, the kills in epoch 5); the width is never cut
SOAK = {"patches": 1600, "warmup_epochs": 2, "epochs": 4, "kill_epoch": 3}


def phase_soak() -> dict:
    """srgan_st_tpu_torch.tools.soak at SOAK's size: warmup(), the
    uninterrupted GAN run, the `.state.pt` run SIGKILLed mid-epoch and the
    DCP run SIGKILLed mid-save of `last`, each relaunched (tools/soak.py
    names the checks). Each child is its own process, reusing the kernels
    the build phase made. Fails unless every check held."""
    import torch

    from srgan_st_tpu_torch.tools.soak import run_soak

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as root:
        rep = run_soak(root, **SOAK, device="cuda", child_timeout=600)

    def child(c):
        return {k: c[k] for k in ("rc", "killed", "seconds", "seconds_to_first_epoch",
                                  "resumed_at", "epoch_started", "launches")}

    rec = {**SOAK, "seconds": rep["seconds"],
           "failures": rep["failures"], "warmup": child(rep["warmup"])}
    if "reference" in rep:
        rec["reference"] = child(rep["reference"]["child"])
    for case in ("state_pt", "dcp"):
        if case in rep:
            c = rep[case]
            rec[case] = {k: c.get(k) for k in (
                "killed_in_epoch", "mid_epoch", "attempts", "resumed_at",
                "expected_resume_epoch", "psnr_epochs", "best_psnr", "final_max_abs_diff",
                "seconds_to_resume", "resumed_patches_per_s")}
            rec[case]["children"] = [child(x) for x in c.get("children", [])]
    children = [rec["warmup"]] + [x for case in ("reference", "state_pt", "dcp")
                                  for x in ([rec[case]] if case == "reference"
                                            else rec.get(case, {}).get("children", []))]
    rec["launches_per_child"] = [x["launches"] for x in children]
    emit("soak", **rec)
    if rep["failures"]:
        raise AssertionError(f"soak phase: {rep['failures']}")
    return rec


def phase_loss_study(dev) -> dict:
    """tools/loss_study.py's table (4 perturbations x 5 losses x 6 strengths
    of the synthetic 96x96 patch) on the card and on the CPU, every buddy
    selection's picks recorded. Gate: each value within 1e-4 of its curve's
    largest value (the figure normalizes each curve) of the CPU's, 2e-4 for
    PatchwiseST (its det-normalized structure tensors amplify f32 rounding:
    the parity rule of tests/test_torch_losses.py against JAX), or a buddy
    loss whose picks differ from the CPU's only at near ties (both rows
    within 1e-6 of the f64 minimum on the CPU's features); K7 once per
    buddy loss call on the card. The calls whose picks differ are listed."""
    from srgan_st_tpu_torch.kernels import launch_counts, reset_launch_counts
    from srgan_st_tpu_torch.kernels._checks import f64_scores, near_tie_agrees
    from srgan_st_tpu_torch.losses import functions as F
    from srgan_st_tpu_torch.tools import loss_study as L

    real, picks = F.buddy_select_index, {}

    def recorder(dest):
        def select(p1, p2, bank, alpha=1.0, beta=1.0, dist_norm="l2"):
            idx = real(p1, p2, bank, alpha, beta, dist_norm)
            dest.append((p1.cpu(), p2.cpu(), bank.cpu(), idx.cpu(), alpha, beta, dist_norm))
            return idx
        return select

    gt = L.synthetic_patch()
    tables = {}
    try:
        for name, device in (("cpu", "cpu"), ("cuda", dev)):
            picks[name] = []
            F.buddy_select_index = recorder(picks[name])
            reset_launch_counts()
            t0 = time.perf_counter()
            tables[name] = L.loss_table(gt, L.STRENGTHS, np.random.default_rng(0), device)
            seconds = time.perf_counter() - t0
            counts = launch_counts()
    finally:
        F.buddy_select_index = real
    ties, bad, worst, differ = [], [], {}, []
    calls = iter(zip(picks["cpu"], picks["cuda"]))
    for pname, rows in tables["cpu"].items():
        for lname, values in rows.items():
            scale = max(abs(v) for v in values)
            tol = 2e-4 if lname == "PatchwiseST" else 1e-4
            for i, v in enumerate(values):
                pair = next(calls) if lname in ("BestBuddy", "Gram", "PatchwiseST") else None
                rows_differ = 0
                if pair is not None:
                    (p1, p2, bank, idx, alpha, beta, norm), gpu = pair
                    rows_differ = int((idx != gpu[3]).sum())
                    if rows_differ:
                        differ.append((pname, lname, L.STRENGTHS[i], rows_differ))
                err = abs(tables["cuda"][pname][lname][i] - v) / max(scale, 1e-30)
                worst[lname] = max(worst.get(lname, 0.0), err)
                if err <= tol:
                    continue
                tie = False
                if rows_differ:
                    f64 = f64_scores(p1, p2, bank, alpha, beta, norm)
                    tie = bool(near_tie_agrees(gpu[3], idx, f64).all()
                               and near_tie_agrees(idx, gpu[3], f64).all())
                (ties if tie else bad).append((pname, lname, L.STRENGTHS[i], err))
    buddy_calls = len(picks["cuda"])
    rec = {"entries": sum(len(v) for r in tables["cpu"].values() for v in r.values()),
           "max_err_of_curve_scale": worst, "near_ties": ties, "outside": bad,
           "calls_whose_picks_differ": differ, "buddy_calls": buddy_calls,
           "launches": counts, "cuda_seconds": seconds}
    emit("loss_study", **rec)
    if bad or counts["buddy_select"] != buddy_calls or buddy_calls != 72:
        raise AssertionError(f"loss_study phase: {rec}")
    return rec


# ---------------------------------------------------------------------------
# the structure-tensor loss study (run, job 1)

RUN_STEPS = 3  # batches per epoch of main.py's job 1 in the run phase
BUDDY_SEEDS = 10  # more seeded batches K7's gate (a) is swept over
RUN_NAME = "patchwise-st-disc"  # job 1's experiment


def _buddy_features(batch, dtype, kind):
    """p1, p2 and the bank of the PatchwiseST ("pst") or Gram ("gram") loss
    on the GT batch and a noisy copy as sr, by the loss module's own
    feature functions in `dtype`, as the bf16 step computes them."""
    import torch

    from srgan_st_tpu_torch.losses import functions as LF

    gt = batch.float() / 255.0
    noise = torch.randn(gt.shape, device=gt.device,
                        generator=torch.Generator(device=gt.device).manual_seed(1))
    sr, gt = (gt + 0.05 * noise).clamp(0, 1).to(dtype), gt.to(dtype)
    feat = ((lambda x: LF._st_patches(x, 0.5, 2.0, 3)) if kind == "pst"
            else (lambda x: LF._gram_patches(x, 3)))
    with torch.no_grad():
        return feat(sr), feat(gt), LF._bank(gt, feat)


def _buddy_case(name, p1, p2, bank, dist_norm="l2", dup_half=None, exact=False) -> dict:
    """Gates (a) and (c), and (b) when the bank's second half copies the
    first (dup_half): no index in the copy, and each row without a near
    tie the f64 argmin, or with `exact` every row the f64 first-occurrence
    argmin; returns the case's record."""
    import torch

    from srgan_st_tpu_torch.kernels import _checks
    from srgan_st_tpu_torch.kernels import buddy_select as bs

    idx = bs._launch(p1, p2, bank, 1.0, 1.0, dist_norm)
    ref = bs.buddy_select_reference(p1, p2, bank, dist_norm=dist_norm)
    torch.cuda.synchronize()
    scores = _checks.f64_scores(p1, p2, bank, dist_norm=dist_norm)
    pick = lambda i: torch.gather(scores, 2, i.long()[..., None])[..., 0]  # noqa: E731
    sel = bs.gather_rows(bank, idx)
    rec = {"case": name, "dtype": str(p1.dtype).split(".")[-1], "p": list(p1.shape),
           "bank": list(bank.shape), "dist_norm": dist_norm,
           "variant": bs.last_variant,
           "index_agreement": float((idx == ref).float().mean()),
           "max_abs_err": float((pick(idx) - pick(ref)).abs().max()),
           "gate_a": bool(_checks.near_tie_agrees(idx, ref, scores).all()),
           "gate_c": bool(torch.equal(sel, torch.gather(
               bank, 1, idx.long()[..., None].expand(-1, -1, bank.shape[-1]))))}
    if dup_half is not None:
        rec["gate_b"] = _checks.first_occurrence_holds(idx, scores, dup_half)
        if exact:
            rec["gate_b"] = rec["gate_b"] and torch.equal(
                idx.cpu().long(), torch.argmin(scores.cpu(), dim=2))
    emit("kernel", kernel="buddy_select", **rec)
    if not (rec["gate_a"] and rec["gate_c"] and rec.get("gate_b", True)):
        raise AssertionError(f"buddy_select {name}: a gate failed: {rec}")
    return rec


def phase_kernel_buddy(dev, batch) -> dict:
    """K7 against its plain version at the path's shapes; times at the
    PatchwiseST shape in bf16."""
    import torch

    from srgan_st_tpu_torch.kernels import _checks
    from srgan_st_tpu_torch.kernels import buddy_select as bs

    cases = []
    for dt in (torch.bfloat16, torch.float32):
        feats = _buddy_features(batch, dt, "pst")
        cases.append(_buddy_case("patchwise_st", *feats))
        if dt == torch.bfloat16:
            timed = feats
        cases.append(_buddy_case("gram", *_buddy_features(batch, dt, "gram")))
    p1, p2, bank = timed
    cases.append(_buddy_case("edge", p1[:3, :97].contiguous(), p2[:3, :97].contiguous(),
                             bank[:3, :131].contiguous()))
    b, n, d = p1.shape
    m = bank.shape[1]
    # duplicate-heavy banks (a 1/255 grid, the second half a copy of the
    # first): at the path's shape, and at the JAX package's first-occurrence
    # test (tests/test_kernels.py: its shape, seed and draws), where no f64
    # near tie occurs and the indices must equal the f64 argmin exactly
    for case, seed, (bb, nn, mm), exact in (("duplicate_heavy", 2, (b, n, m), False),
                                            ("duplicate_heavy_exact", 0, (2, 40, 70), True)):
        for dt in (torch.bfloat16, torch.float32):
            rng = np.random.default_rng(seed)
            q1, q2, dup = (np.round(rng.standard_normal((bb, k, d)) * 32).astype(np.float32) / 255
                           for k in (nn, nn, mm))
            dup[:, mm // 2:] = dup[:, : mm - mm // 2]
            q1, q2, dup = (torch.from_numpy(a).to(dev, dt) for a in (q1, q2, dup))
            cases.append(_buddy_case(case, q1, q2, dup, dup_half=mm // 2, exact=exact))
    # near ties that the f32 expansion's rounding orders (kernels/_checks.py
    # near_tie_bank) at the path's shape: the refine, in the kernel and the
    # plain version alike, gives every row its f64-best bank row, so the two
    # agree index for index
    for dt in (torch.bfloat16, torch.float32):
        q1, q2, nb, best = _checks.near_tie_bank(np.random.default_rng(7), b, n // 2, d, dt)
        rec = _buddy_case("near_tie", *(t.to(dev) for t in (q1, q2, nb)))
        rec["exact_argmin"] = torch.equal(
            bs._launch(*(t.to(dev) for t in (q1, q2, nb)), 1.0, 1.0, "l2").cpu().long(), best)
        emit("kernel", kernel="buddy_select", case="near_tie", exact_argmin=rec["exact_argmin"],
             index_agreement=rec["index_agreement"])
        if not (rec["exact_argmin"] and rec["index_agreement"] == 1.0):
            raise AssertionError(f"buddy_select near_tie {dt}: not the f64-best rows, or "
                                 f"not the plain version's: {rec}")
        cases.append(rec)
    cases.append(_buddy_case("l1", p1[:2, :100].contiguous(), p2[:2, :100].contiguous(),
                             bank[:2, :150].contiguous(), dist_norm="l1"))
    # gate (a) over BUDDY_SEEDS more seeded batches of PatchwiseST features,
    # bf16 and f32; beside it, how often the f32 expansion alone (the order
    # that the kernels and the plain version refine, and the JAX kernel's)
    # misses the f64 best by more than the gate's rtol: the near ties the
    # refine is for
    sweep = {}
    for dt in (torch.bfloat16, torch.float32):
        fails = expansion_off = disagree = 0
        for seed in range(1, BUDDY_SEEDS + 1):
            gt = torch.from_numpy(np.random.default_rng(seed).integers(
                0, 256, tuple(batch.shape), dtype=np.uint8)).to(dev)
            q1, q2, qb = _buddy_features(gt, dt, "pst")
            idx = bs._launch(q1, q2, qb, 1.0, 1.0, "l2")
            ref = bs.buddy_select_reference(q1, q2, qb)
            scores = _checks.f64_scores(q1, q2, qb)
            fails += int((~_checks.near_tie_agrees(idx, ref, scores)).sum())
            best = scores.min(-1).values
            expansion = torch.argmin(bs.expansion_scores(q1, q2, qb), dim=2)
            chosen = torch.gather(scores, 2, expansion[..., None])[..., 0]
            expansion_off += int((chosen - best > 1e-6 * best.abs().clamp(min=1e-30)).sum())
            disagree += int((idx != ref).sum())
            del q1, q2, qb, scores
        sweep[str(dt).split(".")[-1]] = {"rows": BUDDY_SEEDS * batch.shape[0] * 1024,
                                         "gate_a_failures": fails, "disagree_with_plain": disagree,
                                         "expansion_beyond_rtol_of_f64_best": expansion_off}
    emit("kernel", kernel="buddy_select", case="seed_sweep", seeds=BUDDY_SEEDS, **sweep)
    if any(v["gate_a_failures"] for v in sweep.values()):
        raise AssertionError(f"buddy_select seed sweep: gate (a) failed: {sweep}")

    # the SIMT kernel on the same bf16 l2 inputs (the tensor-core kernel's
    # predecessor, which the port sends only f32 and l1): its C entry
    import ctypes

    from srgan_st_tpu_torch.kernels import _build

    simt_fn = _build.load("buddy_select", bs._SIGNATURES).buddy_select_bf16
    simt_idx = torch.empty(p1.shape[:2], device=dev, dtype=torch.int32)

    def simt():
        err = simt_fn(p1.data_ptr(), p2.data_ptr(), bank.data_ptr(), simt_idx.data_ptr(),
                      *p1.shape[:2], bank.shape[1], p1.shape[2], ctypes.c_float(1.0),
                      ctypes.c_float(1.0), 0, torch.cuda.current_stream().cuda_stream)
        _build.check(err, "buddy_select simt")

    def library():  # two baddbmm + argmin: the plain version without its refine
        q1, q2, bf = p1.float(), p2.float(), bank.float()
        bt, bn = bf.transpose(1, 2), (bf * bf).sum(2)[:, None, :]
        s1 = torch.baddbmm((q1 * q1).sum(2)[:, :, None] + bn, q1, bt, alpha=-2.0).clamp_(min=0)
        s2 = torch.baddbmm((q2 * q2).sum(2)[:, :, None] + bn, q2, bt, alpha=-2.0).clamp_(min=0)
        return torch.argmin(s1 + s2, dim=2)

    nbytes = (p1.numel() + p2.numel() + bank.numel()) * p1.element_size() + b * n * 4
    flops = 4 * d * b * n * m  # two d-wide dots per (n, m) pair
    rec = {"kernel": "buddy_select", "shape": [list(p1.shape), list(bank.shape)],
           "dtype": "bfloat16",
           "ms": cuda_ms(lambda: bs._launch(p1, p2, bank, 1.0, 1.0, "l2")),
           "variant": bs.last_variant, "simt_ms": cuda_ms(simt),
           # device time: one call of the wrapper is shorter on the device
           # than on the host, which `ms` (events around one call) measures
           "device_ms": device_ms(lambda: bs._launch(p1, p2, bank, 1.0, 1.0, "l2")),
           "simt_device_ms": device_ms(simt), "library_device_ms": device_ms(library),
           "plain_ms": cuda_ms(lambda: bs.buddy_select_reference(p1, p2, bank)),
           "library_ms": cuda_ms(library), "bytes": nbytes, "flops": flops,
           "max_abs_err": max(c["max_abs_err"] for c in cases),
           "gated_cases": [c["case"] + "/" + c["dtype"] for c in cases]}
    # bf16 x bf16 products are exact in f32, so the function's bound is the
    # bf16 tensor-core peak (the kernel's SIMT f32 FMAs are its own choice)
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops)
    emit("kernel_time", **rec)
    return rec


FWD_NAMES = ("y", "xs", "a1s", "a2s", "stats")


def _trunk_fwd_bytes(n, b, h, w, c) -> int:
    """bf16: read x and the weights, write y, the three residuals, stats."""
    act, weights = b * h * w * c, 2 * n * 9 * c * c
    return 2 * act + 2 * weights + 2 * act + 3 * 2 * n * act + 4 * n * 4 * c


def _cudnn_inputs(xb, p):
    """The cuDNN yardstick's operands: OIHW bf16 convs, bf16 slopes."""
    lib = [t.detach().clone() for t in p]
    lib[0], lib[1] = (w.bfloat16().permute(0, 4, 3, 1, 2).contiguous() for w in lib[:2])
    lib[6] = lib[6].bfloat16()
    return lib


def _probed_syncs(x, p, weights=None):
    """One K6 launch with its probe: (the grid barriers each block passed,
    the probe)."""
    import torch

    from srgan_st_tpu_torch.kernels import fused_trunk as ft

    probe = torch.zeros(ft.probe_words(x.shape, p[0].shape[0]), dtype=torch.int64,
                        device=x.device)
    ft._launch_fwd(x, *p, EPS, weights=weights, probe=probe)
    torch.cuda.synchronize()
    return ft.probe_syncs(probe), probe


def _fused_phases(xb, p, wf) -> dict:
    """Where one bf16 K6 launch spends a conv, from its probe (each block's
    %globaltimer stamps): per conv after the first, the mean over blocks of
    the tiles (first tile's start to last epilogue's end), the barrier (to
    its release, the wait for the slowest block included) and the moments
    (sums, and the next BatchNorm's gamma and beta into shared memory), the
    slowest block's tiles, and the period between the convs' ends; the call
    from the first stamp to the last; the barriers the launch counted."""
    from srgan_st_tpu_torch.kernels import fused_trunk as ft

    n = p[0].shape[0]
    syncs, probe = _probed_syncs(xb, p, wf)
    st = probe[1:1 + ft.last_grid * 2 * n * 4].view(ft.last_grid, 2 * n, 4).double() / 1e3
    tile, barrier, moments = (st[:, 1:, i + 1] - st[:, 1:, i] for i in range(3))
    ends = st[:, :, 3].max(0).values
    return {"tiles": float(tile.mean()), "tiles_slowest_block": float(tile.max(0).values.mean()),
            "barrier": float(barrier.mean()), "moments": float(moments.mean()),
            "conv_period": float((ends[-1] - ends[0]) / (2 * n - 1)),
            "call": float(st[:, :, 3].max() - st[:, :, 0].min()), "grid_syncs": syncs}


def phase_kernel_fused(gen, dev) -> dict:
    """K6 against its plain version at TRUNK_SHAPES, the K4 forward gates:
    f32 (TF32 off) y, residuals and stats within 1e-4 max|ref|, bf16 within
    2x the plain version's envelope, the same bits on a second run; and in
    bf16, the five outputs equal to K4's on the same inputs bit for bit
    (K6 runs K4's tile and sums K4's partials in K4's order). Times at the
    training shape: K6's wrapper and its launch on laid-out weights beside
    K4's wrapper and launch, the cuDNN trunk's, a profile of one K6 launch
    and where its convs spend their time (its probe)."""
    import torch

    from srgan_st_tpu_torch.kernels import fused_trunk as ft
    from srgan_st_tpu_torch.kernels import packed_trunk as pt

    rec = {"errors": []}
    for shape, n in TRUNK_SHAPES:
        x, p, _ = _trunk_inputs(gen, dev, shape, n)
        got = ft._launch_fwd(x, *p, EPS)
        grid = ft.last_grid
        ref = ft.fused_trunk_reference(x, *p, EPS)
        f32 = {k: _rel(a, b) for k, a, b in zip(FWD_NAMES, got, ref)}
        xb = x.bfloat16()
        p16 = [p[0].bfloat16().float(), p[1].bfloat16().float(), *p[2:]]
        got16 = ft._launch_fwd(xb, *p, EPS)
        plain16 = ft.fused_trunk_reference(xb, *p, EPS)
        ref32 = ft.fused_trunk_reference(xb.float(), *p16, EPS)
        bf16 = {k: (max_abs(a, r), max_abs(b, r))
                for k, a, b, r in zip(FWD_NAMES, got16, plain16, ref32)}
        grid16 = ft.last_grid
        same = {"f32": all(torch.equal(a, b) for a, b in zip(got, ft._launch_fwd(x, *p, EPS))),
                "bf16": all(torch.equal(a, b)
                            for a, b in zip(got16, ft._launch_fwd(xb, *p, EPS)))}
        k4_bits = {k: torch.equal(a, b)
                   for k, a, b in zip(FWD_NAMES, got16, pt._launch_fwd(xb, *p, EPS))}
        # the barriers each block passed, counted by a probed launch
        syncs = {"f32": _probed_syncs(x, p)[0], "bf16": _probed_syncs(xb, p)[0]}
        r = {"shape": list(shape), "n": n, "grid_blocks": {"f32": grid, "bf16": grid16},
             "grid_syncs_per_call": syncs,
             "f32_rel_err": f32, "bf16_err_and_envelope": bf16, "bitwise_repeatable": same,
             "bf16_equals_k4": k4_bits}
        emit("kernel", kernel="fused_trunk", **r)
        bad = ([k for k, e in f32.items() if not e <= 1e-4]
               + [k for k, (e, env) in bf16.items() if not (env > 0 and e <= 2 * env)]
               + [k for k, ok in same.items() if not ok]
               + [f"{k} != K4" for k, ok in k4_bits.items() if not ok])
        if not 0 < syncs["bf16"] <= 2 * n:
            bad.append(f"bf16 grid syncs {syncs['bf16']}, not in 1..2n")
        if bad:
            raise AssertionError(f"fused_trunk at {shape}, n={n}: {bad} out of bounds")
        rec["errors"].append({"shape": list(shape), "f32_rel": f32, "bf16": bf16,
                              "bf16_equals_k4": k4_bits})
        if shape == TRUNK_SHAPES[0][0]:
            timed = (xb, p)
        del got, ref, got16, plain16, ref32
    xb, p = timed
    n, (b, h, w, c) = p[0].shape[0], xb.shape
    lib = _cudnn_inputs(xb, p)
    nbytes, flops = _trunk_fwd_bytes(n, b, h, w, c), 2 * n * 2 * b * h * w * 9 * c * c
    # `ms`: the wrapper, which lays the weights out on every call as a train
    # step does; `launch_ms`: the launch on weights laid out in advance;
    # K4's two the same way, in turns with K6's
    wf = pt._layout_fwd(p[0], p[1], xb.device, xb.dtype)
    k6_wrap = lambda: ft._launch_fwd(xb, *p, EPS)  # noqa: E731
    k6_launch = lambda: ft._launch_fwd(xb, *p, EPS, weights=wf)  # noqa: E731
    k4_wrap = lambda: pt._launch_fwd(xb, *p, EPS)  # noqa: E731
    k4_launch = lambda: pt._launch_fwd(xb, *p, EPS, weights=wf)  # noqa: E731
    turns = {"k6_launch": [], "k4_launch": [], "k6_wrapper": [], "k4_wrapper": []}
    for _ in range(2):
        for key, fn in (("k4_launch", k4_launch), ("k6_launch", k6_launch),
                        ("k6_wrapper", k6_wrap), ("k4_wrapper", k4_wrap)):
            turns[key].append(cuda_ms(fn))
    rec.update(shape=[b, h, w, c], n=n, ms=float(np.median(turns["k6_wrapper"])),
               launch_ms=float(np.median(turns["k6_launch"])),
               packed_fwd_ms=float(np.median(turns["k4_wrapper"])),
               packed_fwd_launch_ms=float(np.median(turns["k4_launch"])), turns_ms=turns,
               plain_ms=cuda_ms(lambda: ft.fused_trunk_reference(xb, *p, EPS), iters=5),
               library_ms=cuda_ms(lambda: _cudnn_trunk(xb, lib)), bytes=nbytes, flops=flops,
               grid_blocks=ft.last_grid,
               profile=profile_once(k6_launch, 5), phases_us=_fused_phases(xb, p, wf),
               device_ms=device_ms(k6_launch), packed_fwd_device_ms=device_ms(k4_launch))
    rec["grid_syncs_per_call"] = rec["phases_us"].pop("grid_syncs")
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops)
    emit("kernel_time", kernel="fused_trunk", **{k: v for k, v in rec.items() if k != "errors"})
    return rec


def write_vgg_npz(path: str, seed: int = 0) -> str:
    """A seeded random VGG19 in tools/convert_vgg19.py's npz format (HWIO
    kernels under torchvision's features.{i} keys, He-normal in scale):
    ContentVGG's weights for the smoke run (speed does not depend on their
    values; the ImageNet weights are not in the repository)."""
    from srgan_st_tpu_torch.models.vgg import expected_torch_shapes

    rng = np.random.default_rng(seed)
    arrs = {}
    for key, shape in expected_torch_shapes().items():
        if key.endswith(".weight"):
            o, i, kh, kw = shape
            arrs[key] = (rng.standard_normal((kh, kw, i, o), np.float32)
                         * np.float32(np.sqrt(2 / (9 * i))))
        else:
            arrs[key] = np.zeros(shape, np.float32)
    np.savez(path, **arrs)
    return path


def _run_sets(trunk: str, vgg: str) -> list[str]:
    return ["TPU.COMPUTE_DTYPE=bfloat16", f"TPU.TRUNK_MODE={trunk}", "DATA.SYNTHETIC=true",
            f"DATA.SYNTHETIC_N_BATCHES={RUN_STEPS}", "EXP.N_EPOCHS=1",
            "SOLVER.D_UPDATE_INTERVAL=2", "LOG_TRAIN_PERIOD=1",
            f"MODEL.G_LOSS.VGG19_WEIGHTS={vgg}"]


def _run_config(job: int, trunk: str, vgg: str):
    from srgan_st_tpu_torch.core.config import Config, apply_overrides
    from srgan_st_tpu_torch.main import st_experiment

    return apply_overrides(st_experiment(Config(), job), _run_sets(trunk, vgg))


# (job, trunk) of the run phase: job 1 with the fused and the unfused trunk,
# jobs 3 (ST + ContentDiscriminator) and 4 (the pixel baseline) with the
# packed one, then the ContentVGG jobs: 0 (PatchwiseST + ContentVGG) with
# the packed trunk and 2 (ST + ContentVGG) with xpack (K4/K5 in training)
RUNS = ((1, "fused"), (1, "unfused"), (3, "packed"), (4, "packed"), (0, "packed"),
        (2, "xpack"))


def phase_run(dev, vgg: str) -> dict:
    """The main path: `run --job_index j` through main.main (train, then
    test) at full width in a temporary directory for each of RUNS, the
    ContentVGG jobs on the VGG19 npz `vgg`; launch counts reset just before
    each and read just after."""
    import contextlib
    import io

    import torch

    from srgan_st_tpu_torch.kernels import launch_counts, reset_launch_counts
    from srgan_st_tpu_torch.main import VARIANTS
    from srgan_st_tpu_torch.main import main as run_main

    out, cwd = {}, os.getcwd()
    for job, trunk in RUNS:
        name = VARIANTS[job][0]
        argv = ["--job_index", str(job), "--device", "cuda"]
        for item in _run_sets(trunk, vgg):
            argv += ["--set", item]
        log = io.StringIO()
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            try:
                reset_launch_counts()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(log):
                    run_main(argv)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                counts = launch_counts()
                files = sorted(os.listdir(os.path.join("results", name)))
                shots = sorted(os.listdir(os.path.join("results", "_test", name)))
            finally:
                os.chdir(cwd)
        lines = log.getvalue().splitlines()
        # per run: RUN_STEPS G steps (one K7 each in the PatchwiseST jobs 0
        # and 1, one trunk kernel forward each, and K5 under "packed" and
        # "xpack", which is "packed" in training; unfused launches none),
        # RUN_STEPS + 6 G forwards through kernel A (the steps, 3 validation
        # and 3 test pairs), the 6 eval forwards through kernel E where its
        # gate takes the trunk mode
        steps = {"fused": RUN_STEPS if trunk == "fused" else 0,
                 "packed": RUN_STEPS if trunk in ("packed", "xpack") else 0}
        want = {"coarse_conv_s2d": RUN_STEPS + 6, "serving_tail": 0,
                "packed_trunk_fwd": steps["packed"], "packed_trunk_bwd": steps["packed"],
                "fused_trunk": steps["fused"],
                "buddy_select": RUN_STEPS if job in (0, 1) else 0,
                "eval_trunk": 6 if trunk in ("packed", "hybrid", "fused") else 0,
                "rrdb_dense": 0, "rrdb_hr": 0, "rrdb_trunk": 0,
                "swin_attn": 0, "swin_trunk": 0, "window_attn": 0}
        rec = {"job": job, "experiment": name, "trunk": trunk, "seconds": seconds,
               "launches": counts, "launches_expected": want, "results_files": files,
               "test_images": shots,
               "test_line": [ln for ln in lines if ln.startswith("[Test]")][-1:],
               "g_losses": [ln for ln in lines if ln.startswith("[Epoch")]}
        emit("run", **rec)
        if counts != want:
            raise AssertionError(f"run job {job} {trunk}: launches {counts}, expected {want}")
        if not ({"g_best.npz", "g_last.npz", "d_last.npz"} <= set(files)
                and "0.png" in shots and f"Finished job: {job}" in lines
                and rec["test_line"]):
            raise AssertionError(f"run job {job} {trunk}: incomplete: {rec}")
        out[f"{job}/{trunk}"] = rec
    return out


# (job, trunk, against) of the run check: each trunk of a run job against
# the unfused one from the same seeded state
RUN_CHECKS = ((1, "fused", "unfused"), (0, "packed", "unfused"), (2, "xpack", "unfused"))


def phase_check_run(dev, batch, vgg: str) -> dict:
    """One GAN step of each RUN_CHECKS job with each of its two trunks from
    the same seeded state: parameters within 2.01 lr, losses within 1e-2
    relative (the train gates)."""
    from srgan_st_tpu_torch.losses.registry import build_criterions
    from srgan_st_tpu_torch.train.steps import make_gan_steps

    recs = {}
    for job, trunk, against in RUN_CHECKS:
        out = {}
        for t in (trunk, against):
            cfg = _run_config(job, t, vgg)
            state = _gan_state(cfg, dev)
            g_step, d_step = make_gan_steps(cfg, build_criterions(cfg))
            state, sr, gm = g_step(state, batch)
            state, dm = d_step(state, batch, sr)
            out[t] = ({k: float(v) for k, v in {**gm, **dm}.items()},
                      _flat(state.g_model), _flat(state.d_model))
            del state
        lr = cfg.SOLVER.G_BASE_LR
        rec = {"job": job, "trunks": [trunk, against],
               "losses": {t: o[0] for t, o in out.items()},
               "loss_rel_diff": max(abs(v - out[against][0][k]) / abs(out[against][0][k])
                                    for k, v in out[trunk][0].items()
                                    if "Probability" not in k),
               "g_param_max_diff": max_abs(out[trunk][1], out[against][1]),
               "d_param_max_diff": max_abs(out[trunk][2], out[against][2]),
               "param_bound": 2.01 * lr}
        emit("check", run=rec)
        if not (rec["loss_rel_diff"] <= 1e-2 and rec["g_param_max_diff"] <= 2.01 * lr
                and rec["d_param_max_diff"] <= 2.01 * lr):
            raise AssertionError(f"{trunk} vs {against} GAN step of job {job} out of bounds: {rec}")
        recs[f"{job}/{trunk}"] = rec
    return recs


def _step_times(cfg, dev, batch) -> tuple[dict, object, dict]:
    """ms per warmup, G and GAN step of `cfg` on the device batch; returns
    (record, the GAN step closure, its state and criteria)."""
    import torch

    from srgan_st_tpu_torch.losses.registry import build_criterions, build_warmup_criterions
    from srgan_st_tpu_torch.models.generator import Generator
    from srgan_st_tpu_torch.train.steps import (
        create_generator_state, make_gan_steps, make_warmup_step,
    )

    w_state = create_generator_state(cfg, Generator.from_config(cfg), RUN_STEPS, dev,
                                     milestones=False)
    w_step = make_warmup_step(cfg, build_warmup_criterions(cfg))
    state = _gan_state(cfg, dev)
    crits = build_criterions(cfg)
    g_step, d_step = make_gan_steps(cfg, crits)

    def gan():
        _, sr, _ = g_step(state, batch)
        d_step(state, batch, sr)

    torch.cuda.reset_peak_memory_stats()
    warm_ms = cuda_ms(lambda: w_step(w_state, batch))
    g_ms = cuda_ms(lambda: g_step(state, batch))
    gan_ms = cuda_ms(gan)
    b = batch.shape[0]
    rec = {"ms_per_warmup_step": warm_ms, "ms_per_g_step": g_ms, "ms_per_gan_step": gan_ms,
           "patches_per_s_gan_step": b / (gan_ms / 1e3),
           "patches_per_s_d_every_100": b / ((g_ms + (gan_ms - g_ms) / 100) / 1e3),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    return rec, gan, {"state": state, "g_step": g_step, "criterions": crits}


def phase_time_run(dev, batch, vgg: str) -> dict:
    """ms per warmup step, G step and GAN step of job 1 (fused, packed,
    unfused) and job 0 (packed, unfused), the batch already on the
    device; a profile of job 1's fused and job 0's packed GAN step; job 0's
    packed / unfused GAN steps in turns; and ContentVGG's share of job 0's
    device time (the device busy time of its forward and sr backward on the
    step's batch, over that of the packed GAN step)."""
    import torch

    rec, profiles, gans = {}, {}, {}
    for job, trunks in ((1, ("fused", "packed", "unfused")), (0, ("packed", "unfused"))):
        for trunk in trunks:
            r, gan, parts = _step_times(_run_config(job, trunk, vgg), dev, batch)
            rec[f"{job}/{trunk}"] = r
            if (job, trunk) in ((1, "fused"), (0, "packed")):
                profiles[f"{job}/{trunk}"] = profile_once(gan)
            if job == 0 and trunk in ("packed", "unfused"):
                gans[trunk] = gan
            if (job, trunk) == (0, "packed"):
                vgg_fn = parts["criterions"]["ContentVGG"][0]
                _, sr, _ = parts["g_step"](parts["state"], batch)
                gt = batch.float() / 255.0

                def vgg_fwd_bwd():
                    s = sr.clone().requires_grad_()
                    torch.autograd.grad(vgg_fn(s, gt), s)

                profiles["0/ContentVGG"] = profile_once(vgg_fwd_bwd)
            del gan, parts
    times = {"packed": [], "unfused": []}
    for _ in range(TRUNK_PAIRS):
        for trunk in times:
            times[trunk].append(cuda_ms(gans[trunk], iters=1, warmup=0))
    ratios = [a / b for a, b in zip(times["packed"], times["unfused"])]
    rec["0/paired_gan_step"] = {
        "pairs": TRUNK_PAIRS, "packed_ms": times["packed"], "unfused_ms": times["unfused"],
        "ratio_packed_over_unfused": {"median": float(np.median(ratios)),
                                      "min": min(ratios), "max": max(ratios)}}
    busy = profiles["0/packed"]["device_busy_ms"]
    rec["0/content_vgg_share"] = {
        "content_vgg_busy_ms": profiles["0/ContentVGG"]["device_busy_ms"],
        "gan_step_busy_ms": busy,
        "share": profiles["0/ContentVGG"]["device_busy_ms"] / busy if busy else None}
    emit("time", run="job 1 (Adversarial + PatchwiseST + ContentDiscriminator) and job 0 "
         "(Adversarial + PatchwiseST + ContentVGG), batch 16, 96x96 GT, x4, bf16", **rec)
    emit("profile", run="one GAN step of job 1 (fused) and of job 0 (packed); job 0's "
         "ContentVGG forward + sr backward", **profiles)
    return rec


# ---------------------------------------------------------------------------
# the training steps as captured CUDA graphs (train/graphs.py)

GRAPH_STEPS = 6  # steps a case drives eagerly and by graph replays, D on 0, 2, 4
GRAPH_PAIRS = 6  # eager / graph step pairs timed in turns
# (recipe, trunk): the Adversarial recipe with the packed and the unfused
# trunk, run job 1 with the fused trunk, run job 0 with the packed one
GRAPH_CASES = (("adversarial", "packed"), ("adversarial", "unfused"), (1, "fused"),
               (0, "packed"))


def _graph_config(recipe, trunk: str, vgg: str):
    if recipe == "adversarial":
        return _train_config(trunk, "graph")
    return _run_config(recipe, trunk, vgg)


def _train_tensors(state) -> dict:
    """Everything a step updates: G's and D's parameters and running
    statistics, both optimizers' moments, step counts and update counts."""
    out = {}
    for tag, model, opt in (("g", state.g_model, state.g_opt), ("d", state.d_model, state.d_opt)):
        out.update({f"{tag}/{k}": v for k, v in model.state_dict().items()})
        for i, st in enumerate(opt.opt.state.values()):
            out.update({f"{tag}_adam/{i}/{k}": v for k, v in st.items()})
        out[f"{tag}_adam/count"] = opt._count
    return out


def _graph_drive(cfg, dev, batches, graphs, between=None):
    """GRAPH_STEPS GAN steps from the seeded state through the chunk step
    (chunks of 2, D at each chunk's batch 0), eagerly (graphs None) or by
    graph replays; `between(state)` runs after the first two chunks.
    Returns (state, batch-0 metrics per chunk, launch counts, graph launch
    counts)."""
    import torch

    from srgan_st_tpu_torch.kernels import (
        add_launch_counts, graph_launch_counts, launch_counts, reset_launch_counts,
    )
    from srgan_st_tpu_torch.losses.registry import build_criterions
    from srgan_st_tpu_torch.train.steps import make_gan_chunk_step

    state = _gan_state(cfg, dev)
    chunk_step = make_gan_chunk_step(cfg, build_criterions(cfg), graphs=graphs)
    metrics = []
    torch.cuda.synchronize()
    reset_launch_counts()
    for i in range(0, GRAPH_STEPS, 2):
        if i == 4 and between is not None:
            before = launch_counts()
            between(state)
            # the steps' launches only: take back those of `between`
            after = launch_counts()
            add_launch_counts({k: before[k] - after[k] for k in after})
        state, m = chunk_step(state, batches[i:i + 2], True)
        metrics.append(m)
    torch.cuda.synchronize()
    return state, metrics, launch_counts(), graph_launch_counts()


def _bits(a: dict, b: dict) -> tuple[bool, float, list]:
    """(every tensor equal bit for bit, the largest difference of a float
    tensor, the first keys that differ)."""
    import torch

    differ = [k for k in a if not torch.equal(a[k], b[k])]
    worst = max((max_abs(a[k], b[k]) for k in a if a[k].is_floating_point()), default=0.0)
    return not differ, worst, differ[:8]


def phase_graph(dev, batch, vgg: str) -> dict:
    """The steps as CUDA graphs against the same steps run eagerly, from one
    seeded state (cuDNN on deterministic algorithms for the comparison):
    for each GRAPH_CASES case GRAPH_STEPS steps, D on steps 0, 2 and 4,
    eagerly, by replays, and eagerly again (the control: do eager steps
    repeat their bits?). Gates: parameters, running statistics, Adam's
    moments and counts and the metrics equal bit for bit where the eager
    steps repeat their bits (else within 2.01 lr per update, with the
    cause); the launch counts of the graph run equal the eager run's, its
    replays made a launch for every kernel of the path; an eval forward of
    the trained generator and validation after replays equal those after
    eager steps (the weight-layout cache after replays). Then TPU.NAN_GUARD
    warns after a NaN is put into a weight, `doctor --json` reports the
    card healthy, and the records: ms per warmup, G and GAN step eagerly
    and by replays in turns, patches/s, a profile of each GAN step, each
    graph's capture seconds and the pool's size."""
    import contextlib
    import io

    import torch

    from srgan_st_tpu_torch.eval.validate import make_generator_apply, validate
    from srgan_st_tpu_torch.losses.registry import build_criterions, build_warmup_criterions
    from srgan_st_tpu_torch.models.generator import Generator
    from srgan_st_tpu_torch.train.checkpoint import variables_from_generator_state_dict
    from srgan_st_tpu_torch.train.graphs import StepGraphs
    from srgan_st_tpu_torch.train.steps import (
        create_generator_state, make_gan_chunk_step, make_warmup_chunk_step,
    )
    from srgan_st_tpu_torch.train.utils import make_test_pairs
    from srgan_st_tpu_torch.utils.debugging import nan_guard

    rng = np.random.default_rng(11)
    batches = [torch.from_numpy(rng.integers(0, 256, batch.shape, dtype=np.uint8)).to(dev)
               for _ in range(GRAPH_STEPS)]
    x_eval = torch.from_numpy(rng.random((2, 24, 24, 3), np.float32)).to(dev)
    rec, bad, replayed = {"cases": {}}, [], {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for recipe, trunk in GRAPH_CASES:
            cfg = _graph_config(recipe, trunk, vgg)
            lr = cfg.SOLVER.G_BASE_LR
            evals = {}

            def between(state, tag):
                with torch.no_grad():
                    evals[tag] = state.g_model(x_eval, train=False)

            eager, e_metrics, e_counts, _ = _graph_drive(
                cfg, dev, batches, None, lambda s: between(s, "eager_mid"))
            graphs = StepGraphs(dev)
            graph, g_metrics, g_counts, g_replayed = _graph_drive(
                cfg, dev, batches, graphs, lambda s: between(s, "graph_mid"))
            again, a_metrics, _, _ = _graph_drive(cfg, dev, batches, None)
            with torch.no_grad():
                y_eager = eager.g_model(x_eval, train=False)
                y_graph = graph.g_model(x_eval, train=False)
            flat = {name: _train_tensors(st) for name, st in
                    (("eager", eager), ("graph", graph), ("again", again))}
            for name, ms in (("eager", e_metrics), ("graph", g_metrics), ("again", a_metrics)):
                for i, m in enumerate(ms):
                    flat[name].update({f"metric{i}/{k}": v.reshape(()) for k, v in m.items()})
            repeats, repeat_diff, repeat_keys = _bits(flat["eager"], flat["again"])
            equal, diff, keys = _bits(flat["eager"], flat["graph"])
            pairs = make_test_pairs(cfg)
            psnr = {name: validate(make_generator_apply(
                cfg, variables_from_generator_state_dict(st.g_model.state_dict()), device=dev),
                pairs, cfg) for name, st in (("eager", eager), ("graph", graph))}
            updates = {"g": GRAPH_STEPS, "d": GRAPH_STEPS // 2}
            c = {"eager_repeats_bits": repeats, "eager_repeat_max_diff": repeat_diff,
                 "eager_repeat_differs": repeat_keys,
                 "graph_equals_eager_bits": equal, "graph_max_param_diff": diff,
                 "graph_differs": keys, "param_bound": 2.01 * lr * updates["g"],
                 "launches_eager": e_counts, "launches_graph": g_counts,
                 "launches_replayed": g_replayed,
                 "eval_after_replays_equals_eager": bool(torch.equal(y_eager, y_graph)),
                 "eval_moved_by_the_last_replays": not bool(torch.equal(evals["graph_mid"],
                                                                        y_graph)),
                 "validate": psnr, "capture_seconds": graphs.capture_seconds(),
                 "launches_per_replay": graphs.launches_per_replay(),
                 "pool_bytes": graphs.pool_bytes()}
            name = f"{recipe}/{trunk}"
            rec["cases"][name] = c
            for k, n in g_replayed.items():
                replayed[k] = replayed.get(k, 0) + n
            # the first call of each step kind runs eagerly (then its capture):
            # of 6 steps, 4 are replays
            path = [k for k, n in e_counts.items() if n]
            ok = (g_counts == e_counts and all(g_replayed[k] * GRAPH_STEPS == e_counts[k] * 4
                                               for k in path)
                  and c["eval_moved_by_the_last_replays"])
            if repeats:
                ok = (ok and equal and c["eval_after_replays_equals_eager"]
                      and psnr["eager"] == psnr["graph"])
            else:
                ok = ok and diff <= c["param_bound"]
            if not ok:
                bad.append(f"{name}: {c}")
            del eager, graph, again, flat, graphs
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    emit("graph", **rec)

    # TPU.NAN_GUARD: a NaN put into a G weight between replayed chunks
    cfg = _graph_config("adversarial", "packed", vgg)
    state = _gan_state(cfg, dev)
    guard = nan_guard(make_gan_chunk_step(cfg, build_criterions(cfg), graphs=StepGraphs(dev)))
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        for i in range(0, GRAPH_STEPS, 2):
            state, _ = guard(state, batches[i:i + 2], True)
        guard.flush()
        clean = log.getvalue()
        with torch.no_grad():
            state.g_model.conv1[0].weight[0, 0, 0, 0] = float("nan")
        for i in range(0, GRAPH_STEPS, 2):
            state, _ = guard(state, batches[i:i + 2], True)
        guard.flush()
    warning = "WARNING: non-finite training metrics"
    nan = {"warnings_before_the_nan": clean.count(warning),
           "warnings_after_the_nan": log.getvalue().count(warning) - clean.count(warning)}
    if nan["warnings_before_the_nan"] or not nan["warnings_after_the_nan"]:
        bad.append(f"nan_guard {nan}")
    del state, guard

    # doctor
    proc = subprocess.run([sys.executable, "-m", "srgan_st_tpu_torch", "doctor", "--json"],
                          capture_output=True, text=True, cwd=HERE, timeout=300)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    doctor = {"rc": proc.returncode, **(json.loads(lines[-1]) if lines else
                                        {"stderr": proc.stderr[-2000:]})}
    if proc.returncode != 0 or not doctor.get("ok"):
        bad.append(f"doctor {doctor}")
    emit("graph_checks", nan_guard=nan, doctor=doctor)

    # ms per step, eager and by replays in turns (ABAB), one state each
    timed = {}
    profiles = {}
    for recipe, trunk in GRAPH_CASES:
        cfg = _graph_config(recipe, trunk, vgg)
        crits = build_criterions(cfg)
        arms = {}
        for arm in ("eager", "graph"):
            graphs = StepGraphs(dev) if arm == "graph" else None
            st = _gan_state(cfg, dev)
            chunk = make_gan_chunk_step(cfg, crits, graphs=graphs)
            arms[arm] = {"graphs": graphs,
                         "gan": lambda st=st, chunk=chunk: chunk(st, [batch], True),
                         "g": lambda st=st, chunk=chunk: chunk(st, [batch], False)}
            if recipe == "adversarial" and trunk == "packed":
                w_state = create_generator_state(cfg, Generator.from_config(cfg),
                                                 TRAIN_STEPS, dev, milestones=False)
                w_chunk = make_warmup_chunk_step(cfg, build_warmup_criterions(cfg),
                                                 graphs=graphs)
                arms[arm]["warmup"] = lambda st=w_state, chunk=w_chunk: chunk(st, [batch])
            for fn in [v for k, v in arms[arm].items() if k != "graphs"]:
                fn()  # the first call of each kind (eager, then the capture)
                fn()
        times = {arm: {k: [] for k in arms[arm] if k != "graphs"} for arm in arms}
        for _ in range(GRAPH_PAIRS):
            for kind in times["eager"]:
                for arm in ("eager", "graph"):
                    times[arm][kind].append(cuda_ms(arms[arm][kind], iters=1, warmup=0))
        b = batch.shape[0]
        t = {}
        for arm in arms:
            med = {k: float(np.median(v)) for k, v in times[arm].items()}
            t[arm] = {**{f"ms_per_{k}_step": v for k, v in med.items()},
                      **{f"ms_per_{k}_step_all": v for k, v in times[arm].items()},
                      "patches_per_s_gan_step": b / (med["gan"] / 1e3),
                      "patches_per_s_d_every_100":
                          b / ((med["g"] + (med["gan"] - med["g"]) / 100) / 1e3)}
        t["graph_over_eager_gan_step"] = (t["graph"]["ms_per_gan_step"]
                                          / t["eager"]["ms_per_gan_step"])
        graphs = arms["graph"]["graphs"]
        t["capture_seconds"] = graphs.capture_seconds()
        t["pool_bytes"] = graphs.pool_bytes()
        t["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        name = f"{recipe}/{trunk}"
        timed[name] = t
        profiles[name] = {arm: profile_once(arms[arm]["gan"]) for arm in arms}
        del arms, graphs
        torch.cuda.empty_cache()
    emit("time", graph="eager vs CUDA graph steps in turns, batch 16, 96x96 GT, x4, bf16",
         **timed)
    emit("profile", graph="one GAN step, eager and by replay", **profiles)
    if bad:
        raise AssertionError(f"graph phase: {bad}")
    return {"replayed": replayed, "time": timed, "profiles": profiles, **rec}


def phase_trajectory(dev) -> dict:
    """srgan_st_tpu_torch/tools/trajectory.py on the card: the four goldens x
    {f32, bf16} x {step, chunk} at the JAX tool's gates, then the
    full-width window against the f32 plain reference (the bf16 gates and
    the warmup-update cosine's least, UPDATE_COS_GATE); every record's
    gates and its launches against those its mode implies (the tool's
    `expected_launches`, gated in `ok`). Runs with torch's default TF32
    switches (cuDNN on, matmul off), as train() does, and restores the
    smoke's."""
    import torch

    from srgan_st_tpu_torch.tools import trajectory

    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        t0 = time.perf_counter()
        goldens = os.path.join(HERE, "tests", "goldens")
        records = trajectory.golden_window(trajectory.RECIPES, dev, goldens,
                                           ("float32", "bfloat16"), ("step", "chunk"))
        golden_s = time.perf_counter() - t0
        records += trajectory.full_window(trajectory.RECIPES, dev, goldens)
        full_s = time.perf_counter() - t0 - golden_s
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    bad, groups = [], {}
    for rec in records:
        if not rec["ok"]:
            bad.append(f"{rec['config']}: {rec['detail']} gates {rec['gates']}, update_cos "
                       f"{rec.get('update_cos')} >= {rec.get('update_cos_gate')}, launches "
                       f"{rec['launches']} (want {rec['expected_launches']}) replayed "
                       f"{rec['graph_launches']} (want {rec['expected_graph_launches']})")
        group = ("golden" if rec["width"] == "golden" else "full_reference" if rec["plain"]
                 else "full_fused" if rec["trunk"] == "fused" else "full_shipping")
        for k, n in rec["launches"].items():
            groups.setdefault(group, dict.fromkeys(rec["launches"], 0))[k] += n
    # each kernel of the path launched in its group: A and K7 in the golden
    # replays, A, K4, K5 and K7 in the shipping runs, K6 in the fused one
    for group, names in (("golden", ("coarse_conv_s2d", "buddy_select")),
                         ("full_shipping", ("coarse_conv_s2d", "packed_trunk_fwd",
                                            "packed_trunk_bwd", "buddy_select")),
                         ("full_fused", ("fused_trunk",))):
        bad += [f"trajectory: {name} never launched in {group}"
                for name in names if not groups[group][name]]
    # per run: each max_rel beside its gate (None: reported, not gated), the
    # warmup-update cosines beside their least, the kernels it launched and
    # the replayed part of them
    runs = {r["config"]: {
        "max_rel": r["detail"] and {k: [v, (r["gates"] or {}).get(k)]
                                    for k, v in r["detail"].items()},
        **({"update_cos": [r["update_cos"], r["update_cos_gate"]]} if "update_cos" in r else {}),
        "launches": {k: n for k, n in r["launches"].items() if n},
        "replayed": {k: n for k, n in r["graph_launches"].items() if n},
        "seconds": r["seconds"],
        **({"split_plain_bf16": r["split_plain_bf16"]} if "split_plain_bf16" in r else {}),
    } for r in records}
    emit("trajectory", device=records[0]["device"], golden_seconds=golden_s,
         full_seconds=full_s, runs=runs, launch_totals=groups)
    if bad:
        raise AssertionError(f"trajectory phase: {bad}")
    return {"launches": groups}


def _trajectory_launches(name: str, traj_rec: dict) -> dict:
    """A kernel's launches in the trajectory phase: the golden replays, the
    full-width references, shipping runs and fused run, each summed."""
    return {group: counts[name] for group, counts in traj_rec["launches"].items()}


def _new_path_launches(name: str, data_rec: dict, dist_rec: dict, soak_rec: dict) -> dict:
    """A kernel's launches on the paths of the data, dist and soak phases: one
    train() run from the resident pack, each rank of the LOCAL_BN run, and
    each training process of the soak (warmup, reference, then the killed
    cases' runs; a killed run's counts as of its last epoch start)."""
    return {"data_train_launches": data_rec["train"]["device_cache"]["true"][0]["launches"][name],
            "local_bn_launches_per_rank": [c[name] for c in
                                           dist_rec["local_bn"]["launches_per_rank"]],
            "soak_launches_per_child": [c[name] for c in soak_rec["launches_per_child"]]}


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
    if sys.argv[1:] == ["--only", "graph"]:
        return run_graph_only(torch.device("cuda"))
    if sys.argv[1:] == ["--only", "soak"]:
        return run_soak_only(torch.device("cuda"))
    if sys.argv[1:] == ["--only", "trajectory"]:
        return run_trajectory_only(torch.device("cuda"))
    if sys.argv[1:] == ["--only", "eval_trunk"]:
        return run_eval_trunk_only(torch.device("cuda"))
    if sys.argv[1:] == ["--only", "rrdb_dense"]:
        return run_rrdb_dense_only(torch.device("cuda"))
    if sys.argv[1:] == ["--only", "swinir"]:
        return run_swinir_only(torch.device("cuda"))
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]} (none, or --only "
              "graph|soak|trajectory|eval_trunk|rrdb_dense|swinir)", file=sys.stderr)
        return 2
    return run(torch.device("cuda"))


def run_graph_only(dev) -> int:
    """`--only graph`: the build and the graph phase alone (no result line),
    for working on the captured steps."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=nvidia_smi())
    phase_build()
    rng = np.random.default_rng(0)
    batch = torch.from_numpy(rng.integers(0, 256, (16, 96, 96, 3), dtype=np.uint8)).to(dev)
    with tempfile.TemporaryDirectory() as tmp:
        phase_graph(dev, batch, write_vgg_npz(os.path.join(tmp, "vgg19.npz")))
    return 0


def run_soak_only(dev) -> int:
    """`--only soak`: the build, the soak and the loss study alone (no
    result line), for working on crash safety."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=nvidia_smi())
    phase_build()
    phase_soak()
    phase_loss_study(dev)
    return 0


def run_trajectory_only(dev) -> int:
    """`--only trajectory`: the build and the trajectory phase alone (no
    result line), for working on the training path's numerics."""
    import torch

    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=nvidia_smi())
    phase_build()
    phase_trajectory(dev)
    return 0


def run_eval_trunk_only(dev) -> int:
    """`--only eval_trunk`: the build and kernel E's phase alone (no result
    line), for working on the eval trunk."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=nvidia_smi())
    phase_build()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    phase_kernel_e(gen, dev)
    return 0


def run_rrdb_dense_only(dev) -> int:
    """`--only rrdb_dense`: the build, kernel R's phase and the RRDB serving
    phase alone (no result line), for working on the RRDB trunk."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=nvidia_smi())
    phase_build()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    phase_kernel_r(gen, dev)
    torch.cuda.empty_cache()
    phase_serve_rrdb(gen, dev)
    return 0


def run_swinir_only(dev) -> int:
    """`--only swinir`: the build, kernel W's phase and the SwinIR serving
    phase alone (no result line), for working on the SwinIR path."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0), nvidia_smi=nvidia_smi())
    phase_build()
    phase_kernel_w(dev)
    torch.cuda.empty_cache()
    phase_serve_swinir(dev)
    return 0


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
    rec_e = phase_kernel_e(gen, dev)
    torch.cuda.empty_cache()
    rec_r = phase_kernel_r(gen, dev)
    torch.cuda.empty_cache()
    rec_rs = phase_serve_rrdb(gen, dev)
    torch.cuda.empty_cache()
    phase_kernel_w(dev)
    torch.cuda.empty_cache()
    phase_serve_swinir(dev)
    torch.cuda.empty_cache()

    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as tmp:
        gpath = os.path.join(tmp, "g_best.npz")
        save_variables_npz(gpath, random_variables(0))
        fns = _serve_fns(gpath, dev)
    frames = {"960x540": rng.random((*LR_4K, 3), np.float32),
              "541x383": rng.random((*LR_ODD, 3), np.float32),
              "61x47": rng.random((*LR_ENSEMBLE, 3), np.float32)}
    outs, counts = phase_serve(fns, frames)
    phase_check(fns, frames, outs, rng)
    phase_time(fns, rng, dev)
    phase_profile(fns, rng, dev)
    del fns, outs
    torch.cuda.empty_cache()
    viz_rec = phase_viz(dev)
    torch.cuda.empty_cache()

    rec_k4, rec_k5 = phase_kernel_trunk(gen, dev)
    phase_hybrid_sweep(dev)
    torch.cuda.empty_cache()
    batch = torch.from_numpy(rng.integers(0, 256, (16, 96, 96, 3), dtype=np.uint8)).to(dev)
    train_counts = phase_train(dev, batch)["launches_total"]
    phase_check_train(dev, batch)
    phase_time_train(dev, batch)
    torch.cuda.empty_cache()
    data_rec = phase_data(dev)
    torch.cuda.empty_cache()
    dist_rec = phase_dist(dev)
    torch.cuda.empty_cache()
    soak_rec = phase_soak()
    loss_rec = phase_loss_study(dev)
    torch.cuda.empty_cache()

    rec_k7 = phase_kernel_buddy(dev, batch)
    torch.cuda.empty_cache()
    rec_k6 = phase_kernel_fused(gen, dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        vgg = write_vgg_npz(os.path.join(tmp, "vgg19.npz"))
        run_counts = phase_run(dev, vgg)
        phase_check_run(dev, batch, vgg)
        phase_time_run(dev, batch, vgg)
        torch.cuda.empty_cache()
        graph_rec = phase_graph(dev, batch, vgg)
    torch.cuda.empty_cache()
    traj_rec = phase_trajectory(dev)
    torch.cuda.empty_cache()
    # serving's baseline and artifacts last: after a torch.export in the
    # process, torch.profiler misses one of K4's or K5's kernels in a call
    # (measured on the H100), which the trunk profiles above gate on
    phase_baseline(dev)
    phase_artifact(rng, dev)

    kernels = []
    for rec, name, tpu, source, replaces in (
        (rec_a, "coarse_conv_s2d", "K1", "srgan_st_tpu_torch/csrc/coarse_conv.cu",
         "srgan_st_tpu/kernels/coarse_conv.py:45 (_kernel)"),
        (rec_a, "coarse_conv_s2d", "K2", "srgan_st_tpu_torch/csrc/coarse_conv.cu",
         "srgan_st_tpu/kernels/coarse_conv.py:86 (_kernel_tiled; the same kernel as K1)"),
        (rec_b, "serving_tail", "K3", "srgan_st_tpu_torch/csrc/serving_tail.cu",
         "srgan_st_tpu/kernels/serving_tail.py:70 (_kernel)"),
    ):
        kernels.append({
            "name": name, "tpu_kernel": tpu, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": counts[name], "max_abs_err": rec["bf16_max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "shape": rec["shape"], "f32_max_abs_err": rec["f32_max_abs_err"],
            "train_launches": train_counts[name],
            **_new_path_launches(name, data_rec, dist_rec, soak_rec),
            **({"graph_launches": graph_rec["replayed"][name]} if name != "serving_tail" else {}),
            "viz_launches": viz_rec["launches"][name],
            "trajectory_launches": _trajectory_launches(name, traj_rec),
        })
    for rec, name, tpu, replaces in (
        (rec_k4, "packed_trunk_fwd", "K4",
         "srgan_st_tpu/kernels/packed_trunk.py:195 (_fwd_kernel)"),
        (rec_k5, "packed_trunk_bwd", "K5",
         "srgan_st_tpu/kernels/packed_trunk.py:308 (_bwd_kernel)"),
    ):
        kernels.append({
            "name": name, "tpu_kernel": tpu, "route": "cuda",
            "source": "srgan_st_tpu_torch/csrc/packed_trunk.cu", "replaces": replaces,
            "launches": train_counts[name],
            "max_abs_err": max(e for r in rec["errors"] for e, _ in r["bf16"].values()),
            "f32_max_rel_err": max(e for r in rec["errors"] for e in r["f32_rel"].values()),
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "launch_ms": rec["launch_ms"], "kernels_per_call": rec["profile"]["kernels"],
            "shape": rec["shape"], "n": rec["n"],
            **_new_path_launches(name, data_rec, dist_rec, soak_rec),
            "graph_launches": graph_rec["replayed"][name],
            "trajectory_launches": _trajectory_launches(name, traj_rec),
        })
    kernels.append({
        "name": "fused_trunk", "tpu_kernel": "K6", "route": "cuda",
        "source": "srgan_st_tpu_torch/csrc/fused_trunk.cu",
        "replaces": "srgan_st_tpu/kernels/fused_trunk.py:72 (_kernel)",
        "launches": run_counts["1/fused"]["launches"]["fused_trunk"],
        "max_abs_err": max(e for r in rec_k6["errors"] for e, _ in r["bf16"].values()),
        "f32_max_rel_err": max(e for r in rec_k6["errors"] for e in r["f32_rel"].values()),
        "ms": rec_k6["ms"], "plain_ms": rec_k6["plain_ms"], "bound_ms": rec_k6["bound_ms"],
        "bound_by": rec_k6["bound_by"], "library_ms": rec_k6["library_ms"],
        "launch_ms": rec_k6["launch_ms"], "device_ms": rec_k6["device_ms"],
        "packed_fwd_ms": rec_k6["packed_fwd_ms"],
        "packed_fwd_device_ms": rec_k6["packed_fwd_device_ms"],
        "packed_fwd_launch_ms": rec_k6["packed_fwd_launch_ms"],
        "grid_syncs_per_call": rec_k6["grid_syncs_per_call"], "grid_blocks": rec_k6["grid_blocks"],
        "bf16_equals_k4": all(all(r["bf16_equals_k4"].values()) for r in rec_k6["errors"]),
        "shape": rec_k6["shape"], "n": rec_k6["n"],
        "graph_launches": graph_rec["replayed"]["fused_trunk"],
        "trajectory_launches": _trajectory_launches("fused_trunk", traj_rec),
    })
    kernels.append({
        "name": "eval_trunk", "tpu_kernel": None, "route": "cuda",
        "source": "srgan_st_tpu_torch/csrc/eval_trunk.cu",
        "replaces": "none: the eval trunk (blocks, fusion layer, global skip), plain XLA "
                    "in the JAX package",
        "launches": counts["eval_trunk"], "max_abs_err": rec_e["bf16_max_abs_err"],
        "ms": rec_e["ms"], "plain_ms": rec_e["plain_ms"], "bound_ms": rec_e["bound_ms"],
        "bound_by": rec_e["bound_by"], "library_ms": rec_e["library_ms"],
        "shape": rec_e["shape"], "n": rec_e["n"], "train_launches": train_counts["eval_trunk"],
    })
    kernels.append({
        "name": "rrdb_dense", "tpu_kernel": None, "route": "cuda",
        "source": "srgan_st_tpu_torch/csrc/rrdb_dense.cu",
        "replaces": "none: port-only (Real-ESRGAN's dense block; the JAX package has no "
                    "RRDB generator)",
        "launches": rec_rs["launches"]["rrdb_dense"],
        "max_abs_err": rec_r["bf16_max_abs_err"],
        "ms": rec_r["ms"], "trunk_ms": rec_r["trunk_ms"], "plain_ms": rec_r["plain_ms"],
        "bound_ms": rec_r["bound_ms"], "trunk_bound_ms": rec_r["trunk_bound_ms"],
        "bound_by": rec_r["bound_by"], "library_ms": rec_r["library_ms"],
        "trunk_library_ms": rec_r["trunk_library_ms"], "shape": rec_r["shape"],
        "train_launches": train_counts["rrdb_dense"],
    })
    rec_h = rec_r["kernel_h"]
    kernels.append({
        "name": "rrdb_hr", "tpu_kernel": None, "route": "cuda",
        "source": "srgan_st_tpu_torch/csrc/rrdb_hr.cu",
        "replaces": "none: port-only (Real-ESRGAN's HR stage; the JAX package has no "
                    "RRDB generator)",
        "launches": rec_rs["launches"]["rrdb_hr"], "max_abs_err": rec_h["bf16_max_abs_err"],
        "ms": rec_h["ms"], "upsample_ms": rec_h["upsample_ms"], "tail_ms": rec_h["tail_ms"],
        "plain_ms": rec_h["plain_ms"], "bound_ms": rec_h["bound_ms"],
        "bound_by": rec_h["bound_by"], "library_ms": rec_h["library_ms"],
        "shape": rec_h["shape"], "train_launches": train_counts["rrdb_hr"],
    })
    kernels.append({
        "name": "buddy_select", "tpu_kernel": "K7", "route": "cuda",
        "source": "srgan_st_tpu_torch/csrc/buddy_select.cu",
        "replaces": "srgan_st_tpu/kernels/buddy_select.py:78 (_buddy_kernel)",
        "launches": run_counts["1/fused"]["launches"]["buddy_select"],
        "max_abs_err": rec_k7["max_abs_err"], "ms": rec_k7["ms"], "variant": rec_k7["variant"],
        "simt_ms": rec_k7["simt_ms"], "device_ms": rec_k7["device_ms"],
        "simt_device_ms": rec_k7["simt_device_ms"],
        "library_device_ms": rec_k7["library_device_ms"],
        "plain_ms": rec_k7["plain_ms"], "bound_ms": rec_k7["bound_ms"],
        "bound_by": rec_k7["bound_by"], "library_ms": rec_k7["library_ms"],
        "shape": rec_k7["shape"], "graph_launches": graph_rec["replayed"]["buddy_select"],
        "soak_launches_per_child": [c["buddy_select"] for c in soak_rec["launches_per_child"]],
        "loss_study_launches": loss_rec["launches"]["buddy_select"],
        "trajectory_launches": _trajectory_launches("buddy_select", traj_rec),
    })
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
