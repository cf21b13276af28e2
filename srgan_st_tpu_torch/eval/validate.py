"""Evaluation: Y-channel PSNR/SSIM over paired test sets (port of
srgan_st_tpu/eval/validate.py).

Reproduces the reference's validate.py:18-113 contract: batch-1 no-grad
loop, the exact uint8 round-trip metric recipe, optional PNG dumps
(optionally side-by-side with GT), a per-image `_metrics.txt` log, and mean
+/- 95% normal-approximation confidence intervals. The "bicubic" /
"nearest" EXP.NAME substitution (validate.py:48-51) gives the baseline
upscalers; TPU.SELF_ENSEMBLE wraps the generator in the x8 self-ensemble.
"""

from __future__ import annotations

import itertools
import os
from statistics import NormalDist

import numpy as np
import torch

from srgan_st_tpu_torch.eval.tiled import to_numpy
from srgan_st_tpu_torch.ops.color import bgr2ycbcr
from srgan_st_tpu_torch.ops.metrics import psnr as psnr_fn
from srgan_st_tpu_torch.ops.metrics import ssim as ssim_fn
from srgan_st_tpu_torch.ops.metrics import tensor2img
from srgan_st_tpu_torch.utils.profiling import span


def confidence_interval(data, confidence: float = 0.95) -> float:
    """Half-width of the normal-approx CI (reference validate.py:18-26)."""
    dist = NormalDist.from_samples(data)
    z = NormalDist().inv_cdf((1 + confidence) / 2.0)
    return dist.stdev * z / ((len(data) - 1) ** 0.5)


def validate(
    apply_fn,
    pairs,
    config,
    save_images: bool = False,
    concat_with_gt: bool = False,
    save_metrics: bool = False,
) -> tuple[float, float]:
    """Run eval: apply_fn(lr_nhwc) -> sr_nhwc per batch-1 pair.

    Returns (avg_psnr, avg_ssim) following reference validate.py:61-113."""
    metrics_file = None
    out_dir = os.path.join(config.DATA.TEST_SR_IMAGES_DIR, config.EXP.NAME)
    if save_metrics:
        os.makedirs(out_dir, exist_ok=True)
        metrics_file = open(os.path.join(out_dir, "_metrics.txt"), mode="w")

    all_psnr, all_ssim = [], []
    if hasattr(pairs, "__len__") and len(pairs) == 0:
        raise ValueError("empty evaluation set — check TEST_*_IMAGES_DIR paths")
    for idx, (hr_img, lr_img) in enumerate(pairs):
        output = to_numpy(apply_fn(lr_img))

        output = tensor2img(output)  # uint8 BGR HWC
        gt = tensor2img(hr_img)

        if save_images:
            os.makedirs(out_dir, exist_ok=True)
            img = np.concatenate([output, gt], axis=1) if concat_with_gt else output
            _write_png(os.path.join(out_dir, f"{idx}.png"), img)

        output_y = bgr2ycbcr(output.astype(np.float32) / 255.0, only_y=True)
        gt_y = bgr2ycbcr(gt.astype(np.float32) / 255.0, only_y=True)
        p = psnr_fn(output_y * 255, gt_y * 255)
        s = ssim_fn(output_y * 255, gt_y * 255)
        all_psnr.append(p)
        all_ssim.append(s)
        if metrics_file:
            metrics_file.write(f"{idx}.png | PSNR: {p:.2f} | SSIM: {s:.4f}\n")

    avg_psnr = sum(all_psnr) / len(all_psnr)
    avg_ssim = sum(all_ssim) / len(all_ssim)
    if len(all_psnr) > 1:
        line = (
            f"[Test] | PSNR: {avg_psnr:.2f} ± {confidence_interval(all_psnr):.2f} "
            f"| SSIM: {avg_ssim:.4f} ± {confidence_interval(all_ssim):.4f} | \n"
        )
    else:
        line = f"[Test] | PSNR: {avg_psnr:.2f} | SSIM: {avg_ssim:.4f} | \n"
    print(line)
    if metrics_file:
        metrics_file.write("\n" + line + "\n")
        metrics_file.close()
    return avg_psnr, avg_ssim


def _write_png(path: str, bgr_img: np.ndarray) -> None:
    """An 8-bit PNG written with zlib alone (no imaging library needed): RGB
    (colour type 2) of a uint8 BGR HWC image, or grey (colour type 0) of a
    uint8 HW one."""
    import struct
    import zlib

    grey = bgr_img.ndim == 2
    pixels = np.ascontiguousarray(bgr_img if grey else bgr_img[..., ::-1], dtype=np.uint8)
    h, w = pixels.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8), pixels.reshape(h, -1)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0 if grey else 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes()))
                + chunk(b"IEND", b""))


def make_generator_apply(config, variables, device=None):
    """Eval-mode generator `fn(lr_nhwc) -> sr_nhwc` (a float32 tensor on
    `device`) of the architecture MODEL.G_ARCH names: SRResNet with running
    BN statistics from a JAX-format variables tree, RRDBNet from its state
    dict (basicsr's names; tensors or arrays), or SwinIR from its state
    dict (SwinIR's names, its derived buffers dropped: `release_state`). Runs on CUDA unless
    `device` says otherwise; a call is the span `serve.frame`, its frame
    number as args. With config.TPU.TILED_EVAL, wraps the halo-tiled
    applier (numpy out), and with config.TPU.SELF_ENSEMBLE the x8
    self-ensemble around it."""
    from srgan_st_tpu_torch.core.device import resolve_device
    from srgan_st_tpu_torch.models.generator import build_generator
    from srgan_st_tpu_torch.train.checkpoint import (
        generator_state_dict_from_variables,
    )

    dev = resolve_device(device)
    arch = config.MODEL.get("G_ARCH", "srresnet")
    g_model = build_generator(config)
    if arch == "rrdb":
        g_model.load_state_dict({k: torch.as_tensor(v) for k, v in variables.items()})
    elif arch == "swinir":
        from srgan_st_tpu_torch.models.swinir import release_state

        g_model.load_state_dict(release_state(variables))
    else:
        g_model.load_state_dict(generator_state_dict_from_variables(variables))
    g_model.to(dev).eval()

    frames = itertools.count()

    def apply_fn(lr) -> torch.Tensor:
        with span("serve.frame", next(frames)), torch.inference_mode():
            return g_model(torch.as_tensor(lr, device=dev))

    apply_fn.model = g_model
    apply_fn.device = dev
    if config.TPU.get("TILED_EVAL"):
        from srgan_st_tpu_torch.eval.tiled import TiledApplier, generator_halo

        apply_fn = TiledApplier(
            apply_fn, upscale=config.DATA.UPSCALE_FACTOR,
            halo=generator_halo(config.MODEL.G_N_RCB, config.DATA.UPSCALE_FACTOR, arch),
        )
    if config.TPU.get("SELF_ENSEMBLE"):
        from srgan_st_tpu_torch.eval.ensemble import self_ensemble

        apply_fn = self_ensemble(apply_fn)
    return apply_fn


def test(config, save_images: bool = True, g_path: str | None = None,
         concat_w_gt: bool = False, device=None) -> tuple[float, float]:
    """Test a generator on the configured paired test set (with
    DATA.SYNTHETIC, on the seeded synthetic pairs the training loops
    validate on); EXP.NAME "bicubic" / "nearest" tests the baseline
    upscaler instead (reference validate.py:28-58)."""
    from srgan_st_tpu_torch.models.baselines import baseline
    from srgan_st_tpu_torch.train.checkpoint import load_params_npz
    from srgan_st_tpu_torch.train.utils import make_test_pairs

    pairs = make_test_pairs(config)
    if config.EXP.NAME in ("bicubic", "nearest"):
        apply_fn = baseline(config, device)
    else:
        if not g_path:
            g_path = f"results/{config.EXP.NAME}/g_best.npz"
        apply_fn = make_generator_apply(config, load_params_npz(g_path), device=device)
    return validate(
        apply_fn, pairs, config,
        save_images=save_images, concat_with_gt=concat_w_gt, save_metrics=True,
    )


def main(argv=None) -> None:
    """CLI mirror of the reference's validate.py __main__ (validate.py:116-138).

    Usage:
        python -m srgan_st_tpu_torch validate --exp_name patchwise-st \\
            --test_set Urban100 --data_root data [--gpath w.npz] [--tiled]
    """
    import argparse

    from srgan_st_tpu_torch.core.config import Config

    parser = argparse.ArgumentParser(
        description="Run evaluation on a model. If --exp_name is 'bicubic' or "
        "'nearest' the corresponding baseline upscaler is evaluated instead of "
        "a trained generator.")
    parser.add_argument("--exp_name", type=str, required=True)
    parser.add_argument("--test_set", type=str, default="Set5")
    parser.add_argument("--data_root", type=str, default="data")
    parser.add_argument("--save_images", action="store_true")
    parser.add_argument("--concat_w_gt", action="store_true")
    parser.add_argument("--gpath", type=str, default=None,
                        help="explicit generator weights (.npz) path")
    parser.add_argument("--tiled", action="store_true",
                        help="halo-tiled inference for large images")
    parser.add_argument("--ensemble", action="store_true",
                        help="geometric x8 self-ensemble (eval/ensemble.py)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda)")
    args = parser.parse_args(argv)

    config = Config()
    config.EXP.NAME = args.exp_name
    config.DATA.TEST_SET = args.test_set
    config.DATA.TEST_GT_IMAGES_DIR = f"{args.data_root}/{args.test_set}/GTmod12"
    config.DATA.TEST_LR_IMAGES_DIR = f"{args.data_root}/{args.test_set}/LRbicx4"
    config.DATA.TEST_SR_IMAGES_DIR = f"results/_test/{args.test_set}"
    config.TPU.TILED_EVAL = args.tiled
    config.TPU.SELF_ENSEMBLE = args.ensemble
    test(config, save_images=args.save_images, concat_w_gt=args.concat_w_gt,
         g_path=args.gpath, device=args.device)


if __name__ == "__main__":
    main()
