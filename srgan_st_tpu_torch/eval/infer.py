"""Standalone super-resolution inference: upscale images with no GT
(port of srgan_st_tpu/eval/infer.py).

    python -m srgan_st_tpu_torch infer \\
        --gpath results/patchwise-st/g_best.npz \\
        --input photos/ --output photos_x4/ [--tiled] [--bf16]

* weights are the JAX package's npz format (`g_best.npz`), carried into the
  torch generator by train/checkpoint.py, or a Real-ESRGAN / basicsr
  RRDBNet state dict (`.pth` in the release layout, `{"params_ema": sd}`,
  `{"params": sd}` or bare, or an npz of its names), or a SwinIR real-SR
  state dict in the same layouts (its `relative_position_index` and
  `attn_mask` buffers dropped and recomputed); the checkpoint's keys pick
  the architecture (`body.0.rdb1.conv1.weight`: RRDBNet,
  `layers.0.residual_group.blocks.0.attn.qkv.weight`: SwinIR) and its
  shapes the widths, depth and factor;
* accepts a single image file or a directory (png/jpg/bmp/tif);
* `--tiled` runs the halo-tiled applier (eval/tiled.py): one tile-batch
  shape for any image size and bounded device memory;
* `--exp_name bicubic` / `nearest` select the baseline upscalers
  (models/baselines.py; the substitution of reference validate.py:48-51);
* `--artifact model.srganx` serves from an exported torch.export artifact
  (eval/export.py): no checkpoint or model construction; the upscale
  factor comes from the artifact's header;
* `--ensemble` wraps any of these in the geometric x8 self-ensemble
  (eval/ensemble.py);
* odd image sizes are right/bottom edge-padded to even dims for the
  generator's coarse-conv kernels and cropped back exactly after upscaling;
* runs on CUDA unless `--device cpu` is given.

Outputs are PNG (written with zlib alone), named <stem>_x<factor>.png.
"""

from __future__ import annotations

import os

import numpy as np

from srgan_st_tpu_torch.eval.tiled import to_numpy


def _load_rgb(path: str) -> np.ndarray:
    from srgan_st_tpu_torch.data.pipeline import _decode_rgb

    return _decode_rgb(path).astype(np.float32) / 255.0


def _save_png(path: str, img01: np.ndarray) -> None:
    from srgan_st_tpu_torch.eval.validate import _write_png

    rgb = np.clip(np.rint(img01 * 255.0), 0, 255).astype(np.uint8)
    _write_png(path, rgb[..., ::-1])


def load_generator_weights(path: str) -> dict:
    """A generator checkpoint: an npz (a JAX-format variables tree, or a
    flat state dict), or a torch file holding a state dict, bare or under
    "params_ema" or "params" (Real-ESRGAN's release layout; "params_ema"
    first, as its inference loads it)."""
    if not path.endswith((".pth", ".pt")):
        from srgan_st_tpu_torch.train.checkpoint import load_params_npz

        return load_params_npz(path)
    import torch

    state = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("params_ema", "params"):
        if key in state:
            return state[key]
    return state


def make_infer_fn(config, gpath: str | None = None, device=None):
    """`fn(lr_nhwc float32 [0,1]) -> sr_nhwc` for the generator in the
    checkpoint at `gpath` (default results/<EXP.NAME>/g_best.npz), or the
    bicubic / nearest baseline by EXP.NAME. The checkpoint, not the config,
    defines the architecture: its keys pick SRResNet, RRDBNet or SwinIR
    (MODEL.G_ARCH), its shapes the widths, depth and factor."""
    from srgan_st_tpu_torch.models.baselines import baseline

    if config.EXP.NAME in ("bicubic", "nearest"):
        return baseline(config, device)

    from srgan_st_tpu_torch.eval.export import derive_arch
    from srgan_st_tpu_torch.eval.validate import make_generator_apply
    from srgan_st_tpu_torch.models import rrdb, swinir

    if not gpath:
        gpath = f"results/{config.EXP.NAME}/g_best.npz"
    variables = load_generator_weights(gpath)
    if swinir.is_swinir_state(variables):
        arch = swinir.arch_of_state(variables)
        m = config.MODEL
        m.G_ARCH, m.G_EMBED_DIM, m.G_N_RSTB, m.G_RSTB_DEPTH, m.G_N_HEADS = (
            "swinir", arch["embed_dim"], arch["num_rstb"], arch["depth"], arch["heads"])
        m.G_WINDOW, m.G_MLP_RATIO, m.G_HR_CHANNEL = (
            arch["window"], arch["mlp_ratio"], arch["hr_channels"])
        m.G_IN_CHANNEL = m.G_OUT_CHANNEL = arch["in_channels"]
        config.DATA.UPSCALE_FACTOR = arch["upscale"]
        return make_generator_apply(config, variables, device=device)
    if rrdb.is_rrdb_state(variables):
        arch = rrdb.arch_of_state(variables)
        m = config.MODEL
        m.G_ARCH, m.G_N_CHANNEL, m.G_N_RCB, m.G_N_GROW = (
            "rrdb", arch["channels"], arch["num_block"], arch["growth"])
        m.G_IN_CHANNEL, m.G_OUT_CHANNEL = arch["in_channels"], arch["out_channels"]
        config.DATA.UPSCALE_FACTOR = arch["upscale"]
        return make_generator_apply(config, variables, device=device)
    config.MODEL.G_ARCH = "srresnet"
    arch = derive_arch(variables)
    config.MODEL.G_N_CHANNEL = arch["channels"]
    config.MODEL.G_N_RCB = arch["num_rcb"]
    config.DATA.UPSCALE_FACTOR = arch["upscale"]
    return make_generator_apply(config, variables, device=device)


def upscale_image(apply_fn, lr01: np.ndarray, factor: int) -> np.ndarray:
    """Upscale one HWC [0,1] image; pads odd sizes to even and crops the
    output back (edge replication keeps the interior exact)."""
    h, w = lr01.shape[:2]
    ph, pw = h % 2, w % 2
    if ph or pw:
        lr01 = np.pad(lr01, ((0, ph), (0, pw), (0, 0)), mode="edge")
    sr = to_numpy(apply_fn(np.ascontiguousarray(lr01[None])))[0]
    return sr[: h * factor, : w * factor]


def _list_inputs(path: str) -> list[str]:
    exts = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")
    if os.path.isdir(path):
        return sorted(
            os.path.join(path, f)
            for f in os.listdir(path)
            if f.lower().endswith(exts)
        )
    return [path]


def main(argv=None) -> None:
    import argparse

    from srgan_st_tpu_torch.core.config import Config

    parser = argparse.ArgumentParser(
        description="Upscale images (no ground truth needed).")
    parser.add_argument("--input", type=str, required=True,
                        help="image file or directory")
    parser.add_argument("--output", type=str, required=True,
                        help="output directory")
    parser.add_argument("--gpath", type=str, default=None,
                        help="generator weights (.npz, or a Real-ESRGAN .pth); "
                             "default results/<exp_name>/g_best.npz")
    parser.add_argument("--artifact", type=str, default=None,
                        help="serve from an exported torch.export artifact "
                             "(.srganx, see eval/export.py) instead of weights "
                             "+ model code; upscale is read from its header")
    parser.add_argument("--exp_name", type=str, default="srgan")
    parser.add_argument("--upscale", type=int, default=4)
    parser.add_argument("--tiled", action="store_true",
                        help="halo-tiled inference: one tile-batch shape for "
                             "any image size, bounded memory")
    parser.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    parser.add_argument("--ensemble", action="store_true",
                        help="geometric x8 self-ensemble (~0.1-0.2 dB PSNR at "
                             "8x the inference cost)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda)")
    args = parser.parse_args(argv)

    config = Config()
    config.EXP.NAME = args.exp_name
    config.DATA.UPSCALE_FACTOR = args.upscale
    config.TPU.TILED_EVAL = args.tiled
    if args.bf16:
        config.TPU.COMPUTE_DTYPE = "bfloat16"

    files = _list_inputs(args.input)
    if not files:
        raise SystemExit(f"no images found under {args.input}")
    if args.artifact:
        # an artifact is a sealed program: its compute dtype is baked in and
        # it runs whole inputs, so flags that reconfigure the live model are
        # refused rather than ignored
        for flag, given in (("--tiled", args.tiled), ("--bf16", args.bf16),
                            ("--gpath", args.gpath)):
            if given:
                raise SystemExit(f"{flag} does not apply when serving from "
                                 "--artifact (export-time choice; see eval/export.py)")
        from srgan_st_tpu_torch.eval.export import load_runner

        apply_fn = load_runner(args.artifact, device=args.device)
        factor = int(apply_fn.meta["upscale"])
    else:
        apply_fn = make_infer_fn(config, gpath=args.gpath, device=args.device)
        factor = config.DATA.UPSCALE_FACTOR
    if args.ensemble:
        from srgan_st_tpu_torch.eval.ensemble import self_ensemble

        fixed = getattr(apply_fn, "meta", {}).get("fixed_shape")
        if fixed and fixed[1] != fixed[2]:
            raise SystemExit(
                "--ensemble rotates inputs by 90deg, so a fixed-shape artifact "
                f"must be square; this one is pinned to {fixed[1]}x{fixed[2]} "
                "(re-export without --fixed for a dynamic-shape artifact)")
        apply_fn = self_ensemble(apply_fn)
    os.makedirs(args.output, exist_ok=True)
    for i, path in enumerate(files):
        lr = _load_rgb(path)
        sr = upscale_image(apply_fn, lr, factor)
        stem = os.path.splitext(os.path.basename(path))[0]
        out = os.path.join(args.output, f"{stem}_x{factor}.png")
        _save_png(out, sr)
        print(f"[{i + 1}/{len(files)}] {path} "
              f"{lr.shape[1]}x{lr.shape[0]} -> {out} "
              f"{sr.shape[1]}x{sr.shape[0]}")


if __name__ == "__main__":
    main()
