"""Standalone super-resolution inference: upscale images with no GT
(port of srgan_st_tpu/eval/infer.py).

    python -m srgan_st_tpu_torch infer \\
        --gpath results/patchwise-st/g_best.npz \\
        --input photos/ --output photos_x4/ [--tiled] [--bf16]

* weights are the JAX package's npz format (`g_best.npz`), carried into the
  torch generator by train/checkpoint.py;
* accepts a single image file or a directory (png/jpg/bmp/tif);
* `--tiled` runs the halo-tiled applier (eval/tiled.py): one tile-batch
  shape for any image size and bounded device memory;
* odd image sizes are right/bottom edge-padded to even dims for the
  generator's coarse-conv kernels and cropped back exactly after upscaling;
* runs on CUDA unless `--device cpu` is given.

`--artifact`, `--ensemble` and `--exp_name bicubic|nearest` wait for
ROADMAP.md Queue A, item 3. Outputs are PNG, named <stem>_x<factor>.png.
"""

from __future__ import annotations

import os

import numpy as np

from srgan_st_tpu_torch.eval.tiled import to_numpy
from srgan_st_tpu_torch.eval.validate import BASELINE_TODO, ENSEMBLE_TODO

ARTIFACT_TODO = ("serving from an exported artifact waits for eval/export.py "
                 "(ROADMAP.md Queue A, item 3)")


def _load_rgb(path: str) -> np.ndarray:
    from srgan_st_tpu_torch.data.pipeline import _decode_rgb

    return _decode_rgb(path).astype(np.float32) / 255.0


def _save_png(path: str, img01: np.ndarray) -> None:
    from PIL import Image

    arr = np.clip(np.rint(img01 * 255.0), 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(path)


def make_infer_fn(config, gpath: str | None = None, device=None):
    """`fn(lr_nhwc float32 [0,1]) -> sr_nhwc` for the generator in the
    checkpoint at `gpath` (default results/<EXP.NAME>/g_best.npz). The
    checkpoint, not the config, defines the architecture."""
    if config.EXP.NAME in ("bicubic", "nearest"):
        raise NotImplementedError(BASELINE_TODO)

    from srgan_st_tpu_torch.eval.export import derive_arch
    from srgan_st_tpu_torch.eval.validate import make_generator_apply
    from srgan_st_tpu_torch.train.checkpoint import load_params_npz

    if not gpath:
        gpath = f"results/{config.EXP.NAME}/g_best.npz"
    variables = load_params_npz(gpath)
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
                        help="generator weights (.npz); default "
                             "results/<exp_name>/g_best.npz")
    parser.add_argument("--artifact", type=str, default=None,
                        help="serve from an exported artifact (not ported yet)")
    parser.add_argument("--exp_name", type=str, default="srgan")
    parser.add_argument("--upscale", type=int, default=4)
    parser.add_argument("--tiled", action="store_true",
                        help="halo-tiled inference: one tile-batch shape for "
                             "any image size, bounded memory")
    parser.add_argument("--bf16", action="store_true", help="bfloat16 compute")
    parser.add_argument("--ensemble", action="store_true",
                        help="geometric x8 self-ensemble (not ported yet)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda)")
    args = parser.parse_args(argv)

    if args.artifact:
        raise NotImplementedError(ARTIFACT_TODO)
    if args.ensemble:
        raise NotImplementedError(ENSEMBLE_TODO)
    config = Config()
    config.EXP.NAME = args.exp_name
    config.DATA.UPSCALE_FACTOR = args.upscale
    config.TPU.TILED_EVAL = args.tiled
    if args.bf16:
        config.TPU.COMPUTE_DTYPE = "bfloat16"

    files = _list_inputs(args.input)
    if not files:
        raise SystemExit(f"no images found under {args.input}")
    apply_fn = make_infer_fn(config, gpath=args.gpath, device=args.device)
    factor = config.DATA.UPSCALE_FACTOR
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
