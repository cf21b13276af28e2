"""Paper-figure rendering (port of srgan_st_tpu/viz/save_image_patch.py;
reference visualization/save_image_patch.py:20-95): the GT image with a
marked crop, and the same crop of each named generator's SR output.

`comparison_crops` is the array core: a GT uint8 image and its LR frame in
[0, 1] in, the boxed GT and one uint8 crop per name out. Names are "gt",
the "bicubic" / "nearest" baselines (models/baselines.py), or experiments,
whose `results/<name>/g_best.npz` is served through
`eval/validate.py` `make_generator_apply`: the serving path, whose kernels
(A, and B under TPU.TAIL_MODE="fused") run on a CUDA device.
`save_image_patch` decodes the files (PIL, imported when called) and
writes `{image}_gt_box.png` and `{image}_{name}.png` with zlib alone.
"""

from __future__ import annotations

import os

import numpy as np


def _draw_box(img: np.ndarray, y: int, x: int, h: int, w: int,
              color=(255, 0, 0), thickness: int = 3) -> np.ndarray:
    out = img.copy()
    t = thickness
    out[y:y + h, x:x + t] = color
    out[y:y + h, x + w - t:x + w] = color
    out[y:y + t, x:x + w] = color
    out[y + h - t:y + h, x:x + w] = color
    return out


def make_upscaler(config, name: str, results_root: str = "results", device=None):
    """`fn(lr_nhwc) -> sr_nhwc` of a baseline or of an experiment's
    g_best.npz."""
    from srgan_st_tpu_torch.eval.validate import make_generator_apply
    from srgan_st_tpu_torch.models.baselines import BicubicUpscaler, NearestNeighbourUpscaler
    from srgan_st_tpu_torch.train.checkpoint import load_params_npz

    if name == "bicubic":
        return BicubicUpscaler(config.DATA.UPSCALE_FACTOR, device=device)
    if name == "nearest":
        return NearestNeighbourUpscaler(config.DATA.UPSCALE_FACTOR, device=device)
    variables = load_params_npz(os.path.join(results_root, name, "g_best.npz"))
    return make_generator_apply(config, variables, device=device)


def comparison_crops(config, generator_names: list[str], gt_u8: np.ndarray,
                     lr01: np.ndarray, y: int, x: int, patch_size: int = 96,
                     results_root: str = "results", device=None
                     ) -> tuple[np.ndarray, dict[str, np.ndarray]]:
    """(the GT with a red box around the crop, {name: uint8 RGB crop}).
    Each SR output is rounded to uint8 before it is cropped. Runs on CUDA
    unless `device` says otherwise."""
    from srgan_st_tpu_torch.core.device import resolve_device
    from srgan_st_tpu_torch.eval.tiled import to_numpy

    dev = resolve_device(device)
    crops = {}
    for name in generator_names:
        if name == "gt":
            crop = gt_u8[y:y + patch_size, x:x + patch_size]
        else:
            apply_fn = make_upscaler(config, name, results_root, dev)
            sr = to_numpy(apply_fn(np.asarray(lr01, np.float32)[None]))[0]
            sr_u8 = np.clip(np.round(sr * 255), 0, 255).astype(np.uint8)
            crop = sr_u8[y:y + patch_size, x:x + patch_size]
        crops[name] = crop
    return _draw_box(gt_u8, y, x, patch_size, patch_size), crops


def write_rgb_png(path: str, rgb: np.ndarray) -> None:
    """A uint8 RGB HWC image (or HW grey) as a PNG, with zlib alone."""
    from srgan_st_tpu_torch.eval.validate import _write_png

    _write_png(path, rgb if rgb.ndim == 2 else rgb[..., ::-1])


def save_image_patch(
    config,
    generator_names: list[str],
    image_name: str,
    y: int,
    x: int,
    patch_size: int = 96,
    out_dir: str = "figures",
    results_root: str = "results",
    device=None,
) -> list[str]:
    """Render the comparison figure set of `image_name` (in
    DATA.TEST_GT_IMAGES_DIR and DATA.TEST_LR_IMAGES_DIR); returns the
    written paths, the boxed GT first."""
    from srgan_st_tpu_torch.data.pipeline import _decode_rgb

    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(image_name))[0]
    gt = _decode_rgb(os.path.join(config.DATA.TEST_GT_IMAGES_DIR, image_name))
    lr = _decode_rgb(os.path.join(config.DATA.TEST_LR_IMAGES_DIR, image_name))
    boxed, crops = comparison_crops(config, generator_names, gt,
                                    lr.astype(np.float32) / 255.0, y, x, patch_size,
                                    results_root, device)
    written = [os.path.join(out_dir, f"{stem}_gt_box.png")]
    write_rgb_png(written[0], boxed)
    for name, crop in crops.items():
        written.append(os.path.join(out_dir, f"{stem}_{name}.png"))
        write_rgb_png(written[-1], crop)
    return written
