"""Paired eval data (port of srgan_st_tpu/data/pipeline.py, eval part).

Training sources wait for ROADMAP.md Queue A, item 4. PIL is imported
inside the decoder only.
"""

from __future__ import annotations

import os

import numpy as np

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".webp")


def _list_images(directory: str) -> list[str]:
    out = []
    for dirpath, _, filenames in os.walk(directory):
        for f in sorted(filenames):
            if f.lower().endswith(_IMG_EXTS) and not f.startswith("."):
                out.append(os.path.join(dirpath, f))
    return sorted(out)


def _decode_rgb(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


class TestPairSource:
    """Paired pre-generated GT/LR eval directories, sorted filename
    alignment (reference dataset.py:39-58; e.g. GTmod12 / LRbicx4)."""

    def __init__(self, gt_dir: str, lr_dir: str):
        self.gt_files = _list_images(gt_dir)
        self.lr_files = _list_images(lr_dir)
        if len(self.gt_files) != len(self.lr_files):
            raise ValueError(
                f"GT/LR count mismatch: {len(self.gt_files)} vs {len(self.lr_files)}"
            )

    def __len__(self) -> int:
        return len(self.gt_files)

    def __iter__(self):
        for gt_path, lr_path in zip(self.gt_files, self.lr_files):
            gt = _decode_rgb(gt_path).astype(np.float32) / 255.0
            lr = _decode_rgb(lr_path).astype(np.float32) / 255.0
            yield gt[None], lr[None]  # NHWC batch-1
