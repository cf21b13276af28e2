"""Offline patch-tiling data prep (port of srgan_st_tpu/data/prepare_dataset.py).

Tiles each HR image into `output_size`^2 crops on a `step_size` raster and
writes `name_XXXX.ext` files, the reference's data-prep/prepare_dataset.py
contract and defaults (deterministic tiling, no random crops), with a
thread pool; `--pack` also writes `patches.pack.npy`, the memory-mappable
uint8 archive the training pipeline reads without decoding. PIL is
imported inside the functions that decode and encode.

Usage:
    python -m srgan_st_tpu_torch prepare-dataset \\
        --input_dir data/original --output_dir data/train \\
        --output_size 96 --step_size 96 --num_workers 16 --pack
"""

from __future__ import annotations

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def tile_image(image_file_name: str, input_dir: str, output_dir: str,
               output_size: int, step_size: int) -> int:
    """Tile one image; returns the number of crops written."""
    from PIL import Image

    path = os.path.join(input_dir, image_file_name)
    with Image.open(path) as im:
        image = np.asarray(im.convert("RGB"), dtype=np.uint8)
    im_h, im_w = image.shape[:2]
    stem, ext = os.path.splitext(image_file_name)
    index = 1
    if output_size <= im_h and output_size <= im_w:
        for pos_y in range(0, im_h - output_size + 1, step_size):
            for pos_x in range(0, im_w - output_size + 1, step_size):
                crop = image[pos_y:pos_y + output_size, pos_x:pos_x + output_size]
                Image.fromarray(crop).save(os.path.join(output_dir, f"{stem}_{index:04d}{ext}"))
                index += 1
    return index - 1


def pack_patches(patch_dir: str, patch_size: int) -> str:
    """Pack every patch image of a directory into patches.pack.npy
    ((N, S, S, 3) uint8, memory-mappable, sorted-filename order)."""
    from PIL import Image

    names = sorted(n for n in os.listdir(patch_dir)
                   if n.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")))
    out_path = os.path.join(patch_dir, "patches.pack.npy")
    pack = np.lib.format.open_memmap(out_path, mode="w+", dtype=np.uint8,
                                     shape=(len(names), patch_size, patch_size, 3))
    for i, n in enumerate(names):
        with Image.open(os.path.join(patch_dir, n)) as im:
            pack[i] = np.asarray(im.convert("RGB"), np.uint8)[:patch_size, :patch_size]
    pack.flush()
    print(f"packed {len(names)} patches into {out_path}")
    return out_path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Slice a directory of images into sub-images of a given size "
        "(HR training patches).")
    parser.add_argument("--input_dir", type=str, required=True)
    parser.add_argument("--output_dir", type=str, required=True)
    parser.add_argument("--output_size", type=int, default=96)
    parser.add_argument("--step_size", type=int, default=96)
    parser.add_argument("--num_workers", type=int, default=16)
    parser.add_argument("--pack", action="store_true",
                        help="also write output_dir/patches.pack.npy, the uint8 archive "
                        "the training pipeline reads without decoding")
    args = parser.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    names = sorted(os.listdir(args.input_dir))
    with ThreadPoolExecutor(max_workers=args.num_workers) as pool:
        counts = list(pool.map(
            lambda n: tile_image(n, args.input_dir, args.output_dir, args.output_size,
                                 args.step_size), names))
    print(f"tiled {len(names)} images into {sum(counts)} patches")
    if args.pack:
        pack_patches(args.output_dir, args.output_size)


if __name__ == "__main__":
    main()
