"""Host input pipeline (port of srgan_st_tpu/data/pipeline.py).

Training sources yield uint8 NHWC GT-patch batches; the step moves them to
the device and degrades them there (train/steps.py). The synthetic source
draws seeded patches; `TrainPatchSource` decodes a directory of pre-tiled
patches, shuffled per (seed, epoch) with drop_last. The packed patch
archive and larger tiles with random crops wait for ROADMAP.md Queue A,
item 4. PIL is imported inside the decoder only.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

DATA_TODO = ("{} is not ported yet (ROADMAP.md Queue A, item 4: the data "
             "pipeline's crops, augmentation and packed sources)")
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


class SyntheticPatchSource:
    """Deterministic synthetic GT patches (tests / benchmarks; no disk IO):
    one seeded stream of uint8 batches, drawn afresh every epoch."""

    def __init__(self, batch_size: int, patch_size: int = 96, n_batches: int = 64,
                 seed: int = 0):
        self.batch_size = batch_size
        self.patch_size = patch_size
        self.n_batches = n_batches
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self.n_batches

    def epoch(self, epoch_idx: int | None = None):
        del epoch_idx  # synthetic data: every epoch is freshly drawn
        for _ in range(self.n_batches):
            yield self._rng.integers(
                0, 256, (self.batch_size, self.patch_size, self.patch_size, 3),
                dtype=np.uint8)


class TrainPatchSource:
    """Shuffled uint8 NHWC GT-patch batches from a directory of pre-tiled
    HR patches (the output of prepare_dataset.py), decoded by a thread
    pool. The order is keyed by (seed, epoch), so a resumed run replays the
    original data order from any epoch boundary."""

    def __init__(self, gt_dir: str, batch_size: int, patch_size: int = 96,
                 seed: int = 0, num_workers: int = 4):
        self.files = _list_images(gt_dir)
        if not self.files:
            raise FileNotFoundError(f"no images under {gt_dir}")
        if len(self.files) < batch_size:
            raise ValueError(
                f"dataset smaller than one batch: {len(self.files)} patches under "
                f"{gt_dir} < batch_size {batch_size}")
        self.batch_size = batch_size
        self.patch_size = patch_size
        self.seed = seed
        self.num_workers = max(1, num_workers)

    def __len__(self) -> int:  # batches per epoch (drop_last=True)
        return len(self.files) // self.batch_size

    def _load_batch(self, pool, paths: list[str]) -> np.ndarray:
        s = self.patch_size
        out = np.empty((len(paths), s, s, 3), dtype=np.uint8)
        for i, im in enumerate(pool.map(_decode_rgb, paths)):
            if im.shape[0] < s or im.shape[1] < s:
                raise ValueError(f"patch smaller than {s}: {paths[i]} {im.shape}")
            out[i] = im[:s, :s]
        return out

    def epoch(self, epoch_idx: int = 0):
        order = np.random.default_rng((self.seed, epoch_idx)).permutation(len(self.files))
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for b in range(len(self)):
                idx = order[b * self.batch_size:(b + 1) * self.batch_size]
                yield self._load_batch(pool, [self.files[i] for i in idx])


def make_train_source(config):
    """The configured training source: synthetic, or a directory of
    pre-tiled patches. Tiles larger than GT_IMAGE_SIZE and the packed
    archive raise (ROADMAP.md Queue A, item 4)."""
    tile = config.DATA.TILE_SIZE or config.DATA.GT_IMAGE_SIZE
    if tile != config.DATA.GT_IMAGE_SIZE:
        raise NotImplementedError(DATA_TODO.format(
            f"DATA.TILE_SIZE={tile} (random crops to GT_IMAGE_SIZE)"))
    if config.DATA.SYNTHETIC:
        return SyntheticPatchSource(
            config.DATA.BATCH_SIZE, tile, n_batches=config.DATA.SYNTHETIC_N_BATCHES,
            seed=config.DATA.SEED)
    gt_dir = config.DATA.TRAIN_GT_IMAGES_DIR
    if gt_dir.endswith(".npy") or os.path.exists(os.path.join(gt_dir, "patches.pack.npy")):
        raise NotImplementedError(DATA_TODO.format("the packed patch archive"))
    return TrainPatchSource(gt_dir, config.DATA.BATCH_SIZE, tile, seed=config.DATA.SEED)
