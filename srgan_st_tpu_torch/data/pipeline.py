"""Host input pipeline (port of srgan_st_tpu/data/pipeline.py).

Training sources yield uint8 NHWC GT-patch batches, each process its
contiguous share of every global batch (parallel/distributed.py
`process_slice`); the step moves them to the device, crops and augments
them there and degrades them (train/steps.py). Shuffles are a numpy
permutation keyed by (seed, epoch), with drop_last, so a resumed run
replays the original data order from any epoch boundary.

  * `SyntheticPatchSource`: seeded patches, no disk.
  * `TrainPatchSource`: a directory of pre-tiled patches, decoded by a
    thread pool on a prefetch thread. PIL is imported inside the decoder.
  * `PackedPatchSource`: the decode-free `patches.pack.npy` archive
    (prepare-dataset --pack), memory-mapped; with DATA.DEVICE_CACHE the
    whole pack is copied to the device once and each batch is a gather
    there from int64 indices, so only the indices cross PCIe.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from srgan_st_tpu_torch.parallel.distributed import process_slice

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".webp")


class _DeferredProcessSlice:
    """`process_slice` of a source, resolved at its first batch: a source
    built before `initialize_distributed()` would otherwise latch one
    process."""

    def __init__(self, global_batch_size: int, process_index=None, process_count=None):
        self._args = (global_batch_size, process_index, process_count)
        self._slice: slice | None = None

    def get(self) -> slice:
        if self._slice is None:
            self._slice = process_slice(*self._args)
        return self._slice


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


def _put_or_stop(q: queue.Queue, item, stop: threading.Event) -> bool:
    """A blocking q.put that gives up once `stop` is set, so a producer
    whose consumer abandoned the epoch does not block forever on a full
    queue."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.2)
            return True
        except queue.Full:
            continue
    return False


def _prefetched(n_items: int, make_item, prefetch: int):
    """Yield make_item(0..n_items-1), built on a background thread through a
    bounded queue: the producer's exceptions reach the consumer, and
    abandoning the generator stops the producer."""
    q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
    stop = threading.Event()

    def producer():
        try:
            for i in range(n_items):
                if stop.is_set() or not _put_or_stop(q, make_item(i), stop):
                    return
            _put_or_stop(q, None, stop)
        except Exception as e:  # decode / IO errors go to the consumer
            _put_or_stop(q, e, stop)

    threading.Thread(target=producer, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()


def _locality_gather(pack: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """Rows `idx` of the (memory-mapped) pack, read in page order but
    returned in `idx`'s order: a sorted batch's contiguous per-process
    shares would be index-correlated (a pack stores one image's tiles
    together), which biases per-process BN statistics under LOCAL_BN."""
    flat = idx.reshape(-1)
    order = np.argsort(flat, kind="stable")
    gathered = pack[flat[order]]
    out = np.empty_like(gathered)
    out[order] = gathered
    return out.reshape(*idx.shape, *pack.shape[1:])


class TrainPatchSource:
    """Shuffled uint8 NHWC GT-patch batches from a directory of pre-tiled
    HR patches (the output of prepare_dataset.py), decoded by a thread
    pool on a prefetch thread."""

    def __init__(self, gt_dir: str, batch_size: int, patch_size: int = 96,
                 seed: int = 0, num_workers: int = 4, prefetch: int = 2,
                 process_index: int | None = None, process_count: int | None = None):
        self.files = _list_images(gt_dir)
        if not self.files:
            raise FileNotFoundError(f"no images under {gt_dir}")
        if len(self.files) < batch_size:
            raise ValueError(
                f"dataset smaller than one global batch: {len(self.files)} patches "
                f"under {gt_dir} < batch_size {batch_size}")
        self.batch_size = batch_size  # GLOBAL batch size
        self._pslice = _DeferredProcessSlice(batch_size, process_index, process_count)
        self.patch_size = patch_size
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self._epoch_counter = 0

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

    def epoch(self, epoch_idx: int | None = None):
        if epoch_idx is None:
            epoch_idx = self._epoch_counter
        self._epoch_counter = epoch_idx + 1
        order = np.random.default_rng((self.seed, epoch_idx)).permutation(len(self.files))
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            def make_batch(b: int) -> np.ndarray:
                idx = order[b * self.batch_size:(b + 1) * self.batch_size]
                idx = idx[self._pslice.get()]  # this process's share
                return self._load_batch(pool, [self.files[i] for i in idx])

            yield from _prefetched(len(self), make_batch, self.prefetch)


class SyntheticPatchSource:
    """Deterministic synthetic GT patches (tests / benchmarks; no disk IO):
    one seeded stream of uint8 global batches, drawn afresh every epoch,
    of which each process keeps its share."""

    def __init__(self, batch_size: int, patch_size: int = 96, n_batches: int = 64,
                 seed: int = 0, process_index: int | None = None,
                 process_count: int | None = None):
        self.batch_size = batch_size
        self.patch_size = patch_size
        self.n_batches = n_batches
        self._rng = np.random.default_rng(seed)
        self._pslice = _DeferredProcessSlice(batch_size, process_index, process_count)

    def __len__(self) -> int:
        return self.n_batches

    def epoch(self, epoch_idx: int | None = None):
        del epoch_idx  # synthetic data: every epoch is freshly drawn
        for _ in range(self.n_batches):
            batch = self._rng.integers(
                0, 256, (self.batch_size, self.patch_size, self.patch_size, 3),
                dtype=np.uint8)
            yield batch[self._pslice.get()]


def _cache_setting(device_cache):
    """DATA.DEVICE_CACHE: "auto", a bool, or a boolean word (from --set)."""
    if isinstance(device_cache, str) and device_cache != "auto":
        words = {"true": True, "1": True, "yes": True, "on": True,
                 "false": False, "0": False, "no": False, "off": False}
        if device_cache.lower() not in words:
            raise ValueError(f"DATA.DEVICE_CACHE={device_cache!r}: expected auto or a bool")
        return words[device_cache.lower()]
    return device_cache


class PackedPatchSource:
    """Decode-free training source over a packed uint8 patch archive
    (`patches.pack.npy`, written by prepare-dataset --pack): a
    memory-mapped (N, S, S, 3) uint8 array.

    Host path: each batch is a page-ordered gather on a prefetch thread.
    Resident path (`device_cache`, and a `device` to put it on): the pack
    is copied to the device once as a uint8 tensor, and each batch is a
    gather there from this process's int64 indices. Both give the same
    batches, bit for bit: the rows of the (seed, epoch)-keyed permutation
    in permutation order, each process its contiguous share. The gather is
    per batch (the JAX package gathers a chunk of CHUNK_STEPS batches at
    once for its device-side loop, which the port does not have)."""

    def __init__(self, pack_path: str, batch_size: int, seed: int = 0,
                 prefetch: int = 2, process_index: int | None = None,
                 process_count: int | None = None, device_cache="auto",
                 device_cache_budget: int = 4 << 30, device=None):
        self.pack = np.load(pack_path, mmap_mode="r")
        if self.pack.ndim != 4 or self.pack.dtype != np.uint8:
            raise ValueError(f"not a patch pack: {pack_path} {self.pack.shape}")
        if self.pack.shape[0] < batch_size:
            raise ValueError(
                f"pack smaller than one global batch: {self.pack.shape[0]} patches "
                f"in {pack_path} < batch_size {batch_size}")
        self.batch_size = batch_size
        self.patch_size = int(self.pack.shape[1])
        self.seed = seed
        self.prefetch = prefetch
        self._epoch_counter = 0
        self._pslice = _DeferredProcessSlice(batch_size, process_index, process_count)
        device_cache = _cache_setting(device_cache)
        if device_cache == "auto":
            device_cache = self.pack.nbytes <= device_cache_budget
        self.device_cache = bool(device_cache)
        self.device = None if device is None else torch.device(device)
        self._resident_pack: torch.Tensor | None = None

    def __len__(self) -> int:
        return self.pack.shape[0] // self.batch_size

    def _epoch_order(self, epoch_idx: int | None) -> np.ndarray:
        if epoch_idx is None:
            epoch_idx = self._epoch_counter
        self._epoch_counter = epoch_idx + 1
        return np.random.default_rng((self.seed, epoch_idx)).permutation(self.pack.shape[0])

    def _batch_indices(self, order: np.ndarray, b: int) -> np.ndarray:
        return order[b * self.batch_size:(b + 1) * self.batch_size][self._pslice.get()]

    def resident(self) -> torch.Tensor:
        """The pack on `device`, copied once in 256 MiB pieces (no second
        host copy of the whole pack)."""
        if self._resident_pack is None:
            dev_pack = torch.empty(self.pack.shape, dtype=torch.uint8, device=self.device)
            rows = max(1, (256 << 20) // max(1, self.pack[0].nbytes))
            for i in range(0, self.pack.shape[0], rows):
                piece = torch.from_numpy(np.array(self.pack[i:i + rows]))
                dev_pack[i:i + rows].copy_(piece)
            self._resident_pack = dev_pack
        return self._resident_pack

    def epoch(self, epoch_idx: int | None = None):
        """One shuffled epoch of this process's uint8 (B_local, S, S, 3)
        batches: device tensors gathered from the resident pack when it is
        on, else numpy arrays gathered on the prefetch thread."""
        order = self._epoch_order(epoch_idx)
        if self.device_cache and self.device is not None:
            dev_pack = self.resident()
            for b in range(len(self)):
                idx = torch.from_numpy(self._batch_indices(order, b)).to(self.device)
                yield dev_pack.index_select(0, idx)
            return

        def make_batch(b: int) -> np.ndarray:
            return _locality_gather(self.pack, self._batch_indices(order, b))

        yield from _prefetched(len(self), make_batch, self.prefetch)


def make_train_source(config, device=None):
    """The configured training source: synthetic, the packed archive
    (`patches.pack.npy` in, or named by, DATA.TRAIN_GT_IMAGES_DIR) when one
    exists, else the directory of patch images. Tiles may be larger than
    GT_IMAGE_SIZE: the train step then crops them on the device. `device`
    is where a resident pack goes (DATA.DEVICE_CACHE)."""
    tile = config.DATA.TILE_SIZE or config.DATA.GT_IMAGE_SIZE
    if config.DATA.SYNTHETIC:
        return SyntheticPatchSource(
            config.DATA.BATCH_SIZE, tile, n_batches=config.DATA.SYNTHETIC_N_BATCHES,
            seed=config.DATA.SEED)
    gt_dir = config.DATA.TRAIN_GT_IMAGES_DIR
    pack = gt_dir if gt_dir.endswith(".npy") else os.path.join(gt_dir, "patches.pack.npy")
    if os.path.exists(pack):
        return PackedPatchSource(
            pack, config.DATA.BATCH_SIZE, seed=config.DATA.SEED,
            prefetch=config.DATA.PREFETCH, device_cache=config.DATA.DEVICE_CACHE,
            device_cache_budget=config.DATA.DEVICE_CACHE_BUDGET, device=device)
    return TrainPatchSource(gt_dir, config.DATA.BATCH_SIZE, tile, seed=config.DATA.SEED,
                            num_workers=config.DATA.NUM_WORKERS,
                            prefetch=config.DATA.PREFETCH)


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
