"""Helpers of the training loops (port of srgan_st_tpu/train/utils.py)."""

from __future__ import annotations

import numpy as np
import torch


def iter_chunks(source, epoch_idx: int, chunk_size: int):
    """An epoch's batches in lists of `chunk_size` (the last may be
    shorter). Each batch stays the source's own (a host array, or a device
    tensor gathered from the resident pack): a chunk step takes them one
    by one, so nothing is stacked (the JAX package's `iter_chunks` stacks
    a (K, B, ...) array for its scan)."""
    chunk = []
    for batch in source.epoch(epoch_idx):
        chunk.append(batch)
        if len(chunk) == chunk_size:
            yield chunk
            chunk = []
    if chunk:
        yield chunk


def resolve_chunk_steps(config, interval: int, steps_per_epoch: int) -> int:
    """Chunk size: TPU.CHUNK_STEPS, else the natural interval
    (D_UPDATE_INTERVAL for GAN, LOG_TRAIN_PERIOD for warmup), capped to the
    epoch length. An override is normalized to a divisor of the interval:
    chunk boundaries are the only points where the D update and the log
    check run, so a non-divisor would skip interval hits (e.g.
    CHUNK_STEPS=64 with interval 100 lands on a multiple of 100 only every
    1600 batches). The JAX package's rule and message
    (srgan_st_tpu/train/utils.py:58-80)."""
    import math

    chunk = config.TPU.get("CHUNK_STEPS") or interval
    chunk = max(1, min(chunk, steps_per_epoch))
    # interval multiples can fall mid-chunk only when the epoch holds one
    # beyond batch 0 (epoch starts are always chunk starts)
    if steps_per_epoch > interval and (chunk > interval or interval % chunk):
        normalized = math.gcd(min(chunk, interval), interval)
        print(f"TPU.CHUNK_STEPS={chunk} does not divide the interval "
              f"{interval}; using {normalized} to keep the update cadence")
        chunk = normalized
    return chunk


def make_test_pairs(config):
    """Eval pairs: the configured paired test set, or — in synthetic mode —
    three seeded (gt, lr) pairs degraded with the training degradation, so
    validation stays meaningful in tests and smoke runs."""
    if not config.DATA.SYNTHETIC:
        from srgan_st_tpu_torch.data.pipeline import TestPairSource

        return TestPairSource(config.DATA.TEST_GT_IMAGES_DIR, config.DATA.TEST_LR_IMAGES_DIR)
    from srgan_st_tpu_torch.ops.resize import resize_bicubic

    rng = np.random.default_rng(config.DATA.SEED + 1)
    size = config.DATA.GT_IMAGE_SIZE
    pairs = []
    for _ in range(3):
        gt = rng.random((1, size, size, 3)).astype(np.float32)
        lr = resize_bicubic(torch.from_numpy(gt), 1.0 / config.DATA.UPSCALE_FACTOR)
        pairs.append((gt, lr.numpy()))
    return pairs


def setup_run(config, device=None):
    """A training loop's start: the process group when the run has several
    processes (parallel/distributed.py), this process's device (a missing
    GPU raises), and the data-parallel group. Returns (device, mesh)."""
    from srgan_st_tpu_torch.core.device import resolve_device
    from srgan_st_tpu_torch.parallel.distributed import initialize_distributed, rank_device
    from srgan_st_tpu_torch.parallel.mesh import make_mesh

    dev = resolve_device(device)
    initialize_distributed(device=dev)
    dev = rank_device(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev, make_mesh(config)
