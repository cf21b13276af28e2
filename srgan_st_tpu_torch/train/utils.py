"""Helpers of the training loops (port of srgan_st_tpu/train/utils.py)."""

from __future__ import annotations

import numpy as np
import torch


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
