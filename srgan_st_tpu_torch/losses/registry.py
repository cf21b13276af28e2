"""Criterion registry (port of srgan_st_tpu/losses/registry.py).

Builds name -> (fn(sr, gt) | None, weight) from the config's criterion
specs ({"kind": ..., **kwargs}). "adversarial" maps to None: the GAN step
handles it by name, with the live discriminator, as the reference does
(train.py:135-136). The port builds the kinds "pixel" and "adversarial";
any other kind raises.
"""

from __future__ import annotations

import functools
from typing import Callable

from srgan_st_tpu_torch.losses import functions as F

# canonical criterion names -> spec kind (reference config.py:77-86)
CANONICAL_KINDS = {
    "Adversarial": "adversarial",
    "Pixel": "pixel",
    "ContentVGG": "content_vgg",
    "ContentDiscriminator": "content_disc",
    "BestBuddy": "best_buddy",
    "Gram": "gram",
    "PatchwiseST": "patchwise_st",
    "ST": "st",
}

LOSS_ZOO_TODO = ("criterion kind {!r} is not ported yet (ROADMAP.md Queue A, "
                 "item 2: the loss zoo)")


def build_one(config, name: str, spec: dict) -> Callable | None:
    """fn(sr, gt) -> scalar for one criterion, or None for the
    adversarial marker."""
    spec = dict(spec)
    kind = spec.pop("kind", CANONICAL_KINDS.get(name))
    if kind is None:
        raise KeyError(f"criterion '{name}' has no kind and is not canonical")
    if kind == "adversarial":
        return None
    if kind == "pixel":
        spec.pop("allow_random_init", None)
        spec.setdefault("dtype", config.TPU.COMPUTE_DTYPE)
        return functools.partial(F.pixel_loss, **spec)
    raise NotImplementedError(LOSS_ZOO_TODO.format(kind))


def build_criterions(config) -> dict[str, tuple[Callable | None, float]]:
    """name -> (fn | None-for-adversarial, weight) for the GAN phase."""
    return {name: (build_one(config, name, spec),
                   float(config.MODEL.G_LOSS.CRITERION_WEIGHTS.get(name, 1.0)))
            for name, spec in config.MODEL.G_LOSS.CRITERIONS.items()}


def build_warmup_criterions(config) -> dict[str, tuple[Callable | None, float]]:
    """name -> (fn, weight) for the warmup phase (reference config.py:88-93)."""
    return {name: (build_one(config, name, spec),
                   float(config.MODEL.G_LOSS.WARMUP_WEIGHTS.get(name, 1.0)))
            for name, spec in config.MODEL.G_LOSS.WARMUP_CRITERIONS.items()}
