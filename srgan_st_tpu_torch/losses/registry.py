"""Criterion registry (port of srgan_st_tpu/losses/registry.py).

Builds name -> (fn(sr, gt) | None, weight) from the config's criterion
specs ({"kind": ..., **kwargs}). "adversarial" maps to None: the GAN step
handles it by name, with the live discriminator, as the reference does
(train.py:135-136). Specs of the image criteria run at TPU.COMPUTE_DTYPE
unless they pin a "dtype". The buddy kinds keep the JAX package's spec key
"pallas": False forces the plain selection, None (the default) the
hand-written kernel on CUDA tensors. The frozen feature extractors of
"content_vgg" and "content_disc" live on the step's device, moved there at
their first call.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

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

_SIMPLE_KINDS = {
    "pixel": F.pixel_loss,
    "best_buddy": F.best_buddy_loss,
    "gram": F.gram_loss,
    "patchwise_st": F.patchwise_st_loss,
    "st": F.st_loss,
}


def content_vgg(config, spec: dict):
    """The frozen VGG19 of ContentVGG at TPU.COMPUTE_DTYPE, tapped at
    MODEL.G_LOSS.VGG19_LAYERS: the npz of spec["weights"] or
    MODEL.G_LOSS.VGG19_WEIGHTS (tools/convert_vgg19.py's format). A missing
    file raises, unless spec["allow_random_init"]: then a fresh VGG19
    initialized from a torch generator seeded with 0."""
    from srgan_st_tpu_torch.core.device import compute_dtype
    from srgan_st_tpu_torch.models.vgg import VGG19Features, init_vgg19, load_vgg19_npz

    taps = tuple(config.MODEL.G_LOSS.VGG19_LAYERS)
    model = VGG19Features(taps, dtype=compute_dtype(config.TPU.COMPUTE_DTYPE))
    path = spec.get("weights", config.MODEL.G_LOSS.VGG19_WEIGHTS)
    try:
        model.load_state_dict(load_vgg19_npz(path, taps))
    except FileNotFoundError:
        if not spec.get("allow_random_init", False):
            raise FileNotFoundError(
                f"VGG19 weights not found at '{path}'. Convert the "
                "torchvision IMAGENET1K_V1 checkpoint once with "
                "tools/convert_vgg19.py, or set spec['allow_random_init']=True "
                "for testing.") from None
        init_vgg19(model, torch.Generator().manual_seed(0))
    return model


def _on_device(model: torch.nn.Module, x: torch.Tensor) -> torch.nn.Module:
    if next(model.parameters()).device != x.device:
        model.to(x.device)  # a frozen extractor lives on the step's device
    return model


def _build_content_vgg(config, spec: dict) -> Callable:
    from srgan_st_tpu_torch.models.vgg import make_vgg19_frozen_pair

    layer_weights = dict(config.MODEL.G_LOSS.VGG19_LAYERS)
    model = content_vgg(config, spec)
    criterion = spec.get("criterion", "mse")
    if spec.get("pair", False):
        pair = make_vgg19_frozen_pair(model)

        def vgg_pair(sr, gt):
            _on_device(model, sr)
            return pair(sr, gt)

        return functools.partial(F.content_loss_vgg, layer_weights=layer_weights,
                                 criterion=criterion, vgg_pair=vgg_pair)
    return functools.partial(
        F.content_loss_vgg, layer_weights=layer_weights, criterion=criterion,
        vgg_apply=lambda x: _on_device(model, x)(x), remat=spec.get("remat", False))


def content_discriminator(config, spec: dict) -> torch.nn.Module:
    """The frozen content D of ContentDiscriminator in eval mode (running
    statistics, no update; reference loss.py:263,276): the npz weights of
    spec["weights"] or MODEL.G_LOSS.DISC_FEATURES_WEIGHTS (the JAX package's
    variables or the reference's state-dict keys), else a fresh D
    initialized from a torch generator seeded with 0."""
    import numpy as np

    from srgan_st_tpu_torch.models.common import init_weights
    from srgan_st_tpu_torch.models.discriminator import Discriminator
    from srgan_st_tpu_torch.train.checkpoint import (
        discriminator_state_dict_from_variables,
        load_params_npz,
    )

    model = Discriminator.from_config(config)
    path = spec.get("weights", config.MODEL.G_LOSS.DISC_FEATURES_WEIGHTS)
    if path:
        with np.load(path) as data:
            sd = ({k: torch.from_numpy(np.asarray(data[k])) for k in data.files}
                  if all(k.startswith(("features.", "classifier.")) for k in data.files)
                  else None)
        if sd is None:
            sd = discriminator_state_dict_from_variables(load_params_npz(path))
        model.load_state_dict(sd)
    else:
        init_weights(model, torch.Generator().manual_seed(0))
    model.eval().requires_grad_(False)
    return model


def _build_content_disc(config, spec: dict) -> Callable:
    layer_weights = dict(config.MODEL.G_LOSS.DISC_FEATURES_LOSS_LAYERS)
    taps = tuple(layer_weights)
    model = content_discriminator(config, spec)

    def d_apply(x):
        return _on_device(model, x)(x, train=False, taps=taps)

    return functools.partial(F.content_loss_discriminator, d_apply=d_apply,
                             layer_weights=layer_weights,
                             criterion=spec.get("criterion", "mse"))


def build_one(config, name: str, spec: dict) -> Callable | None:
    """fn(sr, gt) -> scalar for one criterion, or None for the
    adversarial marker."""
    spec = dict(spec)
    kind = spec.pop("kind", CANONICAL_KINDS.get(name))
    if kind is None:
        raise KeyError(f"criterion '{name}' has no kind and is not canonical")
    if kind == "adversarial":
        return None
    if kind == "content_vgg":
        return _build_content_vgg(config, spec)
    if kind == "content_disc":
        return _build_content_disc(config, spec)
    if kind in _SIMPLE_KINDS:
        spec.pop("allow_random_init", None)
        spec.setdefault("dtype", config.TPU.COMPUTE_DTYPE)
        return functools.partial(_SIMPLE_KINDS[kind], **spec)
    raise NotImplementedError(f"criterion kind '{kind}' has not been implemented.")


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
