"""Feature-map figures for the content losses (port of
srgan_st_tpu/viz/feature_maps.py; the reference's
contentlosses-visualization notebook): grids of the VGG19 or
discriminator tap activations of an image, to inspect what the perceptual
losses compare.

`feature_maps` is the array core: an RGB image in [0, 1] in, {tap: NHWC
activations} on the device out. The extractors are those of the losses:
`vgg`, VGG19Features at MODEL.G_LOSS.VGG19_LAYERS on the
MODEL.G_LOSS.VGG19_WEIGHTS npz, and `disc`, the discriminator in eval mode
at MODEL.G_LOSS.DISC_FEATURES_LOSS_LAYERS, both on ImageNet-normalized
input. Without a VGG19 file, and for the discriminator unless `variables`
are given, the weights are a random init from a torch generator seeded
with 0 (the JAX tool draws from `jax.random.key(0)`: other numbers). The
discriminator runs at the image's own size: its taps stop before the
classifier, whose input size is the only size-dependent weight, so a JAX
variables tree made at any size carries its convs and BatchNorms over.

Usage:
    python -m srgan_st_tpu_torch feature-maps --image img.png \
        --extractor disc --out figures/ [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch


def _activation_grid(act: np.ndarray, max_maps: int = 64) -> np.ndarray:
    """(H, W, C) activations -> tiled grayscale grid image (uint8)."""
    h, w, c = act.shape
    c = min(c, max_maps)
    cols = int(math.ceil(math.sqrt(c)))
    rows = int(math.ceil(c / cols))
    grid = np.zeros((rows * h, cols * w), np.float32)
    for i in range(c):
        fm = act[..., i]
        lo, hi = fm.min(), fm.max()
        fm = (fm - lo) / max(hi - lo, 1e-6)
        r, col = divmod(i, cols)
        grid[r * h:(r + 1) * h, col * w:(col + 1) * w] = fm
    return (grid * 255.0 + 0.5).astype(np.uint8)


def _vgg(config, dev) -> torch.nn.Module:
    from srgan_st_tpu_torch.models.vgg import VGG19Features, init_vgg19, load_vgg19_npz

    taps = tuple(config.MODEL.G_LOSS.VGG19_LAYERS)
    model = VGG19Features(taps=taps)
    try:
        model.load_state_dict(load_vgg19_npz(config.MODEL.G_LOSS.VGG19_WEIGHTS, taps))
    except FileNotFoundError:
        init_vgg19(model, torch.Generator().manual_seed(0))
    return model.to(dev)


def _disc(config, dev, variables=None) -> torch.nn.Module:
    from srgan_st_tpu_torch.models.common import init_weights
    from srgan_st_tpu_torch.models.discriminator import Discriminator
    from srgan_st_tpu_torch.train.checkpoint import (
        discriminator_state_dict_from_variables, merge_tolerant,
        variables_from_discriminator_state_dict,
    )

    model = Discriminator.from_config(config)
    init_weights(model, torch.Generator().manual_seed(0))
    if variables is not None:
        own = variables_from_discriminator_state_dict(model.state_dict())
        model.load_state_dict(discriminator_state_dict_from_variables(
            merge_tolerant(own, variables)))
    return model.to(dev).eval()


@torch.no_grad()
def feature_maps(config, img01: np.ndarray, extractor: str = "disc", variables=None,
                 device=None) -> dict[str, torch.Tensor]:
    """{tap: (1, h, w, c) activations} of the (H, W, 3) image `img01` in
    [0, 1] on the device (CUDA unless `device` says otherwise). `variables`:
    a JAX-format discriminator variables tree for `disc`, merged by the
    tolerant loader's rule (same-shaped leaves only)."""
    from srgan_st_tpu_torch.core.device import resolve_device
    from srgan_st_tpu_torch.ops.color import imagenet_normalize

    dev = resolve_device(device)
    x = imagenet_normalize(torch.as_tensor(np.asarray(img01, np.float32)[None], device=dev))
    if extractor == "vgg":
        return _vgg(config, dev)(x)
    if extractor == "disc":
        taps = tuple(config.MODEL.G_LOSS.DISC_FEATURES_LOSS_LAYERS)
        return _disc(config, dev, variables)(x, train=False, taps=taps)
    raise ValueError(f"unknown extractor {extractor}")


def activation_grids(feats: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """{tap: uint8 grid} of the first image's activations."""
    return {name: _activation_grid(act[0].float().cpu().numpy())
            for name, act in feats.items()}


def render_feature_maps(config, image_path: str, extractor: str = "disc",
                        out_dir: str = "figures", device=None, variables=None
                        ) -> list[str]:
    """Write `{stem}_{extractor}_{tap}.png` grey grids; returns the paths."""
    from srgan_st_tpu_torch.data.pipeline import _decode_rgb
    from srgan_st_tpu_torch.viz.save_image_patch import write_rgb_png

    img = _decode_rgb(image_path).astype(np.float32) / 255.0
    grids = activation_grids(feature_maps(config, img, extractor, variables, device))
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(image_path))[0]
    written = []
    for name, grid in grids.items():
        path = os.path.join(out_dir, f"{stem}_{extractor}_{name.replace('.', '_')}.png")
        write_rgb_png(path, grid)
        written.append(path)
    return written


def main(argv=None) -> None:
    from srgan_st_tpu_torch.core.config import Config

    p = argparse.ArgumentParser()
    p.add_argument("--image", required=True)
    p.add_argument("--extractor", choices=["vgg", "disc"], default="disc")
    p.add_argument("--out", default="figures")
    p.add_argument("--device", type=str, default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    for path in render_feature_maps(Config(), args.image, args.extractor, args.out,
                                    device=args.device):
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
