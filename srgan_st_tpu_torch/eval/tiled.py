"""Tiled (halo-padded) large-image inference (port of
srgan_st_tpu/eval/tiled.py).

Spatial tiling with receptive-field halos: every tile batch has one shape,
and device memory is bounded whatever the image size. Each tile window is
a true crop of the image, slid inward at the borders, so image borders see
the network's own zero padding exactly as whole-image inference does and
interior tile edges get >= halo pixels of true context: the output equals
the whole-image output. With `mesh` (a parallel/mesh.py DataParallel of
several processes) the tile batches are split over the ranks, whole
batches at a time so that each runs at the one-rank shape, and gathered:
the output equals the one-rank output bit for bit.

Receptive-field radius of the SRResNet generator in LR pixels:
conv1 9x9 (4) + num_rcb RCBs x 2 conv3x3 (2*num_rcb) + conv2 (1) +
upsample conv3x3 per stage (1 each) + conv3 9x9 at HR (= ceil(4/upscale))
-> 40 for the default config; of the RRDB generator
(`models/rrdb.py` `receptive_radius`) 15 a block + 4 -> 349 for 23. SwinIR
has none (`generator_halo` raises).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def to_numpy(x) -> np.ndarray:
    """A torch tensor (any device) or array-like -> numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def generator_halo(num_rcb: int = 16, upscale: int = 4, arch: str = "srresnet") -> int:
    """Receptive-field radius (LR px) of the generator `arch`
    (MODEL.G_ARCH) of `num_rcb` blocks. SwinIR raises: its windows are
    aligned to the frame's origin, which moves with a tile's, and its
    shifted windows chain the receptive field across the whole frame, so
    no halo makes a tile exact."""
    if arch == "swinir":
        raise ValueError("tiled eval: SwinIR has no exact halo (its windows align to the "
                         "frame's origin and shifted windows chain over the frame); serve it "
                         "whole")
    if arch == "rrdb":
        from srgan_st_tpu_torch.models.rrdb import receptive_radius

        return receptive_radius(num_rcb)
    n_up = int(math.log2(upscale)) if upscale in (2, 4, 8) else 1
    return 4 + 2 * num_rcb + 1 + n_up + max(1, -(-4 // upscale))


class TiledApplier:
    """Wraps an NHWC (B, h, w, C) -> (B, h*s, w*s, C) apply_fn so arbitrary
    image sizes run through fixed-shape tile batches. Images smaller than
    one padded window go to apply_fn whole. Returns numpy."""

    def __init__(self, apply_fn, upscale: int, tile: int = 64, halo: int = 40,
                 tile_batch: int = 16, mesh=None):
        self.apply_fn = apply_fn
        self.upscale = upscale
        self.tile = tile
        self.halo = halo
        self.tile_batch = tile_batch
        self.mesh = mesh

    def __call__(self, lr) -> np.ndarray:
        lr = to_numpy(lr)
        b, h, w, c = lr.shape
        t, r, s = self.tile, self.halo, self.upscale
        win = t + 2 * r
        if h < win or w < win:
            return to_numpy(self.apply_fn(lr))
        if b != 1:
            # the tiling path below reads lr[0]; tile each image separately
            return np.concatenate([self(lr[i:i + 1]) for i in range(b)], 0)

        ys = list(range(0, h, t))
        xs = list(range(0, w, t))
        tiles = np.empty((len(ys) * len(xs), win, win, c), dtype=lr.dtype)
        offsets = []  # (oy, ox, out_h, out_w) per tile, in LR pixels
        for i, y in enumerate(ys):
            for j, x in enumerate(xs):
                wy = min(max(y - r, 0), h - win)
                wx = min(max(x - r, 0), w - win)
                tiles[i * len(xs) + j] = lr[0, wy:wy + win, wx:wx + win]
                offsets.append((y - wy, x - wx, min(t, h - y), min(t, w - x)))

        tb = self.tile_batch
        batches = []
        for k in range(0, len(tiles), tb):
            batch = tiles[k:k + tb]
            if len(batch) < tb:
                batch = np.concatenate([batch, np.repeat(batch[:1], tb - len(batch), 0)])
            batches.append(batch)
        if self.mesh is not None and self.mesh.active:
            outs = self._sharded(batches)
        else:
            outs = [to_numpy(self.apply_fn(batch)) for batch in batches]
        sr_tiles = np.concatenate(outs, axis=0)[:len(tiles)]

        result = np.empty((1, h * s, w * s, c), dtype=sr_tiles.dtype)
        idx = 0
        for y in ys:
            for x in xs:
                oy, ox, oh, ow = offsets[idx]
                crop = sr_tiles[idx, oy * s:(oy + oh) * s, ox * s:(ox + ow) * s]
                result[0, y * s:(y + oh) * s, x * s:(x + ow) * s] = crop
                idx += 1
        return result

    def _sharded(self, batches: list) -> list:
        """Rank r runs batches r, r + W, ...; one all_gather of every rank's
        outputs (on their device, the rank's share padded to the same
        count) returns all of them to every rank."""
        import torch.distributed as dist

        w, r = self.mesh.world_size, self.mesh.rank
        per = -(-len(batches) // w)
        mine = [torch.as_tensor(self.apply_fn(b)) for b in batches[r::w]]
        if not mine:  # fewer batches than ranks: this rank computes one to pad
            mine = [torch.as_tensor(self.apply_fn(batches[0]))]
        local = torch.stack(mine + [torch.zeros_like(mine[0])] * (per - len(mine)))
        gathered = [torch.empty_like(local) for _ in range(w)]
        dist.all_gather(gathered, local.contiguous())
        return [to_numpy(gathered[k % w][k // w]) for k in range(len(batches))]
