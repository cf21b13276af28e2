"""Everything a run makes from its seed, on the device, in a few large
calls of one `torch.Generator`: the weights of G, D and the frozen
content D by their state-dict names (the names both the program and
`benchmark/reference` read), the pool of GT patches, and the LR frames of
the serving chain. The same seed gives the same tensors."""

from __future__ import annotations

import math
import os

import numpy as np
import torch

# the content D is frozen, as the reference's is (loss.py:263): one set of
# weights for every run, from this seed, in a file both sides read
CONTENT_D_SEED = 0


def generator_for(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


class _Draws:
    """Slices of one normal and one uniform draw, handed out in order."""

    def __init__(self, gen: torch.Generator, n_normal: int, n_uniform: int, device):
        self.normal = torch.randn(n_normal, generator=gen, device=device)
        self.uniform = torch.rand(n_uniform, generator=gen, device=device)
        self._n = self._u = 0

    def randn(self, shape):
        k = math.prod(shape)
        out = self.normal[self._n:self._n + k].view(shape)
        self._n += k
        return out

    def rand(self, shape, lo=0.0, hi=1.0):
        k = math.prod(shape)
        out = self.uniform[self._u:self._u + k].view(shape)
        self._u += k
        return lo + (hi - lo) * out


def _generator_shapes(cfg: dict) -> list[tuple[str, tuple]]:
    c, cin, cout = cfg["g_channels"], cfg["g_in_channels"], cfg["g_out_channels"]
    shapes = [("conv1.0.weight", (c, cin, 9, 9)), ("conv1.0.bias", (c,)),
              ("conv1.1.weight", (1,))]
    for i in range(cfg["g_num_rcb"]):
        b = f"trunk.{i}.rcb"
        shapes += [(f"{b}.0.weight", (c, c, 3, 3)), (f"{b}.1", (c,)), (f"{b}.2.weight", (1,)),
                   (f"{b}.3.weight", (c, c, 3, 3)), (f"{b}.4", (c,))]
    shapes += [("conv2.0.weight", (c, c, 3, 3)), ("conv2.1", (c,))]
    for i in range(int(round(math.log2(cfg["upscale_factor"])))):
        b = f"upsampling.{i}.upsample_block"
        shapes += [(f"{b}.0.weight", (4 * c, c, 3, 3)), (f"{b}.0.bias", (4 * c,)),
                   (f"{b}.2.weight", (1,))]
    shapes += [("conv3.weight", (cout, c, 9, 9)), ("conv3.bias", (cout,))]
    return shapes


def _discriminator_shapes(cfg: dict) -> list[tuple[str, tuple]]:
    c, cin = cfg["d_channels"], cfg["d_in_channels"]
    shapes = [("features.0.weight", (c, cin, 3, 3)), ("features.0.bias", (c,))]
    prev = c
    for j, mult in enumerate((1, 2, 2, 4, 4, 8, 8)):
        i = 2 + 3 * j
        shapes += [(f"features.{i}.weight", (mult * c, prev, 3, 3)), (f"features.{i + 1}",
                                                                      (mult * c,))]
        prev = mult * c
    side = cfg["gt_image_size"] // 16
    shapes += [("classifier.0.weight", (1024, prev * side * side)),
               ("classifier.0.bias", (1024,)),
               ("classifier.2.weight", (cfg["d_out_channels"], 1024)),
               ("classifier.2.bias", (cfg["d_out_channels"],))]
    return shapes


def _state(shapes, gen, device, serving: bool) -> dict:
    """Training init, the reference's (model.py:130-136): kaiming-normal
    conv kernels (fan in, gain sqrt 2), lecun-normal dense kernels, zero
    biases, BN scale 1 / bias 0 / statistics (0, 1), PReLU slopes 0.25.
    `serving` instead draws weights that keep a deep eval forward in range:
    kernels N(0, 1/fan_in), conv biases 0.1 N, BN scales U(0.5, 1), biases
    0.1 N, running means 0.1 N and variances U(0.5, 1.5), slopes
    U(0.1, 0.3), and the last conv halved with a 0.5 bias, so that most of
    the output lies inside (0, 1)."""
    is_bn = [not n.endswith(("weight", "bias")) for n, _ in shapes]
    sizes = [math.prod(s) for _, s in shapes]
    n_normal = sum(2 * k if bn else k for k, bn in zip(sizes, is_bn))
    n_uniform = sum(2 * k if bn else k for k, bn in zip(sizes, is_bn) if bn or k == 1)
    draws = _Draws(gen, n_normal, n_uniform, device)
    sd = {}
    last = shapes[-2][0]
    for name, shape in shapes:
        if not name.endswith(("weight", "bias")):  # a BatchNorm: (C,)
            if serving:
                sd[f"{name}.weight"] = draws.rand(shape, 0.5, 1.0)
                sd[f"{name}.bias"] = 0.1 * draws.randn(shape)
                sd[f"{name}.running_mean"] = 0.1 * draws.randn(shape)
                sd[f"{name}.running_var"] = draws.rand(shape, 0.5, 1.5)
            else:
                sd[f"{name}.weight"] = torch.ones(shape, device=device)
                sd[f"{name}.bias"] = torch.zeros(shape, device=device)
                sd[f"{name}.running_mean"] = torch.zeros(shape, device=device)
                sd[f"{name}.running_var"] = torch.ones(shape, device=device)
            sd[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=device)
        elif shape == (1,):  # a PReLU slope
            sd[name] = draws.rand(shape, 0.1, 0.3) if serving else torch.full(
                shape, 0.25, device=device)
        elif name.endswith("bias"):
            sd[name] = (0.1 * draws.randn(shape) if serving
                        else torch.zeros(shape, device=device))
        else:
            fan_in = math.prod(shape[1:])
            gain = 1.0 if serving or len(shape) == 2 else math.sqrt(2.0)
            sd[name] = draws.randn(shape) * (gain / math.sqrt(fan_in))
            if serving and name == last:
                sd[name] = 0.5 * sd[name]
    if serving and last.startswith("conv3"):
        sd["conv3.bias"] = torch.full_like(sd["conv3.bias"], 0.5)
    return sd


def generator_state(cfg: dict, gen, device, serving: bool = False) -> dict:
    return _state(_generator_shapes(cfg), gen, device, serving)


def discriminator_state(cfg: dict, gen, device) -> dict:
    return _state(_discriminator_shapes(cfg), gen, device, False)


def content_d_file(cfg: dict, root: str, device) -> str:
    """The frozen content D's weights (the training init from
    CONTENT_D_SEED) as an npz under `root`, written once (atomically) and
    read by the program (MODEL.G_LOSS.DISC_FEATURES_WEIGHTS) and by the
    reference alike; float16 keeps the file at half the size."""
    path = os.path.join(root, f"content_d_{cfg['d_channels']}_{CONTENT_D_SEED}.npz")
    if os.path.exists(path):
        return path
    os.makedirs(root, exist_ok=True)
    sd = discriminator_state(cfg, generator_for(CONTENT_D_SEED, device), device)
    arrays = {k: (v.to(torch.float16) if v.is_floating_point() else v).cpu().numpy()
              for k, v in sd.items()}
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)
    return path


def load_npz_state(path: str, device) -> dict:
    with np.load(path) as data:
        return {k: torch.from_numpy(np.asarray(data[k])).to(device) for k in data.files}


def patch_pool(gen, n_batches: int, batch: int, size: int, device) -> torch.Tensor:
    """(n_batches, batch, size, size, 3) uint8 GT patches: band-limited
    sinusoids with noise, each patch and channel its own frequency and
    phase (the pattern of the program's bench pack, `ensure_pack` in
    srgan_st_tpu_torch/tools/bench.py, here drawn on the device)."""
    n = n_batches * batch
    yy = torch.arange(size, device=device, dtype=torch.float32).view(1, 1, size, 1)
    xx = torch.arange(size, device=device, dtype=torch.float32).view(1, 1, 1, size)
    r = torch.rand((3, n, 3, 1, 1), generator=gen, device=device)
    fx, fy = 0.02 + 0.28 * r[0], 0.02 + 0.28 * r[1]
    ph = 2 * math.pi * r[2]
    img = 0.5 + 0.35 * torch.sin(fx * xx + fy * yy + ph)
    img = img + 0.04 * torch.randn(img.shape, generator=gen, device=device)
    u8 = (img.clamp(0, 1) * 255).round().to(torch.uint8)
    return u8.permute(0, 2, 3, 1).reshape(n_batches, batch, size, size, 3).contiguous()


def next_lr(sr: torch.Tensor, x: torch.Tensor, z: torch.Tensor, i: int, s: int) -> torch.Tensor:
    """The serving chain's next LR frame: the s x s average pool of this
    SR frame (every HR pixel is consumed), mixed with a noise frame, plus
    1e-7 i, in x's dtype (`next_lr` of srgan_st_tpu_torch/tools/bench.py,
    from bench.py:346-356)."""
    b, hh, ww, c = sr.shape
    pooled = sr.reshape(b, hh // s, s, ww // s, s, c).mean((2, 4))
    return (0.5 * pooled + 0.5 * z + float(np.float32(1e-7) * np.float32(i))).to(x.dtype)
