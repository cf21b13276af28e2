"""VGG19 feature extractor of the perceptual content loss (port of
srgan_st_tpu/models/vgg.py).

The reference taps torchvision's pretrained VGG19 (IMAGENET1K_V1) at the
Sequential nodes "features.17" / "features.26" / "features.35" (reference
loss.py:46-49, config.py:60-64): relu3_4, relu4_4 and relu5_4. The weights
come from `tools/convert_vgg19.py`'s npz (HWIO kernels under the torch keys
"features.{i}.weight" / ".bias"), read by `load_vgg19_npz`, or from a torch
`features.*` state dict (OIHW), read by `load_vgg19_state_dict`. The module
keeps torchvision's Sequential indices, so both load into it by key.

The parameters are float32 and frozen (reference loss.py:50-52
`requires_grad_(False)`); each conv casts them to the compute dtype at use,
as the JAX module runs at TPU.COMPUTE_DTYPE. The JAX stem's packed-GEMM
image gradient (ops/fastgrad.py) is a TPU lowering of the same function:
here the stem is a plain 3x3 conv.

`make_vgg19_frozen_pair` runs sr and gt in one batch-concatenated forward
with a hand-written backward that reaches sr only (the JAX package's
custom_vjp of the same name), opt-in through the ContentVGG spec's "pair".
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from srgan_st_tpu_torch.models.common import Conv2d

# torchvision vgg19.features layout: (kind, out_channels) per conv / pool
# entry; a ReLU follows every conv
VGG19_LAYOUT: list[tuple[str, int]] = (
    [("conv", 64), ("conv", 64), ("pool", 0)]
    + [("conv", 128), ("conv", 128), ("pool", 0)]
    + [("conv", 256)] * 4 + [("pool", 0)]
    + [("conv", 512)] * 4 + [("pool", 0)]
    + [("conv", 512)] * 4 + [("pool", 0)]
)


def _torch_indices() -> list[tuple[int, str, int]]:
    """(torch Sequential index, kind, channels) of each conv and pool,
    counting the ReLU modules between them."""
    out, idx = [], 0
    for kind, ch in VGG19_LAYOUT:
        out.append((idx, kind, ch))
        idx += 2 if kind == "conv" else 1
    return out


def expected_torch_shapes() -> dict[str, tuple[int, ...]]:
    """torchvision `features.*` tensor shapes (OIHW) of VGG19 IMAGENET1K_V1,
    the ground truth of weights/vgg19_imagenet.MANIFEST.json."""
    shapes: dict[str, tuple[int, ...]] = {}
    cin = 3
    for idx, kind, cout in _torch_indices():
        if kind == "conv":
            shapes[f"features.{idx}.weight"] = (cout, cin, 3, 3)
            shapes[f"features.{idx}.bias"] = (cout,)
            cin = cout
    return shapes


def _deepest(taps) -> int:
    return max(int(t.split(".")[1]) for t in taps)


def _plan(taps) -> list[tuple[int, str]]:
    """(index, kind) of the convs and pools up to the deepest tap: a tap
    "features.i" is the output of the ReLU at i (a conv's index + 1) or of
    the pool at i."""
    deepest = _deepest(taps)
    return [(idx, kind) for idx, kind, _ in _torch_indices() if idx <= deepest]


class VGG19Features(nn.Module):
    """vgg19.features up to the deepest tap; forward(x NHWC) -> {tap: NHWC
    activation} in `dtype`. Parameters are frozen float32 and cast to
    `dtype` at use."""

    def __init__(self, taps, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.taps = tuple(taps)
        self.dtype = dtype
        layers: list[nn.Module] = []
        cin = 3
        for idx, kind, cout in _torch_indices():
            if idx > _deepest(self.taps):
                break
            if kind == "conv":
                layers += [Conv2d(cin, cout, 3, 1, 1), nn.ReLU()]
                cin = cout
            else:
                layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)
        self.requires_grad_(False)
        self.to(memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        h = x.to(self.dtype).permute(0, 3, 1, 2)
        outputs = {}
        for i, layer in enumerate(self.features):
            h = layer(h)
            if f"features.{i}" in self.taps:
                outputs[f"features.{i}"] = h.permute(0, 2, 3, 1)
        return outputs


@torch.no_grad()
def init_vgg19(model: VGG19Features, generator: torch.Generator) -> None:
    """Flax nn.Conv's default initializers on every conv (lecun-normal
    kernels: a normal of variance 1/fan_in truncated at 2 std; zero
    biases), drawn from `generator`."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            std = (1.0 / (m.in_channels * 9)) ** 0.5 / 0.87962566103423978
            w = torch.empty(m.weight.shape)  # contiguous: drawn in order, fast
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
            m.weight.copy_(w)
            nn.init.zeros_(m.bias)


def _checked(get, keys, taps, source: str, hwio: bool) -> dict[str, torch.Tensor]:
    """The OIHW state dict of the convs the taps need, from `get(key)`,
    with the JAX loader's errors on a missing or mis-shaped key."""
    expected = expected_torch_shapes()
    sd = {}
    for idx, kind in _plan(taps):
        if kind != "conv":
            continue
        wk, bk = f"features.{idx}.weight", f"features.{idx}.bias"
        if wk not in keys or bk not in keys:
            raise ValueError(
                f"{source} is missing {wk}/{bk} — not a VGG19 weight archive "
                f"deep enough for taps {taps}? Regenerate with "
                f"tools/convert_vgg19.py")
        o, i, kh, kw = expected[wk]
        w = np.asarray(get(wk), np.float32)
        want = (kh, kw, i, o) if hwio else (o, i, kh, kw)
        if w.shape != want:
            raise ValueError(
                f"{source}: {wk} has shape {w.shape}, expected "
                f"{'HWIO' if hwio else 'OIHW'} {want} (torchvision VGG19 "
                f"IMAGENET1K_V1 layout; see weights/vgg19_imagenet.MANIFEST.json)")
        sd[wk] = torch.from_numpy(np.ascontiguousarray(
            w.transpose(3, 2, 0, 1) if hwio else w))
        sd[bk] = torch.from_numpy(np.asarray(get(bk), np.float32).copy())
    return sd


def load_vgg19_npz(path: str, taps) -> dict[str, torch.Tensor]:
    """tools/convert_vgg19.py's npz (HWIO kernels) -> the OIHW state dict of
    VGG19Features(taps), keeping the convs the taps need."""
    with np.load(path) as data:
        return _checked(data.__getitem__, set(data.files), taps, path, hwio=True)


def load_vgg19_state_dict(state_dict: dict, taps) -> dict[str, torch.Tensor]:
    """A torch `features.*` state dict (OIHW; torchvision's, or the
    trajectory golden's stub) -> the state dict of VGG19Features(taps)."""
    def get(k):
        v = state_dict[k]
        return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v

    return _checked(get, set(state_dict), taps, "the state dict", hwio=False)


class _FrozenPair(torch.autograd.Function):
    """One forward over cat([sr, gt]); the backward reaches sr only."""

    @staticmethod
    def forward(ctx, sr_n, gt_n, model):
        b = sr_n.shape[0]
        x = torch.cat([sr_n, gt_n]).to(model.dtype).permute(0, 3, 1, 2)
        feats_sr, feats_gt, res = [], [], []
        for i, layer in enumerate(model.features):
            x = layer(x)
            if isinstance(layer, nn.ReLU):
                res.append(x[:b])  # the relu masks and the pools' inputs
            if f"features.{i}" in model.taps:
                feats_sr.append(x[:b].permute(0, 2, 3, 1))
                feats_gt.append(x[b:].permute(0, 2, 3, 1))
        ctx.model = model
        ctx.sr_dtype = sr_n.dtype
        ctx.gt_meta = (gt_n.shape, gt_n.dtype, gt_n.device)
        ctx.save_for_backward(*res)
        return (*feats_sr, *feats_gt)

    @staticmethod
    def backward(ctx, *cts):
        model = ctx.model
        res = list(ctx.saved_tensors)
        taps = [f"features.{i}" for i in range(len(model.features))
                if f"features.{i}" in model.taps]
        ct_sr = {t: c for t, c in zip(taps, cts[:len(taps)])}  # gt's are dropped
        ct = None
        for i in reversed(range(len(model.features))):
            layer = model.features[i]
            tap = ct_sr.get(f"features.{i}")
            if tap is not None:  # summed in at its own depth, before the mask
                tap = tap.permute(0, 3, 1, 2)
                ct = tap if ct is None else ct + tap
            if ct is None:
                continue
            if isinstance(layer, nn.ReLU):
                ct = torch.where(res.pop() > 0, ct, torch.zeros_like(ct))
            elif isinstance(layer, nn.Conv2d):
                # the input gradient of a SAME 3x3 conv: the conv with the
                # spatially flipped, in/out-transposed kernel
                w = layer.weight.to(ct.dtype).flip((2, 3)).transpose(0, 1)
                ct = F.conv2d(ct, w, padding=1)
            else:  # the max-pool backward on the pool's saved input
                with torch.enable_grad():
                    z = res[-1].detach().requires_grad_()
                    (ct,) = torch.autograd.grad(layer(z), z, ct)
        shape, dtype, device = ctx.gt_meta
        return (ct.permute(0, 2, 3, 1).to(ctx.sr_dtype),
                torch.zeros(shape, dtype=dtype, device=device), None)


def make_vgg19_frozen_pair(model: VGG19Features):
    """`pair(sr_n, gt_n) -> (feats_sr, feats_gt)`: ONE forward of `model`
    over the batch-concatenated pair, with a hand-written backward through
    the sr half only (relu masks on strictly positive activations, the
    max-pool backward, each conv's input gradient by its flipped,
    transposed kernel). Frozen-pair contract, as in the JAX package: the
    gradient to gt is zero and the weights get none; gt enters as data.

    relu'(0): the mask credits strictly positive activations (torch's
    semantics); the JAX autodiff of `maximum` gives 0.5 at exactly 0, a
    set of measure zero for float activations."""
    taps = [f"features.{i}" for i in range(len(model.features))
            if f"features.{i}" in model.taps]

    def pair(sr_n, gt_n):
        out = _FrozenPair.apply(sr_n, gt_n, model)
        k = len(taps)
        return dict(zip(taps, out[:k])), dict(zip(taps, out[k:]))

    return pair
