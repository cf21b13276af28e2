"""SwinIR (Liang et al., arXiv:2108.10257; models/network_swinir.py of
github.com/JingyunLiang/SwinIR) with the `nearest+conv` upsampler of its
real-world SR model (main_test_swinir.py, task `real_sr`: SwinIR(upscale=4,
in_chans=3, img_size=64, window_size=8, img_range=1., depths=[6]*6,
embed_dim=180, num_heads=[6]*6, mlp_ratio=2, upsampler='nearest+conv',
resi_connection='1conv')), as plain functions of a parameter dict keyed by
SwinIR's state-dict names:

  conv_first, patch_embed.norm,
  layers.{i}.residual_group.blocks.{j}.{norm1, attn.qkv,
    attn.relative_position_bias_table, attn.proj, norm2, mlp.fc1, mlp.fc2},
  layers.{i}.conv, norm, conv_after_body, conv_before_upsample.0,
  conv_up1, conv_up2, conv_hr, conv_last

(convs OIHW, linears (out, in), each with a bias; LayerNorms weight and
bias). The window, the heads, the RSTBs and their depth are read from the
shapes. Float32 with TF32 off; LayerNorm eps 1e-5, GELU exact (erf),
LeakyReLU 0.01 after conv_before_upsample (torch's default, as
network_swinir.py has it) and 0.2 in the HR stage.

Departures from network_swinir.py: input and output are NHWC (its are
NCHW); the output is clamped to [0, 1], as main_test_swinir.py clamps it
(the network's forward does not); the shift mask is computed for the
frame's padded size, as the network does whenever that size is not its
img_size, so `attn_mask` and `relative_position_index` are never read from
a state dict (the index is computed here as the network computes it);
dropout and drop-path are the identity (eval). The network's rule that
sets the shift to 0 where img_size (64) is at most the window never acts
at the published window of 8, and is left out. Only the x4 `nearest+conv`
upsampler with `1conv` residual connections."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.train import full_float32

MEAN = (0.4488, 0.4371, 0.4040)  # network_swinir.py's rgb_mean for in_chans == 3
MASKED = -100.0                  # calculate_mask's value across the rolled regions
LN_EPS = 1e-5


def conv(x, p, name, quant=None):
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if quant is not None:
        x, w = quant(x, "act"), quant(w, "weight")
    return F.conv2d(x, w, None, 1, 1) + b.view(1, -1, 1, 1)


def linear(x, p, name, quant=None):
    w, b = p[f"{name}.weight"], p[f"{name}.bias"]
    if quant is not None:
        x, w = quant(x, "act"), quant(w, "weight")
    return F.linear(x, w) + b


def matmul(a, b, quant=None):
    if quant is not None:
        a, b = quant(a, "act"), quant(b, "act")
    return a @ b


def layer_norm(x, p, name):
    return F.layer_norm(x, (x.shape[-1],), p[f"{name}.weight"], p[f"{name}.bias"], LN_EPS)


def relative_position_index(ws: int) -> torch.Tensor:
    """WindowAttention's relative_position_index: (ws^2, ws^2) into the
    (2 ws - 1)^2 rows of the bias table."""
    coords = torch.stack(torch.meshgrid(torch.arange(ws), torch.arange(ws), indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def window_partition(x, ws):
    b, h, w, c = x.shape
    x = x.view(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, ws, ws, c)


def window_reverse(windows, ws, h, w):
    b = int(windows.shape[0] / (h * w / ws / ws))
    x = windows.view(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, w, -1)


def attention_mask(h: int, w: int, ws: int, shift: int, device=None) -> torch.Tensor:
    """SwinTransformerBlock.calculate_mask: (nW, ws^2, ws^2), 0 within a
    region of the rolled map and -100 across two."""
    img_mask = torch.zeros((1, h, w, 1), device=device)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mask_windows = window_partition(img_mask, ws).view(-1, ws * ws)
    mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return mask.masked_fill(mask != 0, MASKED).masked_fill(mask == 0, 0.0)


def window_attention(x, p, name, heads, ws, mask, quant=None):
    """WindowAttention.forward on (B_, N, C) windows."""
    b_, n, c = x.shape
    qkv = linear(x, p, f"{name}.qkv", quant).reshape(b_, n, 3, heads, c // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    q = q * (c // heads) ** -0.5
    attn = matmul(q, k.transpose(-2, -1), quant)
    index = relative_position_index(ws).to(x.device)
    bias = p[f"{name}.relative_position_bias_table"][index.view(-1)].view(n, n, -1)
    attn = attn + bias.permute(2, 0, 1).contiguous().unsqueeze(0)
    if mask is not None:
        nw = mask.shape[0]
        attn = attn.view(b_ // nw, nw, heads, n, n) + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, n, n)
    attn = torch.softmax(attn, -1)
    out = matmul(attn, v, quant).transpose(1, 2).reshape(b_, n, c)
    return linear(out, p, f"{name}.proj", quant)


def swin_block(x, x_size, p, name, heads, ws, shift, quant=None):
    """SwinTransformerBlock.forward on (B, H W, C) tokens."""
    h, w = x_size
    b, _, c = x.shape
    shortcut = x
    x = layer_norm(x, p, f"{name}.norm1").view(b, h, w, c)
    if shift > 0:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
    windows = window_partition(x, ws).view(-1, ws * ws, c)
    mask = attention_mask(h, w, ws, shift, x.device).to(x.dtype) if shift > 0 else None
    windows = window_attention(windows, p, f"{name}.attn", heads, ws, mask, quant)
    x = window_reverse(windows.view(-1, ws, ws, c), ws, h, w)
    if shift > 0:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    x = shortcut + x.view(b, h * w, c)
    y = F.gelu(linear(layer_norm(x, p, f"{name}.norm2"), p, f"{name}.mlp.fc1", quant))
    return x + linear(y, p, f"{name}.mlp.fc2", quant)


def layout(p) -> tuple[int, int, int, int]:
    """(RSTBs, blocks an RSTB, heads, window) from the parameter shapes."""
    layers = 0
    while f"layers.{layers}.conv.weight" in p:
        layers += 1
    depth = 0
    while f"layers.0.residual_group.blocks.{depth}.norm1.weight" in p:
        depth += 1
    rows, heads = p["layers.0.residual_group.blocks.0.attn.relative_position_bias_table"].shape
    ws = (round(rows ** 0.5) + 1) // 2
    return layers, depth, heads, ws


def generator(p, lr, quant=None):
    """(B, h, w, 3) LR in [0, 1] -> (B, 4h, 4w, 3) SR in [0, 1]."""
    layers, depth, heads, ws = layout(p)
    x = lr.permute(0, 3, 1, 2)
    h, w = x.shape[2:]
    # check_image_size: reflect padding to a multiple of the window
    x = F.pad(x, (0, (ws - w % ws) % ws, 0, (ws - h % ws) % ws), "reflect")
    mean = torch.tensor(MEAN, device=x.device, dtype=x.dtype).view(1, 3, 1, 1)
    x = conv(x - mean, p, "conv_first", quant)
    b, c, hp, wp = x.shape
    # forward_features: tokens (B, L, C)
    t = layer_norm(x.flatten(2).transpose(1, 2), p, "patch_embed.norm")
    for i in range(layers):
        skip = t
        for j in range(depth):
            t = swin_block(t, (hp, wp), p, f"layers.{i}.residual_group.blocks.{j}", heads, ws,
                           0 if j % 2 == 0 else ws // 2, quant)
        grid = t.transpose(1, 2).view(b, c, hp, wp)
        t = conv(grid, p, f"layers.{i}.conv", quant).flatten(2).transpose(1, 2) + skip
    t = layer_norm(t, p, "norm").transpose(1, 2).view(b, c, hp, wp)
    x = conv(t, p, "conv_after_body", quant) + x
    x = F.leaky_relu(conv(x, p, "conv_before_upsample.0", quant), 0.01)
    for name in ("conv_up1", "conv_up2"):
        x = F.leaky_relu(conv(F.interpolate(x, scale_factor=2, mode="nearest"), p, name, quant),
                         0.2)
    x = conv(F.leaky_relu(conv(x, p, "conv_hr", quant), 0.2), p, "conv_last", quant) + mean
    return torch.clamp(x[:, :, :4 * h, :4 * w], 0.0, 1.0).permute(0, 2, 3, 1)


@torch.no_grad()
def upscale(sd: dict, lr: torch.Tensor, quant=None) -> torch.Tensor:
    """The reference's frame: float32 parameters and input, TF32 off."""
    p = {k: v.float() for k, v in sd.items()}
    with full_float32():
        return generator(p, lr.float(), quant)
