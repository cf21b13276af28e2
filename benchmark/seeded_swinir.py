"""SwinIR's weights from a seed, on the device, in two draws of one
`torch.Generator` (a normal one for the linears and the bias tables, a
uniform one for the convs), by SwinIR's state-dict names, which both the
program (models/swinir.py) and benchmark/reference/swinir.py read. The
same seed gives the same tensors."""

from __future__ import annotations

import math

import torch

from benchmark.reference.swinir import MEAN
from benchmark.seeded import _Draws


def block_shapes(cfg: dict) -> list[tuple[str, tuple]]:
    """(name, shape) of one Swin block's parameters, in SwinIR's order."""
    c, heads, ws = cfg["embed_dim"], cfg["num_heads"][0], cfg["window_size"]
    hidden = int(c * cfg["mlp_ratio"])
    return [("norm1.weight", (c,)), ("norm1.bias", (c,)),
            ("attn.relative_position_bias_table", ((2 * ws - 1) ** 2, heads)),
            ("attn.qkv.weight", (3 * c, c)), ("attn.qkv.bias", (3 * c,)),
            ("attn.proj.weight", (c, c)), ("attn.proj.bias", (c,)),
            ("norm2.weight", (c,)), ("norm2.bias", (c,)),
            ("mlp.fc1.weight", (hidden, c)), ("mlp.fc1.bias", (hidden,)),
            ("mlp.fc2.weight", (c, hidden)), ("mlp.fc2.bias", (c,))]


def shapes(cfg: dict) -> list[tuple[str, tuple]]:
    """(name, shape) of every parameter, in SwinIR's order (its derived
    buffers, `relative_position_index` and `attn_mask`, left out)."""
    c, nf, cin = cfg["embed_dim"], cfg["num_feat"], cfg["in_chans"]
    out = [("conv_first.weight", (c, cin, 3, 3)), ("conv_first.bias", (c,)),
           ("patch_embed.norm.weight", (c,)), ("patch_embed.norm.bias", (c,))]
    for i, depth in enumerate(cfg["depths"]):
        for j in range(depth):
            out += [(f"layers.{i}.residual_group.blocks.{j}.{n}", s) for n, s in block_shapes(cfg)]
        out += [(f"layers.{i}.conv.weight", (c, c, 3, 3)), (f"layers.{i}.conv.bias", (c,))]
    out += [("norm.weight", (c,)), ("norm.bias", (c,)),
            ("conv_after_body.weight", (c, c, 3, 3)), ("conv_after_body.bias", (c,)),
            ("conv_before_upsample.0.weight", (nf, c, 3, 3)),
            ("conv_before_upsample.0.bias", (nf,))]
    for name in ("conv_up1", "conv_up2", "conv_hr"):
        out += [(f"{name}.weight", (nf, nf, 3, 3)), (f"{name}.bias", (nf,))]
    return out + [("conv_last.weight", (cin, nf, 3, 3)), ("conv_last.bias", (cin,))]


def _std(name: str, shape: tuple, cfg: dict) -> float | None:
    """The std of a normal-drawn parameter: qkv, proj and fc2 g / sqrt(fan
    in) with the configuration's gains, fc1 SwinIR's 0.02, the bias tables
    `bias_table_std`; None for the rest."""
    if name.endswith("relative_position_bias_table"):
        return cfg["bias_table_std"]
    for part, key in (("attn.qkv.weight", "qkv_gain"), ("attn.proj.weight", "proj_gain"),
                      ("mlp.fc2.weight", "fc2_gain")):
        if name.endswith(part):
            return cfg[key] / math.sqrt(shape[1])
    return 0.02 if name.endswith("mlp.fc1.weight") else None


def state(cfg: dict, gen: torch.Generator, device) -> dict:
    """SwinIR's init where it does not hide a fault (LayerNorms weight 1
    and bias 0, linear biases 0, convs torch's default: weight and bias
    uniform in +-1/sqrt(fan in)), and where it would, the configuration's
    gains: qkv, proj and fc2 drawn N(0, g^2 / fan in) and the bias tables
    N(0, bias_table_std^2) in place of trunc-normal(0.02), under which
    the attention is near uniform; fc1 keeps N(0, 0.02^2). conv_last's
    weight is scaled by `conv_last_scale` and its bias set to 0.5 - the
    mean, so that the output is mostly inside (0, 1). The configuration's
    `assumed` says why."""
    named = shapes(cfg)
    conv = {n.rsplit(".", 1)[0]: s for n, s in named if len(s) == 4}  # conv name: its OIHW shape
    normal = [(n, s) for n, s in named if _std(n, s, cfg) is not None]
    uniform = [(n, s) for n, s in named if n.rsplit(".", 1)[0] in conv]
    draws = _Draws(gen, sum(math.prod(s) for _, s in normal),
                   sum(math.prod(s) for _, s in uniform), device)
    sd = {}
    for name, shape in named:
        std, owner = _std(name, shape, cfg), name.rsplit(".", 1)[0]
        if std is not None:
            sd[name] = draws.randn(shape) * std
        elif owner in conv:
            bound = 1.0 / math.sqrt(math.prod(conv[owner][1:]))
            sd[name] = draws.rand(shape, -bound, bound)
        elif name.endswith(".weight"):
            sd[name] = torch.ones(shape, device=device)
        else:
            sd[name] = torch.zeros(shape, device=device)
    sd["conv_last.weight"] = sd["conv_last.weight"] * cfg["conv_last_scale"]
    sd["conv_last.bias"] = 0.5 - torch.tensor(MEAN, device=device)
    return sd
