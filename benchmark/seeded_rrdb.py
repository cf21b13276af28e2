"""The RRDB generator's weights from a seed, on the device, in two draws
of one `torch.Generator` (a normal one for the dense blocks, a uniform one
for the rest), by basicsr's state-dict names, which both the program
(models/rrdb.py) and benchmark/reference/rrdb.py read. The same seed gives
the same tensors."""

from __future__ import annotations

import math

import torch

from benchmark.seeded import _Draws


def shapes(cfg: dict) -> list[tuple[str, tuple]]:
    """(name, OIHW shape) of every conv, in basicsr's order."""
    nf, gc = cfg["num_feat"], cfg["num_grow_ch"]
    out = [("conv_first", (nf, cfg["num_in_ch"], 3, 3))]
    for i in range(cfg["num_block"]):
        for j in (1, 2, 3):
            for k in range(1, 6):
                cout = gc if k < 5 else nf
                out.append((f"body.{i}.rdb{j}.conv{k}", (cout, nf + (k - 1) * gc, 3, 3)))
    out += [(name, (nf, nf, 3, 3)) for name in ("conv_body", "conv_up1", "conv_up2", "conv_hr")]
    out.append(("conv_last", (cfg["num_out_ch"], nf, 3, 3)))
    return out


def state(cfg: dict, gen: torch.Generator, device) -> dict:
    """Every conv outside the dense blocks as basicsr inits it (torch's
    default: weight and bias uniform in +-1/sqrt(fan in)); each dense
    block's conv N(0, g^2 / fan in), g = `dense_weight_gain`, with a zero
    bias (basicsr: kaiming-normal x 0.1, g = 0.14, under which one block
    moves the frame less than bf16 rounding does); then conv_last's
    weight times `conv_last_scale` and its bias 0.5, so that the clamped
    output is mostly inside (0, 1). The configuration's `assumed` says
    why."""
    convs = shapes(cfg)
    dense = [(n, s) for n, s in convs if ".rdb" in n]
    plain = [(n, s) for n, s in convs if ".rdb" not in n]
    draws = _Draws(gen, sum(math.prod(s) for _, s in dense),
                   sum(math.prod(s) + s[0] for _, s in plain), device)
    sd = {}
    for name, shape in dense:
        fan_in = math.prod(shape[1:])
        sd[f"{name}.weight"] = draws.randn(shape) * (cfg["dense_weight_gain"] / math.sqrt(fan_in))
        sd[f"{name}.bias"] = torch.zeros(shape[0], device=device)
    for name, shape in plain:
        bound = 1.0 / math.sqrt(math.prod(shape[1:]))
        sd[f"{name}.weight"] = draws.rand(shape, -bound, bound)
        sd[f"{name}.bias"] = draws.rand((shape[0],), -bound, bound)
    sd["conv_last.weight"] = sd["conv_last.weight"] * cfg["conv_last_scale"]
    sd["conv_last.bias"] = torch.full_like(sd["conv_last.bias"], 0.5)
    return {name: sd[name] for n, _ in convs for name in (f"{n}.weight", f"{n}.bias")}
