"""Architecture derivation from weights (port of srgan_st_tpu/eval/export.py,
`derive_arch` only; serving artifacts wait for ROADMAP.md Queue A, item 3)."""

from __future__ import annotations

import math
import re

import numpy as np


def derive_arch(variables) -> dict:
    """Recover (channels, num_rcb, upscale) from a generator variable tree:
    conv1's kernel carries the width, the ``rcb{i}`` subtrees the depth,
    and each ``up{i}`` block's conv expands channels by r^2."""
    params = variables.get("params", variables)
    channels = int(np.asarray(params["conv1"]["kernel"]).shape[-1])
    num_rcb = sum(1 for k in params if re.fullmatch(r"rcb\d+", k))
    upscale = 1
    for k in params:
        if re.fullmatch(r"up\d+", k):
            out = int(np.asarray(params[k]["conv"]["kernel"]).shape[-1])
            upscale *= math.isqrt(out // channels)
    return {"channels": channels, "num_rcb": num_rcb, "upscale": upscale}
