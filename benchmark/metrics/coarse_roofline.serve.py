"""Kernel A (the reconstruction conv on the last sub-pixel stage's
pre-shuffle activation) against its roofline in serving: its bound at
the frame's shape times the calls the program counted in the traced
units, over the device time (the union of spans) of kernel A's kernels.
Kernels are matched by name; where none match, nothing is read."""

import re

from benchmark import tracing, work

LAYER = "kernels (csrc/coarse_conv.cu: kernel A)"
UNIT = "%"
MOVES = "serve_hr_mp_per_s"

NAMES = re.compile(r"^(void )?\(anonymous namespace\)::(coarse_conv_wgmma|coarse_conv_kernel)\b")


def read(record):
    if record.get("kind") != "serve":
        return None
    spans = [(s, e) for s, e, name in record["ops"] if NAMES.match(name)]
    calls = record["launches"].get("coarse_conv_s2d", 0)
    if not spans or not calls:
        return None
    cfg = record["config"]
    h, w = record["lr_size"]
    r = cfg["upscale_factor"] // 2  # the pre-shuffle activation is at half the HR size
    bound = work.bound_seconds(*work.coarse_tail(1, h * r, w * r, 4 * cfg["g_channels"],
                                                 cfg["g_out_channels"]))
    return 100.0 * calls * bound / tracing.covered(spans)
