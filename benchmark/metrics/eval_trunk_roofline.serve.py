"""Kernel E (the eval trunk: 16 residual blocks, the fusion conv and the
global skip) against its roofline in serving: the bound of one trunk at
the frame's shape (the trunk's forward and one more 3x3 conv, the same
work whatever implements it) times the calls the program counted in the
traced units, over the device time (the union of spans) of kernel E's
kernels. Kernels are matched by name; where the counter or the kernels
are absent (a program without kernel E), nothing is read."""

import re

from benchmark import tracing, work

LAYER = "kernels (csrc/eval_trunk.cu: kernel E)"
UNIT = "%"
MOVES = "serve_hr_mp_per_s"

NAMES = re.compile(r"^(void )?\(anonymous namespace\)::eval_trunk_conv\b")


def call_bound_seconds(h: int, w: int, cfg: dict) -> float:
    """The least time of one eval trunk on a (1, h, w, C) frame."""
    c = cfg["g_channels"]
    flops, nbytes = work.trunk(1, h, w, c, cfg["g_num_rcb"])["fwd"]
    flops += 2.0 * work.conv_macs(h, w, c, c, 3)
    nbytes += work.BF16 * 9 * c * c
    return work.bound_seconds(flops, nbytes)


def read(record):
    if record.get("kind") != "serve":
        return None
    spans = [(s, e) for s, e, name in record["ops"] if NAMES.match(name)]
    calls = record["launches"].get("eval_trunk", 0)
    if not spans or not calls:
        return None
    h, w = record["lr_size"]
    return 100.0 * calls * call_bound_seconds(h, w, record["config"]) / tracing.covered(spans)
