"""The residual trunk's kernels (K4 forward, K5 backward) against their
roofline: the bound time of the trunk's forward and backward at the
cell's shapes, times the calls the program counted in the traced units,
over the device time (the union of spans) of every kernel of
csrc/packed_trunk.cu in them. Kernels are matched by name; where none
match, nothing is read."""

import re

from benchmark import tracing, work

LAYER = "kernels (csrc/packed_trunk.cu: K4/K5)"
UNIT = "%"
MOVES = "train_patches_per_s"

NAMES = re.compile(r"^(void )?\(anonymous namespace\)::(conv3x3_kernel|fwd_partials_kernel|"
                   r"bwd_partials_kernel|reduce_kernel|bn_apply_kernel|bn_bwd_apply_kernel|"
                   r"wgrad_kernel|wgrad_reduce_kernel|trunk_conv_wgmma|trunk_wgrad_wgmma|"
                   r"wgrad_reduce2_kernel|bn2_sums_kernel)\b")


def read(record):
    if record.get("kind") != "train":
        return None
    spans = [(s, e) for s, e, name in record["ops"] if NAMES.match(name)]
    n_fwd = record["launches"].get("packed_trunk_fwd", 0)
    n_bwd = record["launches"].get("packed_trunk_bwd", 0)
    if not spans or not (n_fwd or n_bwd):
        return None
    cfg = record["config"]
    s = cfg["gt_image_size"] // cfg["upscale_factor"]
    t = work.trunk(cfg["batch_size"], s, s, cfg["g_channels"], cfg["g_num_rcb"])
    bound = n_fwd * work.bound_seconds(*t["fwd"]) + n_bwd * work.bound_seconds(*t["bwd"])
    return 100.0 * bound / tracing.covered(spans)
