"""SwinIR's trunk (patch_embed.norm, the 6 RSTBs of Swin blocks and their
convs, norm, conv_after_body and the skip: the `g.trunk` region) against
its roofline: the trunk's bound at the frame's shape
(benchmark/work_swinir.py: 12.74 TFLOP at 540 x 960, compute bound, 12.89
ms) times the trunk calls the program counted (`swin_trunk`) in the
traced units, over the device time under `g.trunk`. Where the counter or
the region is absent, nothing is read."""

from benchmark import work_swinir

LAYER = "model trunk (models/swinir.py, region g.trunk)"
UNIT = "%"
MOVES = "serve_hr_mp_per_s"


def read(record):
    if record.get("kind") != "serve_swinir":
        return None
    calls = record["launches"].get("swin_trunk", 0)
    seconds = record.get("regions", {}).get("g.trunk")
    if not calls or not seconds:
        return None
    h, w = record["lr_size"]
    return 100.0 * calls * work_swinir.trunk_bound_seconds(h, w, record["config"]) / seconds
