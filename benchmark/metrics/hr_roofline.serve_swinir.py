"""SwinIR's HR stage (conv_before_upsample and its LeakyReLU at 1x, then
Real-ESRGAN's: conv_up1 at 2x; conv_up2, conv_hr, conv_last at 4x; the
`g.upsample` and `g.tail` regions, kernel H where its gate holds) against
its roofline: the larger of its compute and byte bounds at the padded
frame's shape (benchmark/work_swinir.py `hr_stage`) times the traced
frames, over the device time under the two regions. Where either region
is absent, nothing is read."""

from benchmark import work, work_swinir

LAYER = "HR stage (models/rrdb.py, regions g.upsample + g.tail)"
UNIT = "%"
MOVES = "serve_hr_mp_per_s"


def read(record):
    if record.get("kind") != "serve_swinir":
        return None
    got = record.get("regions", {})
    if not got.get("g.upsample") or not got.get("g.tail"):
        return None
    h, w = record["lr_size"]
    bound = work.bound_seconds(*work_swinir.hr_stage(h, w, record["config"]))
    return 100.0 * record["frames"] * bound / (got["g.upsample"] + got["g.tail"])
