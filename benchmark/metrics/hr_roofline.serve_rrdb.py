"""The RRDB generator's HR stage (conv_up1 at 2x; conv_up2, conv_hr,
conv_last at 4x: the `g.upsample` and `g.tail` regions) against its
roofline: the larger of its compute and byte bounds at the frame's shape
(benchmark/work_rrdb.py `hr_stage`) times the traced frames, over the
device time under the two regions. Where either region is absent, nothing
is read."""

from benchmark import work, work_rrdb

LAYER = "HR stage (models/rrdb.py, regions g.upsample + g.tail)"
UNIT = "%"
MOVES = "serve_hr_mp_per_s"


def read(record):
    if record.get("kind") != "serve_rrdb":
        return None
    got = record.get("regions", {})
    if not got.get("g.upsample") or not got.get("g.tail"):
        return None
    h, w = record["lr_size"]
    bound = work.bound_seconds(*work_rrdb.hr_stage(h, w, record["config"]))
    return 100.0 * record["frames"] * bound / (got["g.upsample"] + got["g.tail"])
