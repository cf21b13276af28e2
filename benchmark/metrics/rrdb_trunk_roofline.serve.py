"""The RRDB generator's dense trunk (the 23 RRDBs, conv_body and the
skip: the `g.trunk` region) against its roofline: the trunk's bound at the
frame's shape (benchmark/work_rrdb.py: 17.18 TFLOP at 540 x 960, compute
bound) times the trunk calls the program counted (`rrdb_trunk`) in the
traced units, over the device time under `g.trunk`. Where the counter or
the region is absent, nothing is read."""

from benchmark import work_rrdb

LAYER = "model trunk (models/rrdb.py, region g.trunk)"
UNIT = "%"
MOVES = "serve_hr_mp_per_s"


def read(record):
    if record.get("kind") != "serve_rrdb":
        return None
    calls = record["launches"].get("rrdb_trunk", 0)
    seconds = record.get("regions", {}).get("g.trunk")
    if not calls or not seconds:
        return None
    h, w = record["lr_size"]
    return 100.0 * calls * work_rrdb.trunk_bound_seconds(h, w, record["config"]) / seconds
