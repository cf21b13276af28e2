"""The RRDB frame's share of the card's bf16 peak: the generator's FLOPs
a frame (benchmark/work_rrdb.py, 18.59 TFLOP at 540 x 960) times the
traced run's frames/s."""

from benchmark import work, work_rrdb

LAYER = "model (models/rrdb.py)"
UNIT = "%"
MOVES = "serve_hr_mp_per_s"


def read(record):
    if record.get("kind") != "serve_rrdb":
        return None
    h, w = record["lr_size"]
    flops = work_rrdb.frame_flops(h, w, record["config"])
    return 100.0 * flops * record["frames_per_s"] / work.PEAK_BF16_FLOPS
