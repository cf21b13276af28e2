"""The SwinIR frame's share of the card's bf16 peak: the generator's FLOPs
a frame (benchmark/work_swinir.py, 14.27 TFLOP at 540 x 960, padded to
544) times the traced run's frames/s."""

from benchmark import work, work_swinir

LAYER = "model (models/swinir.py)"
UNIT = "%"
MOVES = "serve_hr_mp_per_s"


def read(record):
    if record.get("kind") != "serve_swinir":
        return None
    h, w = record["lr_size"]
    flops = work_swinir.frame_flops(h, w, record["config"])
    return 100.0 * flops * record["frames_per_s"] / work.PEAK_BF16_FLOPS
