"""The served frame's share of the card's bf16 peak: the eval generator's
FLOPs a frame (benchmark/work.py) times the traced run's frames/s."""

from benchmark import work

LAYER = "model (models/generator.py, models/discriminator.py)"
UNIT = "%"
MOVES = "serve_hr_mp_per_s"


def read(record):
    if record.get("kind") != "serve":
        return None
    h, w = record["lr_size"]
    flops = work.generator_fwd_flops(h, w, record["config"])
    return 100.0 * flops * record["frames_per_s"] / work.PEAK_BF16_FLOPS
