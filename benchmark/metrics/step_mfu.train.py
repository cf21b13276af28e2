"""The training step's share of the card's bf16 peak: the recipe's model
FLOPs a GT patch (benchmark/work.py) times the traced run's patches/s."""

from benchmark import work

LAYER = "model (models/generator.py, models/discriminator.py)"
UNIT = "%"
MOVES = "train_patches_per_s"


def read(record):
    if record.get("kind") != "train":
        return None
    flops = work.train_flops_per_patch(record["config"], record["phase"])
    if flops is None:
        return None
    return 100.0 * flops * record["rate"] / work.PEAK_BF16_FLOPS
