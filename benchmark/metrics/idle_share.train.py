"""The device's idle share of the traced training chunks: 1 - busy / window, busy
the union of the operations' spans."""

LAYER = "device"
UNIT = "%"
MOVES = "train_patches_per_s"


def read(record):
    if record.get("kind") != "train" or not record["window_s"]:
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
