"""The device's idle share of the traced SwinIR frames: 1 - busy / window,
busy the union of the operations' spans."""

LAYER = "device"
UNIT = "%"
MOVES = "serve_hr_mp_per_s"


def read(record):
    if record.get("kind") != "serve_swinir" or not record["window_s"]:
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
