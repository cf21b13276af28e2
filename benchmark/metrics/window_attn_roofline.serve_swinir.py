"""SwinIR's window-attention cores (q k^T, the bias and mask, the
softmax, p v: the `g.attn_core` regions, whatever implements them)
against their roofline: the larger of one core's FLOPs and bytes at the
frame's shape (benchmark/work_swinir.py `attn_core`: q, k and v read once,
the output written once, the additive tensors once a frame; 0.754 GB,
0.225 ms at 540 x 960, byte bound) times the cores the program counted
(`window_attn`) in the traced units, over the device time under
`g.attn_core`. Where the counter or the region is absent, nothing is
read."""

from benchmark import work_swinir

LAYER = "attention core (models/swinir.py window_attention, region g.attn_core)"
UNIT = "%"
MOVES = "serve_hr_mp_per_s"


def read(record):
    if record.get("kind") != "serve_swinir":
        return None
    calls = record["launches"].get("window_attn", 0)
    seconds = record.get("regions", {}).get("g.attn_core")
    if not calls or not seconds:
        return None
    h, w = record["lr_size"]
    bound = work_swinir.attn_core_bound_seconds(h, w, record["config"])
    return 100.0 * calls * bound / seconds
