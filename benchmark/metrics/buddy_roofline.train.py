"""The buddy selection (K7) of PatchwiseST against its roofline: the
bound of the selection at its bank shapes times the calls the program
counted in the traced units, over the device time (the union of spans)
of K7's kernels. Kernels are matched by name; where none match, nothing
is read."""

import re

from benchmark import tracing, work

LAYER = "losses (losses/functions.py PatchwiseST, csrc/buddy_select.cu: K7)"
UNIT = "%"
MOVES = "train_patches_per_s"

NAMES = re.compile(r"^(void )?\(anonymous namespace\)::(buddy_kernel|buddy_mma_kernel)\b")


def read(record):
    if record.get("kind") != "train":
        return None
    spans = [(s, e) for s, e, name in record["ops"] if NAMES.match(name)]
    calls = record["launches"].get("buddy_select", 0)
    if not spans or not calls:
        return None
    cfg = record["config"]
    n, m, d = work.st_bank_rows(cfg)
    bound = work.bound_seconds(*work.buddy_selection(cfg["batch_size"], n, m, d))
    return 100.0 * calls * bound / tracing.covered(spans)
