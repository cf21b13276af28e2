"""Host milliseconds a batch that the training loop waits on its data
source (`next` of `iter_chunks` over the program's `PackedPatchSource`),
over the window's chunks. Only a cell fed by the source records it."""

LAYER = "data (data/pipeline.py PackedPatchSource, train/utils.py iter_chunks)"
UNIT = "ms"
MOVES = "train_patches_per_s"


def read(record):
    if record.get("kind") != "train" or record.get("host_fetch_ms") is None:
        return None
    return record["host_fetch_ms"]
