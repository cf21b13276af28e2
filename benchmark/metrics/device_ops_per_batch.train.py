"""Device operations (kernels, copies, memsets) a batch in the traced
chunks, as the profiler counts them."""

LAYER = "chunks and graphs (train/steps.py chunk steps, train/graphs.py)"
UNIT = "ops/batch"
MOVES = "train_patches_per_s"


def read(record):
    if record.get("kind") != "train" or not record["ops"]:
        return None
    return len(record["ops"]) / record["batches"]
