"""Closed-loop GAN training fed by the program's data layer: the state,
the chunk step and the reference of `train_chunks.py`, with the batches
from the program's training source (`make_train_source` of
srgan_st_tpu_torch/data/pipeline.py: a `PackedPatchSource` over a uint8
pack, DATA.DEVICE_CACHE off, so each batch is a page-ordered gather of
the memory-mapped pack on the source's prefetch thread, copied in by the
step's `graph.copy_in`) through `iter_chunks` of train/utils.py, epoch
after epoch.

The pack (`pack_patches` GT patches of the configuration's size) is drawn
from one fixed seed (`PACK_SEED`) on the device and written once into the
checkout's cache (`harness.CACHE`); the run's seed sets DATA.SEED, the
order of every epoch, and the weights. Set-up drives the first three steps
on the first three batches of epoch 0, one a call, then one warm chunk;
the window times whole chunks, each from the wait for its batches until
its step ends synchronized. `host_fetch_ms` is the host time the loop
waits on the source, a batch.

Traffic parameters: phase, chunk_batches, pack_patches, warm_chunks,
first_steps, traced_units."""

from __future__ import annotations

import dataclasses
import math
import os
import time

import numpy as np
import torch

from benchmark import compare, harness, seeded
from benchmark.drivers import train_chunks
from benchmark.harness import sync

PACK_SEED = 0


def stream_pack(n: int, size: int, root: str, device) -> str:
    """A (n, size, size, 3) uint8 pack (`seeded.patch_pool`'s patches of
    PACK_SEED, in batches of 16) as `.npy` under `root`, written once
    (atomically) and read by the program's source."""
    path = os.path.join(root, f"stream_pack_{n}_{size}_{PACK_SEED}.npy")
    if os.path.exists(path):
        return path
    os.makedirs(root, exist_ok=True)
    gen = seeded.generator_for(PACK_SEED, device)
    pool = seeded.patch_pool(gen, n // 16, 16, size, device).reshape(n, size, size, 3)
    tmp = f"{path}.{os.getpid()}.tmp.npy"
    np.save(tmp, pool.cpu().numpy())
    os.replace(tmp, path)
    return path


class Session(train_chunks.Session):
    """`train_chunks.Session` (no pool: its batches come from the source)
    and the program's source over the pack."""

    def __init__(self, ctx: harness.Ctx):
        from srgan_st_tpu_torch.data.pipeline import make_train_source

        super().__init__(dataclasses.replace(ctx, traffic=dict(ctx.traffic, pool_chunks=0)))
        t = time.perf_counter()
        config = harness.program_config(self.cfg)
        config.DATA.TRAIN_GT_IMAGES_DIR = stream_pack(
            self.mix["pack_patches"], self.cfg["gt_image_size"], harness.CACHE, self.dev)
        config.DATA.DEVICE_CACHE = False
        config.DATA.SEED = ctx.seed
        self.source = make_train_source(config, device=self.dev)
        self.parts["pack_s"] = time.perf_counter() - t
        epoch = self.source.epoch(0)
        self.pool = [next(epoch) for _ in range(self.mix["first_steps"])]
        epoch.close()
        self.fetch_s = 0.0
        self.stream = self._chunks()

    def _chunks(self):
        from srgan_st_tpu_torch.train.utils import iter_chunks

        epoch = 0
        while True:
            yield from iter_chunks(self.source, epoch, self.mix["chunk_batches"])
            epoch += 1

    def next_chunk(self) -> list:
        """The next chunk of the source; its wait is added to `fetch_s`."""
        t = time.perf_counter()
        chunk = next(self.stream)
        self.fetch_s += time.perf_counter() - t
        return chunk

    def free(self) -> list:
        """Drop the program's state and the source; returns the first
        batches (host tensors)."""
        first = [torch.from_numpy(np.asarray(b)) for b in self.pool]
        self.stream.close()
        self.stream = self.source = None
        self.pool = first
        return super().free()


def run(ctx: harness.Ctx) -> dict:
    dev = torch.device(ctx.device)
    build_s = harness.start(dev)
    s = Session(ctx)
    s.parts["build_s"] = build_s
    prog = s.first_steps()
    t = time.perf_counter()
    for _ in range(s.mix["warm_chunks"]):
        s.step(s.next_chunk())
    sync(dev)
    s.parts["warm_s"] = time.perf_counter() - t
    if s.graphs is not None:
        s.parts["capture_s"] = sum(s.graphs.capture_seconds().values())

    k, batch = s.mix["chunk_batches"], ctx.config["batch_size"]
    n = 0
    ends = []
    s.fetch_s = 0.0
    start = time.perf_counter()
    setup_s = start - ctx.t0
    while True:
        m = s.step(s.next_chunk())
        n += 1
        sync(dev)
        ends.append(time.perf_counter() - start)
        elapsed = ends[-1]
        if elapsed >= ctx.seconds:
            break
    rate = n * k * batch / elapsed
    fetch_ms = 1e3 * s.fetch_s / (n * k)
    finite = all(math.isfinite(float(v)) for v in m.values())

    record = None
    if ctx.trace:
        from benchmark import tracing
        from srgan_st_tpu_torch import kernels

        launches = []

        def unit():
            before = kernels.launch_counts()
            s.step(s.next_chunk())
            sync(dev)
            after = kernels.launch_counts()
            launches.append({key: after[key] - before[key] for key in after})

        record = tracing.profile_units(unit, s.mix["traced_units"])
        record.update(kind="train", phase=s.phase, config=ctx.config, rate=rate,
                      batches=k * s.mix["traced_units"], launches=tracing.summed(launches[1:]),
                      host_fetch_ms=fetch_ms)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    first = s.free()
    ref = s.reference(first)
    readings, where = compare.train_readings(prog, ref, s.init)
    ok, checks = harness.judge(readings, ctx.workload["limits"])
    metrics = {"train_patches_per_s": {"value": rate, "unit": "patches/s"},
               "setup_s": {"value": setup_s, "unit": "s"}}
    return {"correct": ok and finite, "attempted": n * k, "failed": 0 if finite else n * k,
            "metrics": metrics, "peak": peak, "record": record, "checks": checks,
            "detail": {"worst_leaf": where, "setup_parts": s.parts, "readings": readings,
                       "host_fetch_ms": fetch_ms,
                       "chunk_s": [b - a for a, b in zip([0.0, *ends], ends)],
                       "first_losses": prog["loss"], "reference_losses": ref["loss"]}}
