"""The stream cell (`srgan_x4.train_stream`) on the CPU: the pack writer
repeats itself and writes once, the driver at a toy size feeds the chunk
step from the program's `PackedPatchSource` (host path) and comes out
correct with the cell's limits (a step that leaves the state unchanged
does not), and `host_fetch_ms.train` reads a record that has the number
and no other."""

import os
import time

import numpy as np
import pytest

from benchmark import harness, tracing

CELL = "srgan_x4.train_stream"


def test_the_pack_is_written_once_and_repeats(tmp_path):
    drv = harness.driver(harness.load_ctx(CELL, 1, 0.0, False, "cpu"))
    a = drv.stream_pack(64, 24, str(tmp_path / "a"), "cpu")
    b = drv.stream_pack(64, 24, str(tmp_path / "b"), "cpu")
    pa, pb = np.load(a), np.load(b)
    assert pa.shape == (64, 24, 24, 3) and pa.dtype == np.uint8 and np.array_equal(pa, pb)
    assert len(np.unique(pa)) > 100  # patches, not a constant
    stamp = os.stat(a).st_mtime_ns
    assert drv.stream_pack(64, 24, str(tmp_path / "a"), "cpu") == a
    assert os.stat(a).st_mtime_ns == stamp
    assert [f for f in os.listdir(tmp_path / "a") if "tmp" in f] == []


def tiny(tmp_path, seed=2**31 + 12345) -> harness.Ctx:
    harness.CACHE = str(tmp_path)
    ctx = harness.load_ctx(CELL, seed, 0.2, False, "cpu", time.perf_counter())
    ctx.config = dict(ctx.config, g_num_rcb=2, batch_size=4, d_channels=8)
    ctx.traffic = dict(ctx.traffic, chunk_batches=2, pack_patches=32)
    return ctx


@pytest.fixture
def cache(monkeypatch):
    monkeypatch.setattr(harness, "CACHE", harness.CACHE)


def test_the_sound_program_fed_by_the_source_is_correct(tmp_path, cache):
    from srgan_st_tpu_torch.data.pipeline import PackedPatchSource

    made = []
    init = PackedPatchSource.__init__

    def spy(self, *a, **k):
        init(self, *a, **k)
        made.append(self)

    PackedPatchSource.__init__ = spy
    try:
        ctx = tiny(tmp_path)
        out = harness.driver(ctx).run(ctx)
    finally:
        PackedPatchSource.__init__ = init
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == set(ctx.workload["limits"])
    assert len(made) == 1 and not made[0].device_cache and made[0].seed == ctx.seed
    assert out["detail"]["host_fetch_ms"] > 0 and out["attempted"] >= 2


def test_a_step_that_returns_its_state_unchanged_is_not_correct(tmp_path, cache, monkeypatch):
    from srgan_st_tpu_torch.train import steps

    monkeypatch.setattr(steps.Adam, "step", lambda self, grads: None)
    ctx = tiny(tmp_path)
    assert not harness.driver(ctx).run(ctx)["correct"]


def test_host_fetch_reader():
    reader = harness.readers()["host_fetch_ms.train"]
    rec = tracing.reduce_events([(0.0, 1.0, "k")], [(0.0, 2.0, "bench.unit")])
    rec.update(kind="train", phase="gan", config=harness.load_json("configs", "srgan_x4.json"),
               rate=2000.0, batches=100, launches={})
    assert reader.read(rec) is None  # a pooled cell records no fetch
    rec["host_fetch_ms"] = 0.25
    assert reader.read(rec) == 0.25
    assert reader.read(dict(rec, kind="serve")) is None
    assert reader.MOVES == "train_patches_per_s" and reader.UNIT == "ms"
