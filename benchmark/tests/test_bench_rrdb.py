"""The RRDB cell's pieces on the CPU: the work counts of
benchmark/work_rrdb.py, the seeded weights, the labelling of
benchmark/regions.py and the four readers on canned records, and the
driver at a toy size with the cell's own limits (the sound program
correct; the float8 control and an answer altered where it is produced
not correct)."""

import time

import pytest
import torch

from benchmark import harness, regions, seeded, seeded_rrdb, tracing, work, work_rrdb
from benchmark.reference import rrdb as ref
from benchmark.reference.precision import fp8

CELL = "realesrgan_x4plus.video_4k"
CFG = harness.load_json("configs", "realesrgan_x4plus.json")
SRGAN = harness.load_json("configs", "srgan_x4.json")
RRDB_READERS = ("frame_mfu.serve_rrdb", "rrdb_trunk_roofline.serve", "hr_roofline.serve_rrdb",
                "idle_share.serve_rrdb")


def test_work_counts_at_540p():
    assert work_rrdb.rdb_macs_per_px(CFG) == 239_616
    assert work_rrdb.trunk_flops(540, 960, CFG) == pytest.approx(17.18e12, rel=1e-3)
    assert work_rrdb.frame_flops(540, 960, CFG) == pytest.approx(18.59e12, rel=1e-3)
    flops, nbytes = work_rrdb.hr_stage(540, 960, CFG)
    assert flops == pytest.approx(1.404e12, rel=1e-3)
    # 73 64-channel LR-sized planes in bf16 (up1 1 + 4, up2 4 + 16, hr 16 + 16,
    # last 16), the weights, the f32 output: 4.94 GB, the larger bound (1.48 ms)
    assert nbytes == pytest.approx(2 * 64 * 518_400 * 73 + 2 * 9 * 64 * 195
                                   + 4 * 16 * 518_400 * 3)
    assert work.bound_seconds(flops, nbytes) == pytest.approx(
        nbytes / work.PEAK_HBM_BYTES_PER_S) == pytest.approx(1.476e-3, rel=1e-3)
    assert work_rrdb.trunk_bound_seconds(540, 960, CFG) == pytest.approx(17.37e-3, rel=1e-3)
    # the trunk is 92.4% of the frame
    assert work_rrdb.trunk_flops(540, 960, CFG) / work_rrdb.frame_flops(540, 960, CFG) == \
        pytest.approx(0.924, abs=1e-3)


def test_seeded_weights_repeat_and_follow_the_configuration():
    a = seeded_rrdb.state(CFG, seeded.generator_for(2**31 + 3, "cpu"), "cpu")
    b = seeded_rrdb.state(CFG, seeded.generator_for(2**31 + 3, "cpu"), "cpu")
    c = seeded_rrdb.state(CFG, seeded.generator_for(2**31 + 4, "cpu"), "cpu")
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv_first.weight"], c["conv_first.weight"])
    assert sum(v.numel() for v in a.values()) == 16_697_987
    w = a["body.5.rdb2.conv5.weight"]
    assert float(w.std()) == pytest.approx(CFG["dense_weight_gain"] / (192 * 9) ** 0.5, rel=0.02)
    assert float(a["body.5.rdb2.conv5.bias"].abs().max()) == 0.0
    assert float(a["conv_hr.weight"].abs().max()) <= 1 / (64 * 9) ** 0.5
    assert torch.equal(a["conv_last.bias"], torch.full((3,), 0.5))


OPS = [(0.0, 1.0, "conv_first", 1), (1.0, 9.0, "cudnn conv", 2), (2.0, 3.0, "Cat", 3),
       (9.0, 9.5, "upsample", 4), (9.5, 10.0, "conv_hr", 5), (10.0, 10.2, "next_lr", 6)]
CALLS = [(0.1, 0.2, "cudaLaunchKernel", 1), (1.1, 1.2, "cudaLaunchKernel", 2),
         (1.3, 1.4, "cudaLaunchKernel", 3), (1.5, 1.6, "cudaLaunchKernel", 4),
         (1.7, 1.8, "cudaLaunchKernel", 5), (9.9, 9.95, "cudaLaunchKernel", 6)]
SPANS = [(0.0, 2.0, "serve.frame"), (0.05, 2.0, "g.forward"), (0.05, 1.0, "g.stem"),
         (1.0, 1.45, "g.trunk"), (1.45, 1.65, "g.upsample"), (1.65, 2.0, "g.tail")]


def test_regions_put_each_op_down_to_the_span_of_its_launch():
    got = regions.label(OPS, CALLS, SPANS)
    assert got["regions"] == pytest.approx({"serve.frame": 10.0, "g.forward": 10.0,
                                            "g.stem": 1.0, "g.trunk": 8.0, "g.upsample": 0.5,
                                            "g.tail": 0.5})
    assert got["labelled_share"] == pytest.approx(10.0 / 10.2)
    assert regions.label(OPS, CALLS, [])["regions"] == {}


def serve_rrdb_record(region_s=None, launches=None, kind="serve_rrdb"):
    ops = [(0.0, 0.150, "conv"), (0.151, 0.160, "upsample")]
    rec = tracing.reduce_events(ops, [(0.0, 1.0, "bench.unit")])
    rec.update(kind=kind, config=CFG, frames_per_s=6.0, lr_size=(540, 960), frames=1,
               launches={"rrdb_trunk": 1} if launches is None else launches,
               regions={"g.trunk": 0.150, "g.upsample": 0.006, "g.tail": 0.003}
               if region_s is None else region_s)
    return rec


def test_rrdb_readers_on_a_canned_record():
    readers = harness.readers()
    rec = serve_rrdb_record()
    values = {name: readers[name].read(rec) for name in RRDB_READERS}
    assert values["frame_mfu.serve_rrdb"] == pytest.approx(100 * 18.59e12 * 6 / 989e12,
                                                           rel=1e-3)
    assert values["rrdb_trunk_roofline.serve"] == pytest.approx(100 * 17.37e-3 / 0.150,
                                                                rel=1e-3)
    hr = work.bound_seconds(*work_rrdb.hr_stage(540, 960, CFG))
    assert values["hr_roofline.serve_rrdb"] == pytest.approx(100 * hr / 0.009)
    assert values["idle_share.serve_rrdb"] == pytest.approx(100 * 0.001 / 0.160)
    for name in RRDB_READERS:
        mod = readers[name]
        assert mod.MOVES == "serve_hr_mp_per_s" and mod.UNIT == "%" and "\n" not in mod.LAYER


def test_rrdb_readers_read_nothing_elsewhere():
    readers = harness.readers()
    srresnet = serve_rrdb_record(kind="serve")
    srresnet["config"] = SRGAN
    for name in RRDB_READERS:
        assert readers[name].read(srresnet) is None, name
    # a program without the counter or the regions (the parent)
    bare = serve_rrdb_record(region_s={}, launches={})
    assert readers["rrdb_trunk_roofline.serve"].read(bare) is None
    assert readers["hr_roofline.serve_rrdb"].read(bare) is None
    # and the SRResNet serving readers read nothing of an RRDB record
    per_layer = harness.per_layer(serve_rrdb_record())
    assert set(per_layer) == set(RRDB_READERS)


def tiny(seed=2**31 + 12345) -> harness.Ctx:
    ctx = harness.load_ctx(CELL, seed, 0.2, False, "cpu", time.perf_counter())
    ctx.config = dict(ctx.config, num_feat=16, num_block=2, num_grow_ch=8, conv_last_scale=8.0)
    ctx.traffic = dict(ctx.traffic, lr_height=12, lr_width=16, warm_frames=1,
                       sample_frames=3, sample_below=4)
    return ctx


def test_the_sound_program_is_correct():
    out = harness.driver(tiny()).run(tiny())
    assert set(out["checks"]) == {"frame_rms_gap", "frame_max_gap"}
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["detail"]["clamped_share"] < 0.05
    assert set(out["metrics"]) == {"serve_hr_mp_per_s", "serve_frame_ms_p95", "setup_s"}


def test_an_answer_altered_where_it_is_produced_is_not_correct(monkeypatch):
    from srgan_st_tpu_torch.models.rrdb import RRDBNet

    forward = RRDBNet.forward

    def altered(self, x):
        out = forward(self, x).clone()
        out[:, :16, :16] = 0.0
        return out

    monkeypatch.setattr(RRDBNet, "forward", altered)
    ctx = tiny()
    assert not harness.driver(ctx).run(ctx)["correct"]


def test_the_float8_control_in_the_programs_place_is_not_correct(monkeypatch):
    ctx = tiny()
    drv = harness.driver(ctx)
    init = drv.Session.__init__

    def control(self, ctx):
        init(self, ctx)
        weights = {k: v.to(self.dev) for k, v in self.g_sd.items()}
        self.apply = lambda x: ref.upscale(weights, torch.as_tensor(x), fp8)

    monkeypatch.setattr(drv.Session, "__init__", control)
    assert not drv.run(ctx)["correct"]
