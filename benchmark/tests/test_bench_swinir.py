"""The SwinIR cell's pieces on the CPU: the work counts of
benchmark/work_swinir.py, the seeded weights, the five readers on canned
records (and nothing read of any other record), and the driver at a toy
size with the cell's own limits (the sound program correct; the float8
control and an answer altered where it is produced not correct)."""

import time

import pytest
import torch

from benchmark import harness, seeded, seeded_swinir, tracing, work, work_swinir
from benchmark.reference import swinir as ref
from benchmark.reference.precision import fp8

CELL = "swinir_m_realsr_x4.video_4k_swinir"
CFG = harness.load_json("configs", "swinir_m_realsr_x4.json")
RRDB = harness.load_json("configs", "realesrgan_x4plus.json")
SWINIR_READERS = ("frame_mfu.serve_swinir", "swin_trunk_roofline.serve",
                  "window_attn_roofline.serve_swinir", "idle_share.serve_swinir",
                  "hr_roofline.serve_swinir")


def test_work_counts_at_540p():
    """At 540 x 960, padded to 544 rows: 14.27 TFLOP a frame, the trunk
    12.74 (its blocks' linears 9.75, its attention cores 0.87), the HR
    stage 1.52 (kernel H's 1.414 and conv_before_upsample's 0.108)."""
    assert work_swinir.padded(540, 960, CFG) == (544, 960)
    tokens = 544 * 960
    assert work_swinir.block_linear_macs_per_token(CFG) == 259_200
    assert 2.0 * 36 * tokens * 259_200 == pytest.approx(9.75e12, rel=1e-3)
    flops, nbytes = work_swinir.attn_core(540, 960, CFG)
    assert 36 * flops == pytest.approx(0.866e12, rel=1e-3)
    # q, k, v read and the output written once in bf16 (27.1 GB a frame),
    # the 36 bias tables and one mask of the 8,160 windows once a frame
    assert 36 * nbytes == pytest.approx(2 * (36 * 4 * tokens * 180 + 36 * 6 * 64 * 64
                                             + 8160 * 64 * 64))
    assert 36 * work_swinir.attn_core_bound_seconds(540, 960, CFG) == pytest.approx(
        36 * nbytes / work.PEAK_HBM_BYTES_PER_S) == pytest.approx(8.10e-3, rel=1e-3)
    assert work_swinir.trunk_flops(540, 960, CFG) == pytest.approx(12.745e12, rel=1e-3)
    assert work_swinir.trunk_bound_seconds(540, 960, CFG) == pytest.approx(12.886e-3, rel=1e-3)
    hr, hr_bytes = work_swinir.hr_stage(540, 960, CFG)
    assert hr == pytest.approx(1.523e12, rel=1e-3)
    # kernel H's 73 LR-sized 64-channel planes at 544 rows, conv_before_upsample's
    # 180-channel input and weights, bf16: byte bound, 1.543 ms
    assert work.bound_seconds(hr, hr_bytes) == pytest.approx(1.5428e-3, rel=1e-3)
    assert work_swinir.frame_flops(540, 960, CFG) == pytest.approx(14.273e12, rel=1e-3)
    # the trunk is 89.3% of the frame
    assert work_swinir.trunk_flops(540, 960, CFG) / work_swinir.frame_flops(540, 960, CFG) == \
        pytest.approx(0.893, abs=1e-3)


def test_seeded_weights_repeat_and_follow_the_configuration():
    a = seeded_swinir.state(CFG, seeded.generator_for(2**31 + 3, "cpu"), "cpu")
    b = seeded_swinir.state(CFG, seeded.generator_for(2**31 + 3, "cpu"), "cpu")
    c = seeded_swinir.state(CFG, seeded.generator_for(2**31 + 4, "cpu"), "cpu")
    assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv_first.weight"], c["conv_first.weight"])
    assert sum(v.numel() for v in a.values()) == 11_715_559
    blk = "layers.3.residual_group.blocks.1"
    for name, std in (("attn.qkv.weight", CFG["qkv_gain"] / 180 ** 0.5),
                      ("attn.proj.weight", CFG["proj_gain"] / 180 ** 0.5),
                      ("mlp.fc1.weight", 0.02), ("mlp.fc2.weight", CFG["fc2_gain"] / 360 ** 0.5),
                      ("attn.relative_position_bias_table", CFG["bias_table_std"])):
        assert float(a[f"{blk}.{name}"].std()) == pytest.approx(std, rel=0.05), name
    assert float(a[f"{blk}.attn.qkv.bias"].abs().max()) == 0.0
    assert torch.equal(a[f"{blk}.norm1.weight"], torch.ones(180))
    assert float(a["conv_hr.weight"].abs().max()) <= 1 / (64 * 9) ** 0.5
    assert torch.allclose(a["conv_last.bias"], 0.5 - torch.tensor(ref.MEAN))


def serve_swinir_record(region_s=None, launches=None, kind="serve_swinir"):
    ops = [(0.0, 0.300, "gemm"), (0.301, 0.310, "rrdb_hr_conv")]
    rec = tracing.reduce_events(ops, [(0.0, 1.0, "bench.unit")])
    rec.update(kind=kind, config=CFG, frames_per_s=3.0, lr_size=(540, 960), frames=1,
               launches={"swin_trunk": 1, "window_attn": 36} if launches is None else launches,
               regions={"g.trunk": 0.300, "g.attn_core": 0.081, "g.upsample": 0.004,
                        "g.tail": 0.004} if region_s is None else region_s)
    return rec


def test_swinir_readers_on_a_canned_record():
    readers = harness.readers()
    rec = serve_swinir_record()
    values = {name: readers[name].read(rec) for name in SWINIR_READERS}
    assert values["frame_mfu.serve_swinir"] == pytest.approx(100 * 14.273e12 * 3 / 989e12,
                                                             rel=1e-3)
    assert values["swin_trunk_roofline.serve"] == pytest.approx(100 * 12.886e-3 / 0.300,
                                                                rel=1e-3)
    assert values["window_attn_roofline.serve_swinir"] == pytest.approx(
        100 * 8.10e-3 / 0.081, rel=1e-3)
    assert values["idle_share.serve_swinir"] == pytest.approx(100 * 0.001 / 0.310)
    assert values["hr_roofline.serve_swinir"] == pytest.approx(100 * 1.5428e-3 / 0.008,
                                                               rel=1e-3)
    for name in SWINIR_READERS:
        mod = readers[name]
        assert mod.MOVES == "serve_hr_mp_per_s" and mod.UNIT == "%" and "\n" not in mod.LAYER


def test_swinir_readers_read_nothing_elsewhere():
    readers = harness.readers()
    for kind, cfg in (("serve", harness.load_json("configs", "srgan_x4.json")),
                      ("serve_rrdb", RRDB)):
        other = serve_swinir_record(kind=kind)
        other["config"] = cfg
        for name in SWINIR_READERS:
            assert readers[name].read(other) is None, (kind, name)
    # a program without the counters or the regions (the parent)
    bare = serve_swinir_record(region_s={}, launches={})
    assert readers["swin_trunk_roofline.serve"].read(bare) is None
    assert readers["window_attn_roofline.serve_swinir"].read(bare) is None
    # and no other reader reads a SwinIR record
    assert set(harness.per_layer(serve_swinir_record())) == set(SWINIR_READERS)


def tiny(seed=2**31 + 12345) -> harness.Ctx:
    ctx = harness.load_ctx(CELL, seed, 0.2, False, "cpu", time.perf_counter())
    ctx.config = dict(ctx.config, embed_dim=20, depths=[2, 2], num_heads=[2, 2], window_size=4,
                      num_feat=16)
    ctx.traffic = dict(ctx.traffic, lr_height=10, lr_width=14, warm_frames=1,
                       sample_frames=3, sample_below=4)
    return ctx


def test_the_sound_program_is_correct():
    out = harness.driver(tiny()).run(tiny())
    assert set(out["checks"]) == {"frame_rms_gap", "frame_max_gap"}
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["detail"]["clamped_share"] < 0.05
    assert set(out["metrics"]) == {"serve_hr_mp_per_s", "serve_frame_ms_p95", "setup_s"}


def test_an_answer_altered_where_it_is_produced_is_not_correct(monkeypatch):
    from srgan_st_tpu_torch.models.swinir import SwinIR

    forward = SwinIR.forward

    def altered(self, x):
        out = forward(self, x).clone()
        out[:, :16, :16] = 0.0
        return out

    monkeypatch.setattr(SwinIR, "forward", altered)
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
