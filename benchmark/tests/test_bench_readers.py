"""Each per-layer reader on a canned traced record, and the trace
reduction's busy, idle and breakdown arithmetic."""

import pytest

from benchmark import harness, tracing, work

CFG = harness.load_json("configs", "srgan_x4.json")
ST = harness.load_json("configs", "srgan_st_x4.json")
READERS = harness.readers()
TRUNK = "void (anonymous namespace)::trunk_conv_wgmma(ConvParams)"
WGRAD = "void (anonymous namespace)::trunk_wgrad_wgmma(WgradParams)"
K7 = "void (anonymous namespace)::buddy_mma_kernel(__nv_bfloat16 const*)"
A = "void (anonymous namespace)::coarse_conv_wgmma(__nv_bfloat16 const*, float*)"
TORCH_REDUCE = "void at::native::reduce_kernel<512, 1>(at::native::ReduceOp<float>)"


def train_record(cfg=CFG, ops=None, launches=None):
    ops = ops if ops is not None else [
        (0.0, 1.0e-3, TRUNK), (0.5e-3, 2.0e-3, WGRAD),   # overlapping: union 2 ms
        (2.0e-3, 2.5e-3, K7), (3.0e-3, 3.5e-3, TORCH_REDUCE), (4.0e-3, 5.0e-3, "Memcpy DtoD")]
    rec = tracing.reduce_events(ops, [(0.0, 10.0, "bench.unit"), (3.4e-3, 4.2e-3, "cudaGraphLaunch")])
    rec.update(kind="train", phase="gan", config=cfg, rate=2000.0, batches=4,
               launches=launches or {"packed_trunk_fwd": 2, "packed_trunk_bwd": 2,
                                     "buddy_select": 2, "coarse_conv_s2d": 2})
    return rec


def serve_record(ops=None):
    ops = ops if ops is not None else [(0.0, 1.2e-3, A), (1.5e-3, 30e-3, "cudnn conv")]
    rec = tracing.reduce_events(ops, [(0.0, 1.0, "bench.unit")])
    rec.update(kind="serve", config=CFG, frames_per_s=30.0, lr_size=(540, 960), frames=1,
               launches={"coarse_conv_s2d": 1})
    return rec


def test_every_reader_names_its_layer_unit_and_end_to_end_metric():
    assert set(READERS) == {"step_mfu.train", "frame_mfu.serve", "trunk_roofline.train",
                            "coarse_roofline.serve", "buddy_roofline.train",
                            "device_ops_per_batch.train", "idle_share.train", "idle_share.serve"}
    for name, mod in READERS.items():
        assert mod.UNIT and mod.LAYER and "\n" not in mod.LAYER
        assert mod.MOVES == ("serve_hr_mp_per_s" if name.endswith("serve")
                             else "train_patches_per_s")


def test_reduction_takes_the_union_of_spans_and_names_idle_gaps_by_the_host():
    rec = train_record()
    assert rec["busy_s"] == pytest.approx(2.0e-3 + 0.5e-3 + 0.5e-3 + 1.0e-3)
    assert rec["window_s"] == pytest.approx(5.0e-3)
    gaps = dict(rec["idle_gaps"])
    assert gaps["bench.unit"] == pytest.approx(0.5e-3)       # 2.5 -> 3.0 ms
    assert gaps["cudaGraphLaunch"] == pytest.approx(0.5e-3)  # 3.5 -> 4.0 ms
    assert rec["device_ops"][0] == [WGRAD[:120], pytest.approx(1.5e-3)]


def test_training_readers_on_a_canned_record():
    rec = train_record()
    values = harness.per_layer(rec)
    t = work.trunk(16, 24, 24, 64, 16)
    bound = 2 * work.bound_seconds(*t["fwd"]) + 2 * work.bound_seconds(*t["bwd"])
    assert values["trunk_roofline.train"]["value"] == pytest.approx(100 * bound / 2.0e-3)
    assert values["step_mfu.train"]["value"] == pytest.approx(
        100 * work.train_flops_per_patch(CFG, "gan") * 2000.0 / work.PEAK_BF16_FLOPS)
    assert values["device_ops_per_batch.train"]["value"] == 5 / 4
    assert values["idle_share.train"]["value"] == pytest.approx(100 * (1 - 4.0 / 5.0))
    assert "buddy_roofline.train" in values  # a K7 span and two calls
    assert not any(k.endswith(".serve") for k in values)


def test_buddy_roofline_reads_the_st_recipe():
    value = READERS["buddy_roofline.train"].read(train_record(ST))
    sel = work.bound_seconds(*work.buddy_selection(16, 1024, 1344, 27))
    assert value == pytest.approx(100 * 2 * sel / 0.5e-3)


def test_serving_readers_on_a_canned_record():
    values = harness.per_layer(serve_record())
    bound = work.bound_seconds(*work.coarse_tail(1, 1080, 1920, 256, 3))
    assert values["coarse_roofline.serve"]["value"] == pytest.approx(100 * bound / 1.2e-3)
    assert values["frame_mfu.serve"]["value"] == pytest.approx(
        100 * work.generator_fwd_flops(540, 960, CFG) * 30.0 / work.PEAK_BF16_FLOPS)
    assert values["idle_share.serve"]["value"] == pytest.approx(100 * 0.3e-3 / 30e-3)
    assert not any(k.endswith(".train") for k in values)


@pytest.mark.parametrize("reader", ["trunk_roofline.train", "buddy_roofline.train"])
def test_a_roofline_whose_kernels_are_absent_reads_nothing(reader):
    rec = train_record(ops=[(0.0, 1e-3, TORCH_REDUCE), (1e-3, 2e-3, "Memset (Device)")])
    assert READERS[reader].read(rec) is None


def test_kernel_a_absent_from_serving_reads_nothing():
    assert READERS["coarse_roofline.serve"].read(serve_record([(0.0, 1e-3, "cudnn")])) is None


def test_a_recipe_whose_work_is_not_counted_gives_no_mfu():
    cfg = dict(CFG, criteria={"ContentVGG": {"kind": "content_vgg", "weight": 1.0}})
    assert READERS["step_mfu.train"].read(train_record(cfg)) is None
