"""Kernel H's plain version, phase weights, gate, weight cache and routing
on the CPU (kernels/rrdb_hr.py): the plain version against RRDBNet's HR
stage (models/rrdb.py, the `g.upsample` and `g.tail` regions: nearest x2
copies, cuDNN-style convs with bias, LeakyReLU passes, the clamp), the
four phases' 2x2 kernels against a nearest x2 and a 3x3 conv in float64,
the gate as a pure function, the layout and its cache, and the
generator's routing. The kernel itself is held to the plain version on
the card (tests/test_torch_cuda.py). Imports no JAX."""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
from srgan_st_tpu_torch import kernels
from srgan_st_tpu_torch.kernels import rrdb_hr as H
from srgan_st_tpu_torch.models.rrdb import SLOPE, RRDBNet, lrelu
from srgan_st_tpu_torch.utils import profiling

NF = 64


def _model(dtype=torch.float32, seed=3, num_block=1):
    """RRDBNet at the published widths, its HR convs N(0, 2 / fan_in)
    (conv_last's N(0, 1 / fan_in)) with biases N(0, 0.05^2) (conv_last's
    + 0.5): a frame mostly inside (0, 1), clamped on both sides."""
    m = RRDBNet(channels=NF, num_block=num_block, dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for conv, gain in zip(m._hr_convs, (2.0, 2.0, 2.0, 1.0)):
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen)
                              * math.sqrt(gain / conv.weight[0].numel()))
            conv.bias.copy_(0.05 * torch.randn(conv.bias.shape, generator=gen))
        m.conv_last.bias.add_(0.5)
    return m.eval()


def _feat(shape, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return (torch.rand(*shape, generator=gen) - 0.5).to(dtype).contiguous()


def _stage(m, x):
    """The HR stage as the modules compute it, NHWC in and out."""
    with torch.no_grad():
        feat = x.permute(0, 3, 1, 2)
        for conv in (m.conv_up1, m.conv_up2):
            feat = lrelu(conv(F.interpolate(feat, scale_factor=2, mode="nearest")))
        out = m.conv_last(lrelu(m.conv_hr(feat)))
        return torch.clamp(out.float(), 0.0, 1.0).permute(0, 2, 3, 1)


def _operands(m):
    return m._hr_weights.get(
        [(c._parameters["weight"], c._parameters["bias"]) for c in m._hr_convs])


def _reference(m, x):
    ws, bs, _ = _operands(m)
    with torch.no_grad():
        return H.rrdb_hr_reference(x, ws, bs, SLOPE)


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


SHAPES = [(1, 7, 9, NF), (2, 5, 12, NF), (3, 13, 11, NF)]  # the last a batch of odd tiles
F32_TOL = 1e-5  # of the frame's range [0, 1]: the same f32 function, other summation orders


@pytest.mark.parametrize("shape", SHAPES)
def test_reference_matches_the_hr_stage_in_f32(shape):
    """f32: the plain version (four phases' 2x2 convs for each nearest x2 +
    conv, one rounding a conv) within 1e-5 of the modules' HR stage."""
    m = _model()
    x = _feat(shape)
    want = _stage(m, x)
    got = _reference(m, x)
    b, h, w, _ = shape
    assert got.dtype == torch.float32 and got.shape == want.shape == (b, 4 * h, 4 * w, 3)
    assert _err(got, want) <= F32_TOL
    # the frame is neither flat nor all clamped
    inside = ((want > 0) & (want < 1)).float().mean()
    assert 0.5 < float(inside) < 1 and float(want.std()) > 0.05


def _conv64(x, w):
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)


def test_phase_weights_are_a_nearest_x2_and_a_3x3_conv_in_float64():
    """Each phase's 2x2 conv of the LR map, its kernels summed from the 3x3
    taps, equals the nearest x2 followed by the 3x3 SAME conv, to float64
    rounding; and no tap is dropped: each phase's four taps sum to the
    nine."""
    gen = torch.Generator().manual_seed(9)
    x = torch.randn(2, 6, 5, NF, generator=gen, dtype=torch.float64)
    w = torch.randn(3, 3, NF, 16, generator=gen, dtype=torch.float64)
    pw = H.phase_weights(w)
    assert pw.shape == (2, 2, 2, 2, NF, 16) and pw.dtype == torch.float64
    up = x.repeat_interleave(2, 1).repeat_interleave(2, 2)
    want = _conv64(up, w)
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1))
    for py in range(2):
        for px in range(2):
            got = F.conv2d(xp[:, :, py:py + 7, px:px + 6], pw[py, px].permute(3, 2, 0, 1))
            d = (got.permute(0, 2, 3, 1) - want[:, py::2, px::2]).abs().max()
            assert float(d) <= 1e-12 * float(want.abs().max()), (py, px)
            assert torch.allclose(pw[py, px].sum((0, 1)), w.sum((0, 1)), rtol=0, atol=1e-12)
    # the f32 plain conv is the same function
    got32 = H.upsample_conv(x.float(), w.float(), torch.zeros(16), 1.0)
    assert _err(got32, want) <= 1e-5 * float(want.abs().max())


def test_phase_weights_round_once_from_an_f32_sum():
    """bf16: each phase tap is the f32 sum of its 3x3 taps rounded once,
    which is not the sum of the taps each rounded (the modules' bf16
    kernel seen through the nearest x2)."""
    gen = torch.Generator().manual_seed(4)
    w = torch.randn(3, 3, NF, NF, generator=gen)
    img = H.layout([w] * 3 + [w[..., :3]], [torch.zeros(NF)] * 3 + [torch.zeros(3)])[0]
    img = img.reshape(2, 2, 2, 2, NF // 8, NF, 8)
    # py = px = 0, taps i = j = 1: rows {1, 2}, columns {1, 2}
    want = ((w[1, 1] + w[2, 1]) + (w[1, 2] + w[2, 2])).bfloat16()
    got = img[0, 0, 1, 1].permute(0, 2, 1).reshape(NF, NF)  # (k group, out, 8 in) -> (in, out)
    assert torch.equal(got, want)
    rounded = sum(w[ky, kx].bfloat16().float() for ky in (1, 2) for kx in (1, 2))
    assert not torch.equal(rounded.bfloat16(), want)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_reference_bf16_within_the_modules_envelope(shape):
    """bf16: the plain version within the modules' own bf16-vs-f32
    envelope on the same bf16 input (one rounding a conv, where the
    modules round each conv, bias add and LeakyReLU)."""
    x16 = _feat(shape, torch.bfloat16)
    m32, m16 = _model(), _model(torch.bfloat16)
    ref32 = _stage(m32, x16.float())
    env = _err(_stage(m16, x16), ref32)
    err = _err(_reference(m16, x16), ref32)
    assert 0 < env and err <= env


def test_a_wrong_phase_fails_the_comparisons(monkeypatch):
    """The up convs' phases swapped (py = 0 taps for py = 1 rows) are far
    outside the f32 tolerance and the bf16 envelope."""
    m = _model()
    x = _feat((1, 7, 9, NF))
    ws, bs, _ = _operands(m)
    want = _stage(m, x)
    monkeypatch.setattr(H, "_PHASE_TAPS", H._PHASE_TAPS[::-1])
    bad = H.rrdb_hr_reference(x, ws, bs, SLOPE)
    monkeypatch.undo()
    x16 = x.bfloat16()
    env = _err(_stage(_model(torch.bfloat16), x16), _stage(m, x16.float()))
    assert _err(bad, want) > 20 * env > 1000 * F32_TOL


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("args,takes", [
    ((False, False, "cuda", BF16, 64, 3), True),
    ((True, False, "cuda", BF16, 64, 3), False),    # training
    ((False, True, "cuda", BF16, 64, 3), False),    # gradients: no backward
    ((False, False, "cuda", F32, 64, 3), False),    # f32
    ((False, False, "cuda", torch.float16, 64, 3), False),
    ((False, False, "cpu", BF16, 64, 3), False),    # the CPU
    ((False, False, "cuda", BF16, 32, 3), False),   # another width
    ((False, False, "cuda", BF16, 64, 1), False),   # another frame
    ((False, False, "cuda", BF16, 64, 4), False),
])
def test_gate(args, takes):
    assert H.gate(*args) is takes


def test_the_forward_asks_the_gate_what_it_observes(monkeypatch):
    seen = []
    monkeypatch.setattr(H, "gate", lambda *a: seen.append(a) or False)
    m = _model(torch.bfloat16)
    with torch.no_grad():
        m(torch.rand(1, 4, 5, 3))
    m.train()
    m(torch.rand(1, 4, 5, 3))
    assert seen == [(False, False, "cpu", BF16, NF, 3), (True, True, "cpu", BF16, NF, 3)]


def test_layout_is_the_kernels_images():
    """bf16 images [..][k group][out][8 in] with input channel 8 k group +
    j: the up convs' four phases' 2x2 taps, conv_hr's 9 taps, conv_last's
    with its outputs padded to 8 with zeros; the f32 biases in order,
    conv_last's padded."""
    m = _model()
    ws, bs, laid = _operands(m)
    assert laid is None  # no kernel layout off CUDA
    up1, up2, hr, last, bias = H.layout(ws, bs)
    assert all(t.dtype == BF16 for t in (up1, up2, hr, last)) and bias.dtype == F32
    assert up1.numel() == up2.numel() == 16 * NF * NF and hr.numel() == 9 * NF * NF
    assert last.numel() == 9 * NF * H.NOUT and bias.numel() == 3 * NF + H.NOUT
    pw = H.phase_weights(ws[1])
    img = up2.reshape(2, 2, 2, 2, NF // 8, NF, 8)
    assert img[1, 0, 1, 0, 5, 17, 3] == pw[1, 0, 1, 0, 43, 17].bfloat16()
    img = hr.reshape(9, NF // 8, NF, 8)
    assert img[7, 2, 60, 5] == ws[2][2, 1, 21, 60].bfloat16()
    img = last.reshape(9, NF // 8, H.NOUT, 8)
    assert img[4, 7, 2, 1] == ws[3][1, 1, 57, 2].bfloat16()
    assert not img[:, :, 3:].any()
    assert torch.equal(bias[:NF], bs[0]) and torch.equal(bias[2 * NF:3 * NF], bs[2])
    assert torch.equal(bias[3 * NF:3 * NF + 3], bs[3]) and not bias[3 * NF + 3:].any()


def test_weight_cache_rebuilds_only_on_a_change():
    """The operands are kept across calls; an in-place change of one of
    the ten parameters, or a graph replay (kernels.generation), rebuilds
    them; a change elsewhere in the network does not."""
    m = _model()
    first = _operands(m)
    assert _operands(m) is first
    assert [tuple(w.shape) for w in first[0]] == [(3, 3, NF, NF)] * 3 + [(3, 3, NF, 3)]
    assert torch.equal(first[0][2], m.conv_hr.weight.permute(2, 3, 1, 0))
    with torch.no_grad():
        m.conv_body.weight.mul_(2.0)
        m.body[0].rdb1.conv1.bias.add_(1.0)
    assert _operands(m) is first
    w_last = first[0][3].clone()
    with torch.no_grad():
        m.conv_last.weight.mul_(2.0)
    ops = _operands(m)
    assert ops is not first and torch.equal(ops[0][3], 2.0 * w_last)
    b1 = ops[1][0].clone()
    with torch.no_grad():
        m.conv_up1.bias.add_(1.0)
    again = _operands(m)
    assert again is not ops and torch.equal(again[1][0], b1 + 1.0)
    before = kernels.generation
    kernels.generation += 1
    try:
        bumped = _operands(m)
        assert bumped is not again and _operands(m) is bumped
    finally:
        kernels.generation = before


def test_launch_counter_is_registered():
    assert "rrdb_hr" in kernels.launch_counts()
    kernels.reset_launch_counts()
    assert kernels.launch_counts()["rrdb_hr"] == 0


def test_wrapper_runs_the_plain_version_on_the_cpu():
    """On a CPU tensor the two calls run the plain version's two parts,
    which compose to `rrdb_hr_reference`, and count no kernel call; the
    tail call takes no CPU tensor's Planes and no CUDA tensor."""
    m = _model(torch.bfloat16)
    x = _feat((2, 5, 6, NF), torch.bfloat16)
    ws, bs, _ = _operands(m)
    before = H.launches
    up = H.rrdb_hr_upsample(x, ws, bs, SLOPE)
    assert up.shape == (2, 20, 24, NF) and up.dtype == BF16
    got = H.rrdb_hr_tail(up, ws, bs, SLOPE)
    assert torch.equal(got, H.rrdb_hr_reference(x, ws, bs, SLOPE))
    assert got.dtype == F32 and got.shape == (2, 20, 24, 3)
    assert H.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        H.rrdb_hr_tail(H.Planes(up.reshape(-1), tuple(up.shape)), ws, bs, SLOPE)


@pytest.mark.parametrize("w", [5, 6])
def test_planes_read_back_as_nhwc(w):
    """The kernel's layout of a map, 8 planes of 8 channels over the
    zero-bordered grid, each stored row an even number of pixels with x = 0
    at index 2: `Planes.nhwc` reads the interior back."""
    b, h = 2, 3
    assert H.padded_width(w) == {5: 8, 6: 10}[w]
    x = torch.randn(b, h, w, NF)
    right = H.padded_width(w) - w - 2
    planes = F.pad(x.reshape(b, h, w, NF // 8, 8).permute(3, 0, 1, 2, 4),
                   (0, 0, 2, right, 1, 1))
    buf = torch.cat([planes.reshape(-1), torch.zeros(40)])
    got = H.Planes(buf, (b, h, w, NF))
    assert torch.equal(got.nhwc(), x)
    assert got.grid().shape == (8, b, h + 2, H.padded_width(w), 8)


def _plain_wrappers(calls):
    """Stand-ins for the wrappers that note the open spans of each call
    and run the plain version."""
    def up(x, ws, bs, slope, laid=None):
        calls.append(("upsample", [name for name, _ in profiling._stack], tuple(x.shape)))
        return H.upsample_reference(x, ws, bs, slope)

    def tail(u, ws, bs, slope, laid=None):
        calls.append(("tail", [name for name, _ in profiling._stack], tuple(u.shape)))
        return H.tail_reference(u, ws, bs, slope)
    return up, tail


def test_eval_forward_routes_the_hr_stage_through_kernel_h(monkeypatch):
    """Where the gate holds (forced here: the CPU never meets it), the eval
    forward runs the HR stage as one upsample call under `g.upsample` and
    one tail call under `g.tail`, within the f32 tolerance of the modules'
    stage; the stem and trunk are unchanged."""
    from torch.profiler import ProfilerActivity, profile

    calls = []
    up, tail = _plain_wrappers(calls)
    monkeypatch.setattr(H, "rrdb_hr_upsample", up)
    monkeypatch.setattr(H, "rrdb_hr_tail", tail)
    monkeypatch.setattr(H, "gate", lambda *a: True)
    m = _model()
    lr = torch.rand(1, 6, 7, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        with profile(activities=[ProfilerActivity.CPU]):
            got = m(lr)
        monkeypatch.setattr(H, "gate", lambda *a: False)
        want = m(lr)
    assert calls == [("upsample", ["g.forward", "g.upsample"], (1, 6, 7, NF)),
                     ("tail", ["g.forward", "g.tail"], (1, 24, 28, NF))]
    assert got.shape == want.shape == (1, 24, 28, 3)
    assert _err(got, want) <= F32_TOL


def test_tiled_eval_with_the_kernel_path_equals_the_whole_frame(monkeypatch):
    """The kernel's path (forced; its plain version on the CPU) tiled at
    the exact halo equals the whole frame through the same path: kernel H
    takes any B, H, W, the ragged edge tiles among them."""
    from srgan_st_tpu_torch.eval.tiled import TiledApplier, generator_halo

    monkeypatch.setattr(H, "gate", lambda *a: True)
    m = _model()
    halo = generator_halo(1, 4, "rrdb")

    def fn(x):
        with torch.no_grad():
            return m(torch.as_tensor(x))

    x = torch.rand(1, 47, 58, 3, generator=torch.Generator().manual_seed(5))
    whole = fn(x).numpy()
    tiled = TiledApplier(fn, upscale=4, tile=12, halo=halo, tile_batch=4)(x)
    assert tiled.shape == whole.shape and np.abs(tiled - whole).max() <= 1e-5
