"""Kernel R's plain version, buffer, gate and weight cache on the CPU
(kernels/rrdb_dense.py): the plain version against RRDBNet's dense trunk
(models/rrdb.py, the RRDBs of the `g.trunk` region) at the published
widths, the dense block's buffer slices, the two fused residual forms, the
gate as a pure function, the weight layout and its cache, and the
generator's routing. The kernel itself is held to the plain version on
the card (tests/test_torch_cuda.py). Imports no JAX."""

import math

import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
from srgan_st_tpu_torch import kernels
from srgan_st_tpu_torch.kernels import rrdb_dense as R
from srgan_st_tpu_torch.kernels.packed_trunk import _conv
from srgan_st_tpu_torch.models.rrdb import RES_SCALE, SLOPE, RRDBNet

NF, GC = 64, 32


def _model(num_block=2, dtype=torch.float32, seed=5, gain=2.0):
    """RRDBNet at the published widths, its dense convs N(0, gain^2 /
    fan_in) with biases N(0, 0.05^2): weights under which each block moves
    the output well past bf16 rounding (the benchmark cell's draw, with
    biases)."""
    m = RRDBNet(channels=NF, num_block=num_block, growth=GC, dtype=dtype)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for conv in m._dense_convs:
            fan_in = conv.weight[0].numel()
            conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen)
                              * (gain / math.sqrt(fan_in)))
            conv.bias.copy_(0.05 * torch.randn(conv.bias.shape, generator=gen))
    return m.eval()


def _stem(shape, dtype=torch.float32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=gen).to(dtype).contiguous()


def _body(m, x):
    """The RRDBs as the modules compute them (torch.cat, separate bias,
    LeakyReLU and residual passes): NHWC in and out."""
    with torch.no_grad():
        return m.body(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def _operands(m):
    return m._dense_weights.get(
        [(c._parameters["weight"], c._parameters["bias"]) for c in m._dense_convs])


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


def _plain_kernel(calls=None):
    """A stand-in for the wrapper on the CPU, which has no kernel: the
    plain version, each call's input shape kept in `calls`."""
    def run(x, ws, bs, slope, scale, laid=None):
        if calls is not None:
            calls.append(tuple(x.shape))
        return R.rrdb_dense_reference(x, ws, bs, slope, scale)
    return run


def _reference(m, x, scale=RES_SCALE, slope=SLOPE):
    ws, bs, _ = _operands(m)
    with torch.no_grad():
        return R.rrdb_dense_reference(x, ws, bs, slope, scale)


F32_TOL = 1e-5  # of max|modules|: the same f32 function, other summation orders


@pytest.mark.parametrize("shape", [(1, 6, 7, NF), (2, 5, 4, NF), (1, 9, 3, NF)])
def test_reference_matches_the_dense_trunk_in_f32(shape):
    """f32: the plain version within 1e-5 of max|trunk| of the modules'
    RRDBs (2 RRDBs at 64 / 32)."""
    m = _model()
    x = _stem(shape)
    want = _body(m, x)
    got = _reference(m, x)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert _err(got, want) <= F32_TOL * float(want.abs().max())
    assert _err(want, x) > 0.1 * float(x.abs().max())  # the RRDBs move the features


def _bf16_gaps(m32, m16, x16, scale):
    ref32 = _body(m32, x16.float())
    env = _err(_body(m16, x16), ref32)
    return _err(_reference(m16, x16, scale), ref32), env


@pytest.mark.parametrize("shape", [(1, 6, 7, NF), (2, 5, 4, NF)])
def test_reference_bf16_within_the_blocks_envelope(shape):
    """bf16: within 2x the modules' own bf16-vs-f32 envelope on the same
    bf16 input (one rounding a conv against the modules' rounding at
    every step)."""
    x16 = _stem(shape, torch.bfloat16)
    err, env = _bf16_gaps(_model(), _model(dtype=torch.bfloat16), x16, RES_SCALE)
    assert 0 < env and err <= 2 * env


@pytest.mark.parametrize("check", ["f32", "bf16"])
def test_a_residual_scale_of_a_quarter_fails_the_comparisons(check):
    """The residual scale 0.25 in place of 0.2 in the plain version (both
    residuals of every block) is far outside the f32 tolerance and the
    bf16 envelope above: these tests see a 25% residual change, which the
    benchmark cell's frame check does not on most seeds (PERF.md)."""
    x = _stem((1, 6, 7, NF))
    m = _model()
    if check == "f32":
        want = _body(m, x)
        assert _err(_reference(m, x, 0.25), want) > 100 * F32_TOL * float(want.abs().max())
    else:
        x16 = x.bfloat16()
        err, env = _bf16_gaps(m, _model(dtype=torch.bfloat16), x16, 0.25)
        assert err > 4 * env


def test_dense_block_buffer_holds_each_feature_in_its_slice():
    """The block's buffer: x in channels 0..63, x_k in 64 + 32 (k-1) ..
    64 + 32 k - 1, each x_k the module's lrelu(conv_k(cat(x, .., x_{k-1})))."""
    m = _model(num_block=1)
    x = _stem((1, 5, 6, NF))
    ws, bs, _ = _operands(m)
    with torch.no_grad():
        buf = R.dense_features(x, ws[:5], bs[:5], SLOPE)
        rdb = m.body[0].rdb1
        feats = x.permute(0, 3, 1, 2)
        want = [x]
        for conv in (rdb.conv1, rdb.conv2, rdb.conv3, rdb.conv4):
            xk = torch.nn.functional.leaky_relu(conv(feats), SLOPE)
            want.append(xk.permute(0, 2, 3, 1))
            feats = torch.cat([feats, xk], 1)
    assert buf.shape == (1, 5, 6, NF + 4 * GC)
    assert torch.equal(buf[..., :NF], x)
    for k in range(1, 5):
        lo = NF + (k - 1) * GC
        part = buf[..., lo:lo + GC]
        assert _err(part, want[k]) <= F32_TOL * float(want[k].abs().max()), k
        # the neighbouring slices hold other features
        assert _err(part, want[k - 1][..., :GC]) > 0.01


def test_the_two_fused_residual_forms_round_once_a_conv():
    """bf16: the plain version equals, bit for bit, the f32 arithmetic of
    one RRDB rounded once a conv: c1..c4 bias then LeakyReLU; c5 of the
    first two blocks x + s (acc + b); c5 of the third x_rrdb + s (x + s
    (acc + b)), x_rrdb the RRDB's input."""
    m = _model(num_block=1, dtype=torch.bfloat16)
    x = _stem((1, 5, 6, NF), torch.bfloat16)
    ws, bs, _ = _operands(m)
    s = RES_SCALE
    h = x
    for j in range(3):
        feats = h
        for k in range(4):
            a = _conv(feats, ws[5 * j + k].bfloat16()) + bs[5 * j + k]
            feats = torch.cat([feats, torch.where(a >= 0, a, SLOPE * a).bfloat16()], -1)
        acc = _conv(feats, ws[5 * j + 4].bfloat16()) + bs[5 * j + 4]
        v = h.float() + s * acc
        if j == 2:
            v = x.float() + s * v
        h = v.bfloat16()
    assert torch.equal(_reference(m, x), h)
    # the third block's form is not the second's: without the RRDB residual
    # the result differs
    assert not torch.equal(_reference(m, x), (h.float() - x.float()).bfloat16())


def test_eval_forward_routes_the_rrdbs_through_kernel_r(monkeypatch):
    """Where the gate holds (forced here: the CPU never meets it), the eval
    forward runs the RRDBs as one rrdb_dense call (the plain version stands
    in for the kernel here); conv_body, the skip and the HR stage are
    unchanged."""
    calls = []
    monkeypatch.setattr(R, "rrdb_dense", _plain_kernel(calls))
    monkeypatch.setattr(R, "gate", lambda *a: True)
    m = _model()
    lr = torch.rand(1, 6, 7, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = m(lr)
        monkeypatch.setattr(R, "gate", lambda *a: False)
        want = m(lr)
    assert calls == [(1, 6, 7, NF)]
    assert got.shape == want.shape == (1, 24, 28, 3)
    assert _err(got, want) <= 1e-5


def test_the_forward_asks_the_gate_what_it_observes(monkeypatch):
    seen = []
    monkeypatch.setattr(R, "gate", lambda *a: seen.append(a) or False)
    m = _model(num_block=1, dtype=torch.bfloat16)
    with torch.no_grad():
        m(torch.rand(1, 4, 5, 3))
    m.train()
    m(torch.rand(1, 4, 5, 3))
    assert seen == [(False, False, "cpu", torch.bfloat16, NF, GC),
                    (True, True, "cpu", torch.bfloat16, NF, GC)]


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("args,takes", [
    ((False, False, "cuda", BF16, 64, 32), True),
    ((True, False, "cuda", BF16, 64, 32), False),    # training
    ((False, True, "cuda", BF16, 64, 32), False),    # gradients: no backward
    ((False, False, "cuda", F32, 64, 32), False),    # f32
    ((False, False, "cuda", torch.float16, 64, 32), False),
    ((False, False, "cpu", BF16, 64, 32), False),    # the CPU
    ((False, False, "cuda", BF16, 32, 32), False),   # another width
    ((False, False, "cuda", BF16, 64, 16), False),   # another growth
    ((False, False, "cuda", BF16, 16, 8), False),
])
def test_gate(args, takes):
    assert R.gate(*args) is takes


def test_layout_is_the_chunked_ring_image():
    """One bf16 image a conv, [chunk][tap][k group][out][8 in] with input
    channel 32 chunk + 8 k group + j, the convs in order; f32 biases."""
    gen = torch.Generator().manual_seed(3)
    shapes = [(3, 3, cin, cout) for cin, cout in R.conv_channels(NF, GC)]
    ws = [torch.randn(s, generator=gen) for s in shapes]
    bs = [torch.randn(s[-1], generator=gen) for s in shapes]
    wimg, bias = R.layout(ws, bs)
    assert wimg.dtype == torch.bfloat16 and wimg.numel() == 9 * 26624 == 239616
    assert bias.dtype == torch.float32 and bias.numel() == 4 * GC + NF
    off = sum(9 * ci * co for ci, co in R.conv_channels(NF, GC)[:4])  # c5's image
    img = wimg[off:].reshape(6, 9, 4, NF, 8)
    g, tap, kg, co, j = 4, 7, 2, 45, 3
    assert img[g, tap, kg, co, j] == ws[4][tap // 3, tap % 3, 32 * g + 8 * kg + j, co].bfloat16()
    off2 = 9 * NF * GC  # c2's image
    img2 = wimg[off2:off2 + 9 * 96 * GC].reshape(3, 9, 4, GC, 8)
    assert img2[2, 0, 3, 31, 7] == ws[1][0, 0, 64 + 24 + 7, 31].bfloat16()
    assert torch.equal(bias[4 * GC:], bs[4]) and torch.equal(bias[GC:2 * GC], bs[1])


def test_weight_cache_rebuilds_only_on_a_change():
    """The operands are kept across calls; an in-place change of a weight
    or a bias, or a graph replay (kernels.generation), rebuilds them."""
    m = _model(num_block=1)
    first = _operands(m)
    assert _operands(m) is first and first[2] is None  # no kernel layout off CUDA
    assert len(first[0]) == 15 and first[0][4].shape == (3, 3, 192, 64)
    assert torch.equal(first[0][7], m.body[0].rdb2.conv3.weight.permute(2, 3, 1, 0))
    w5, b2 = first[0][14].clone(), first[1][1].clone()
    with torch.no_grad():
        m.body[0].rdb3.conv5.weight.mul_(2.0)
    ops = _operands(m)
    assert ops is not first and torch.equal(ops[0][14], 2.0 * w5)
    with torch.no_grad():
        m.body[0].rdb1.conv2.bias.add_(1.0)
    again = _operands(m)
    assert again is not ops and torch.equal(again[1][1], b2 + 1.0)
    before = kernels.generation
    kernels.generation += 1
    try:
        bumped = _operands(m)
        assert bumped is not again and _operands(m) is bumped
    finally:
        kernels.generation = before


def test_launch_counter_is_registered():
    assert "rrdb_dense" in kernels.launch_counts()
    kernels.reset_launch_counts()
    assert kernels.launch_counts()["rrdb_dense"] == 0


def test_wrapper_runs_the_plain_version_on_the_cpu_and_raises_off_the_kernel(monkeypatch):
    """On the CPU the generator runs the torch blocks (its gate fails there
    and the wrapper is never called); the wrapper has no CPU path of its
    own: a CPU tensor raises and counts no call."""
    m = _model(num_block=1, dtype=torch.bfloat16)
    x = _stem((1, 4, 4, NF), torch.bfloat16)
    ws, bs, _ = _operands(m)
    before = R.launches
    with pytest.raises(ValueError, match="no kernel for device"):
        R.rrdb_dense(x, ws, bs, SLOPE, RES_SCALE)
    assert R.launches == before
    calls = []
    monkeypatch.setattr(R, "rrdb_dense", _plain_kernel(calls))
    lr = torch.rand(1, 4, 5, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = m(lr)
    assert calls == [] and got.shape == (1, 16, 20, 3)


def test_tiled_eval_with_the_kernel_path_equals_the_whole_frame(monkeypatch):
    """The kernel's path (forced; its plain version on the CPU) tiled at
    the exact halo equals the whole frame through the same path: kernel R
    takes any B, H, W, the ragged edge tiles among them."""
    from srgan_st_tpu_torch.eval.tiled import TiledApplier, generator_halo

    monkeypatch.setattr(R, "gate", lambda *a: True)
    monkeypatch.setattr(R, "rrdb_dense", _plain_kernel())
    m = _model(num_block=1)
    halo = generator_halo(1, 4, "rrdb")

    def fn(x):
        with torch.no_grad():
            return m(torch.as_tensor(x))

    x = torch.rand(1, 55, 62, 3, generator=torch.Generator().manual_seed(5))
    whole = fn(x).numpy()
    tiled = TiledApplier(fn, upscale=4, tile=12, halo=halo, tile_batch=4)(x)
    assert tiled.shape == whole.shape and np.abs(tiled - whole).max() <= 1e-5
