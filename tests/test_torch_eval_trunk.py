"""Kernel E's plain version, gate and weight cache on the CPU
(kernels/eval_trunk.py): the plain version against the generator's unfused
eval blocks (the `g.trunk` region: blocks, fusion layer, global skip), the
gate as a pure function, the export's trunk, and the layout cache's keys.
The kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py)."""

import pytest
import torch

from tests import torch_threads  # noqa: F401  (this process's share of the cores)
from srgan_st_tpu_torch import kernels
from srgan_st_tpu_torch.eval.export import export_trunk_mode
from srgan_st_tpu_torch.kernels import eval_trunk as et
from srgan_st_tpu_torch.models.generator import Generator, random_variables
from srgan_st_tpu_torch.train.checkpoint import generator_state_dict_from_variables


def _generator(dtype, channels=16, num_rcb=3, seed=4, trunk_mode=None):
    g = Generator(channels=channels, num_rcb=num_rcb, dtype=dtype, trunk_mode=trunk_mode)
    g.load_state_dict(generator_state_dict_from_variables(
        random_variables(seed, channels=channels, num_rcb=num_rcb)))
    return g.eval()


def _blocks(g, x):
    """The g.trunk region on the unfused eval blocks: NHWC in and out."""
    h = g._trunk(x, False, "unfused").permute(0, 3, 1, 2)
    h = g.conv2[1](g.conv2[0](h), False) + x.permute(0, 3, 1, 2)
    return h.permute(0, 2, 3, 1)


def _stem(shape, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=gen)).to(dtype).contiguous()


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("shape", [(1, 7, 9, 16), (2, 6, 5, 16), (1, 12, 3, 16)])
def test_reference_matches_the_eval_blocks_in_f32(shape):
    """f32: the plain version (each BatchNorm as its f32 affine) within
    1e-5 of max|blocks| of the blocks' (x - m) rsqrt(v + eps) w + b."""
    g = _generator(torch.float32)
    x = _stem(shape, torch.float32)
    with torch.no_grad():
        ref = _blocks(g, x)
        got = g._eval_trunk(x)
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert _err(got, ref) <= 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("shape", [(1, 7, 9, 16), (2, 6, 5, 16)])
def test_reference_bf16_within_the_blocks_envelope(shape):
    """bf16: within 2x the blocks' own bf16-vs-f32 envelope on the same
    bf16 input (one rounding a conv against the blocks' rounding at every
    step)."""
    x16 = _stem(shape, torch.bfloat16)
    with torch.no_grad():
        ref32 = _blocks(_generator(torch.float32), x16.float())
        blocks16 = _blocks(_generator(torch.bfloat16), x16)
        got = _generator(torch.bfloat16)._eval_trunk(x16)
    env = _err(blocks16, ref32)
    assert got.dtype == torch.bfloat16
    assert 0 < env and _err(got, ref32) <= 2 * env


def test_reference_rounds_once_a_conv():
    """Each conv's epilogue output is rounded once: the plain version's
    first block equals the f32 arithmetic rounded at the two conv outputs."""
    g = _generator(torch.bfloat16, num_rcb=1)
    x = _stem((1, 5, 6, 16), torch.bfloat16)
    ws, scale, shift, alphas, _ = g._eval_trunk_operands()
    from srgan_st_tpu_torch.kernels.packed_trunk import _conv

    a = _conv(x, ws[0].bfloat16()) * scale[0] + shift[0]
    a = torch.where(a >= 0, a, alphas[0] * a).bfloat16()
    h = (_conv(a, ws[1].bfloat16()) * scale[1] + shift[1] + x.float()).bfloat16()
    y = (_conv(h, ws[2].bfloat16()) * scale[2] + shift[2] + x.float()).bfloat16()
    assert torch.equal(et.eval_trunk_reference(x, ws, scale, shift, alphas), y)


def test_eval_forward_routes_the_trunk_region_through_kernel_e(monkeypatch):
    """Where the gate holds (forced here: the CPU never meets it), the eval
    forward runs the g.trunk region as one eval_trunk call, which on a CPU
    tensor is the plain version; the rest of the forward is unchanged."""
    calls = []
    real = et.eval_trunk
    monkeypatch.setattr(et, "eval_trunk", lambda *a: calls.append(1) or real(*a))
    monkeypatch.setattr(et, "gate", lambda *a: True)
    g = _generator(torch.float32)
    lr = torch.rand(1, 6, 7, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        assert g._trunk_mode(False, _stem((1, 6, 7, 16), torch.float32)) == "eval"
        got = g(lr)
        monkeypatch.setattr(et, "gate", lambda *a: False)
        want = g(lr)
    assert calls == [1]
    assert got.shape == want.shape == (1, 24, 28, 3)
    assert _err(got, want) <= 1e-5


BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("args,takes", [
    ((False, False, "cuda", BF16, 64, None), True),
    ((False, False, "cuda", BF16, 64, "packed"), True),
    ((False, False, "cuda", BF16, 64, "hybrid"), True),
    ((False, False, "cuda", BF16, 64, "fused"), True),
    ((True, False, "cuda", BF16, 64, None), False),       # a train step
    ((False, True, "cuda", BF16, 64, None), False),       # gradients: no backward
    ((False, False, "cuda", F32, 64, None), False),       # f32
    ((False, False, "cuda", BF16, 32, None), False),      # another width
    ((False, False, "cpu", BF16, 64, None), False),       # the CPU
    ((False, False, "cuda", BF16, 64, "unfused"), False),  # the blocks, asked for
    ((False, False, "cuda", BF16, 64, "xpack"), False),    # the folded trunk
    ((False, False, "cuda", BF16, 64, "xpack_eval"), False),
])
def test_gate(args, takes):
    assert et.gate(*args) is takes


@pytest.mark.parametrize("mode", [None, "unfused", "packed", "hybrid", "fused", "xpack",
                                  "xpack_eval"])
@pytest.mark.parametrize("dynamic", [True, False])
def test_export_never_takes_kernel_e(mode, dynamic):
    """An export traces the blocks, or the folded trunk for a fixed-shape
    xpack export: never a mode whose eval path is kernel E."""
    got = export_trunk_mode(mode, dynamic)
    assert got == (mode if mode in ("xpack", "xpack_eval") and not dynamic else "unfused")
    assert not et.gate(False, False, "cuda", BF16, 64, got)


def _operands(g):
    convs = [m.weight for blk in g.trunk for m in (blk.rcb[0], blk.rcb[3])] + [g.conv2[0].weight]
    bns = [(b.weight, b.bias, b.running_mean, b.running_var)
           for b in [m for blk in g.trunk for m in (blk.rcb[1], blk.rcb[4])] + [g.conv2[1]]]
    return convs, bns, [blk.rcb[2].weight for blk in g.trunk], 1e-5


def test_weight_cache_rebuilds_only_on_a_change():
    """The layout is kept across calls (the same operands back); an
    in-place change of a parameter or a running statistic, or a graph
    replay (kernels.generation), rebuilds it."""
    g = _generator(torch.float32, num_rcb=2)
    cache = et.EvalTrunkWeights()
    first = cache.get(*_operands(g))
    assert cache.get(*_operands(g)) is first
    x = _stem((1, 4, 5, 16), torch.float32)
    with torch.no_grad():
        g._eval_trunk(x)
        kept = g._eval_trunk_operands()
        g._eval_trunk(x)
    assert g._eval_trunk_operands() is kept

    with torch.no_grad():
        g.trunk[1].rcb[3].weight.mul_(2.0)
    ops = cache.get(*_operands(g))
    assert ops is not first and torch.equal(ops[0][3], 2.0 * first[0][3])
    with torch.no_grad():
        g.trunk[0].rcb[1].running_var.add_(1.0)
    again = cache.get(*_operands(g))
    assert again is not ops and not torch.equal(again[1][0], first[1][0])
    with torch.no_grad():
        g.trunk[0].rcb[2].weight.fill_(0.5)
    ops = cache.get(*_operands(g))
    assert ops is not again and ops[3][0] == 0.5

    before = kernels.generation
    kernels.generation += 1
    try:
        bumped = cache.get(*_operands(g))
        assert bumped is not ops and cache.get(*_operands(g)) is bumped
    finally:
        kernels.generation = before


def test_operands_are_the_blocks_in_order():
    """The stacked operands: conv1_j, conv2_j of each block, then the
    fusion conv, HWIO; each BatchNorm's f32 affine; the PReLU slopes."""
    g = _generator(torch.float32, num_rcb=2)
    ws, scale, shift, alphas, laid = g._eval_trunk_operands()
    assert ws.shape == (5, 3, 3, 16, 16) and laid is None  # no kernel layout off CUDA
    assert torch.equal(ws[2], g.trunk[1].rcb[0].weight.permute(2, 3, 1, 0))
    assert torch.equal(ws[4], g.conv2[0].weight.permute(2, 3, 1, 0))
    bn = g.trunk[1].rcb[4]
    s = bn.weight * torch.rsqrt(bn.running_var + 1e-5)
    assert torch.equal(scale[3], s) and torch.equal(shift[3], bn.bias - bn.running_mean * s)
    assert torch.equal(alphas, torch.cat([g.trunk[0].rcb[2].weight, g.trunk[1].rcb[2].weight]))


def test_launch_counter_is_registered():
    assert "eval_trunk" in kernels.launch_counts()
    kernels.reset_launch_counts()
    assert kernels.launch_counts()["eval_trunk"] == 0


def test_layout_is_the_ring_image_and_the_affine():
    """The kernel's operands: one 73.7 KB bf16 ring image a conv
    ([tap][k group][out][8 in]), [scale, shift] f32 a conv, f32 slopes."""
    gen = torch.Generator().manual_seed(3)
    ws = torch.randn(3, 3, 3, 64, 64, generator=gen)
    scale, shift = torch.rand(3, 64, generator=gen), torch.randn(3, 64, generator=gen)
    wimg, st, al = et.layout(ws, scale, shift, torch.tensor([0.2]))
    assert wimg.dtype == torch.bfloat16 and wimg.numel() * 2 == 3 * 73728
    flat = wimg.reshape(3, 9, 8, 64, 8)
    tap, kg, co, j = 4, 3, 17, 5
    assert flat[2, tap, kg, co, j] == ws[2, tap // 3, tap % 3, 8 * kg + j, co].bfloat16()
    assert torch.equal(st[1, 0], scale[1]) and torch.equal(st[1, 1], shift[1])
    assert al.dtype == torch.float32 and al.shape == (1,)


def test_wrapper_raises_off_the_kernel():
    """On a CPU tensor the wrapper is the plain version; the kernel path
    refuses what the kernel does not take."""
    x = _stem((1, 4, 4, 64), torch.bfloat16)
    ws = torch.zeros(3, 3, 3, 64, 64)
    v = torch.zeros(3, 64)
    with pytest.raises(ValueError, match="no kernel for device"):
        et._launch(x, ws, v, v, torch.zeros(1))
