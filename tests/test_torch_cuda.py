"""The port's hand-written CUDA kernels against their plain versions, on a GPU.

Every test here is marked `cuda` and skips without a GPU. They import no
JAX, so they also run on a machine with only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -p no:cacheprovider

Gates: f32, max|d| <= 1e-4 max|ref| with TF32 off in the plain version;
bf16, within 2x the envelope max|plain in bf16 - plain in f32| on the same
bf16 inputs (a fixed epsilon is wrong for these long contractions).
"""

import numpy as np
import pytest
import torch

from tests import torch_threads  # noqa: F401  (this process's share of the cores)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, *shape, scale=1.0, dev="cpu"):
    return torch.from_numpy((rng.random(shape, dtype=np.float32) - 0.5) * scale).to(dev)


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 8, 8, 32), (2, 10, 140, 48), (1, 12, 16, 16),
                                   (16, 48, 48, 256), (1, 26, 140, 32), (2, 6, 10, 8)])
def test_coarse_conv_matches_plain(dev, shape):
    from srgan_st_tpu_torch.kernels import coarse_conv as cc
    from srgan_st_tpu_torch.ops.subpixel_conv import conv_nhwc, space_to_depth

    rng = np.random.default_rng(0)
    x = _rand(rng, *shape, dev=dev) + 0.5
    w2 = _rand(rng, 5, 5, shape[-1], 12, dev=dev)
    before = cc.launches
    ref = cc.coarse_conv_s2d_reference(x, w2)
    got = cc.coarse_conv_s2d(x, w2)
    torch.cuda.synchronize()
    assert cc.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert _err(got, ref) <= 1e-4 * float(ref.abs().max())
    xb, wb = x.bfloat16(), w2.bfloat16()
    ref_b = cc.coarse_conv_s2d_reference(xb, wb)
    env = _err(space_to_depth(conv_nhwc(xb, wb), 2), ref_b)
    gotb = cc.coarse_conv_s2d(xb, wb)
    assert _err(gotb, ref_b) <= 2 * env
    # a second launch gives the same bits (no atomics, a fixed order)
    assert torch.equal(gotb, cc.coarse_conv_s2d(xb, wb))
    assert torch.equal(got, cc.coarse_conv_s2d(x, w2))


@pytest.mark.cuda
@pytest.mark.parametrize("bhw", [(1, 8, 8), (1, 14, 38), (2, 100, 70), (1, 2, 2),
                                 (1, 10, 62)])
def test_serving_tail_matches_plain(dev, bhw):
    from srgan_st_tpu_torch.kernels import serving_tail as st

    rng = np.random.default_rng(1)
    b, h, w = bhw
    y = _rand(rng, b, h, w, 64, dev=dev)
    w_up, b_up = _rand(rng, 3, 3, 64, 256, scale=0.1, dev=dev), _rand(rng, 256, dev=dev)
    alpha = torch.tensor(0.25, device=dev)
    w3, b3 = _rand(rng, 9, 9, 64, 3, scale=0.03, dev=dev), _rand(rng, 3, dev=dev)
    before = st.launches
    ref = st.serving_tail_reference(y, w_up, b_up, alpha, w3, b3)
    got = st.serving_tail(y, w_up, b_up, alpha, w3, b3)
    torch.cuda.synchronize()
    assert st.launches == before + 1
    assert got.shape == (b, 2 * h, 2 * w, 3)
    assert _err(got, ref) <= 1e-4 * float(ref.abs().max())
    yb = y.bfloat16()
    ref32 = st.serving_tail_reference(yb.float(), w_up.bfloat16().float(), b_up,
                                      alpha, w3.bfloat16().float(), b3)
    env = _err(st.serving_tail_reference(yb, w_up, b_up, alpha, w3, b3), ref32)
    gotb = st.serving_tail(yb, w_up, b_up, alpha, w3, b3)
    assert gotb.dtype == torch.bfloat16
    assert _err(gotb, ref32) <= 2 * env
    # a second launch gives the same bits
    assert torch.equal(gotb, st.serving_tail(yb, w_up, b_up, alpha, w3, b3))
    assert torch.equal(got, st.serving_tail(y, w_up, b_up, alpha, w3, b3))


@pytest.mark.cuda
def test_wrappers_raise_on_inputs_the_kernels_do_not_take(dev):
    """A CUDA tensor launches the kernel or raises; no plain fallback."""
    from srgan_st_tpu_torch.kernels import coarse_conv as cc
    from srgan_st_tpu_torch.kernels import serving_tail as st

    w2 = torch.zeros(5, 5, 16, 12, device=dev)
    with pytest.raises(ValueError, match="even H, W"):
        cc.coarse_conv_s2d(torch.zeros(1, 7, 8, 16, device=dev), w2)
    with pytest.raises(ValueError, match="contiguous"):
        cc.coarse_conv_s2d(torch.zeros(1, 8, 16, 8, device=dev).transpose(2, 3), w2)
    xb = torch.zeros(1, 8, 8, 16, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="layout"):  # the f32 layout given to bf16
        cc.coarse_conv_s2d(xb, w2, cc._layout(w2, dev, torch.float32))
    with pytest.raises(ValueError, match="even H, W"):
        st.serving_tail(torch.zeros(1, 7, 8, 64, device=dev),
                        torch.zeros(3, 3, 64, 256, device=dev),
                        torch.zeros(256, device=dev), 0.25,
                        torch.zeros(9, 9, 64, 3, device=dev), torch.zeros(3, device=dev))


@pytest.mark.cuda
def test_generator_tail_modes_agree(dev):
    """A narrow-depth full-width generator in bf16: the composed tail
    (kernel A) and the fused tail (kernel B) agree within 2x the bf16
    envelope of the f32 network, and each launched its kernel."""
    from srgan_st_tpu_torch.kernels import launch_counts, reset_launch_counts
    from srgan_st_tpu_torch.models.generator import Generator, random_variables
    from srgan_st_tpu_torch.train.checkpoint import generator_state_dict_from_variables

    sd = generator_state_dict_from_variables(random_variables(0, num_rcb=2))
    lr = torch.from_numpy(np.random.default_rng(2).random((1, 24, 30, 3), np.float32)).to(dev)
    outs = {}
    for name, dtype, tail in (("f32", torch.float32, None),
                              ("composed", torch.bfloat16, None),
                              ("fused", torch.bfloat16, "fused")):
        g = Generator(num_rcb=2, dtype=dtype, tail_mode=tail)
        g.load_state_dict(sd)
        g.to(dev).eval()
        reset_launch_counts()
        with torch.inference_mode():
            outs[name] = g(lr)
        counts = launch_counts()
        assert counts["serving_tail" if tail else "coarse_conv_s2d"] == 1, (name, counts)
    env = _err(outs["composed"], outs["f32"])
    assert 0 < env < 0.1
    assert _err(outs["fused"], outs["composed"]) <= 2 * env


def _trunk_inputs(dev, shape, n, seed=3):
    rng = np.random.default_rng(seed)
    c = shape[-1]

    def r(*s):
        return torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(dev)

    params = [r(n, 3, 3, c, c) * 0.05, r(n, 3, 3, c, c) * 0.05, 1 + 0.1 * r(n, c),
              0.1 * r(n, c), 1 + 0.1 * r(n, c), 0.1 * r(n, c), 0.25 + 0.01 * r(n)]
    return r(*shape), params


def _trunk_run(fn, x, params):
    xg = x.clone().requires_grad_()
    pg = [p.clone().requires_grad_() for p in params]
    y, stats = fn(xg, *pg)
    (y.float() ** 2).sum().backward()
    torch.cuda.synchronize()
    return [y.detach(), stats] + [t.grad for t in (xg, *pg)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 8, 8, 64), (3, 6, 10, 128)])
def test_packed_trunk_matches_plain(dev, shape):
    """K4 forward and K5 backward through the autograd Function against the
    plain version at small shapes (one and two channel tiles), n = 2. f32:
    y and stats within 1e-4
    max|ref|, each of the 8 gradients within 1e-3 max|ref|. bf16: each
    within 2x the plain version's bf16-vs-f32 envelope."""
    from srgan_st_tpu_torch.kernels import packed_trunk as pt

    x, params = _trunk_inputs(dev, shape, 2)
    before = (pt.fwd_launches, pt.bwd_launches)
    got = _trunk_run(pt.packed_trunk, x, params)
    assert (pt.fwd_launches, pt.bwd_launches) == (before[0] + 1, before[1] + 1)
    ref = _trunk_run(pt.packed_trunk_reference, x, params)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert _err(g, r) <= (1e-4 if i < 2 else 1e-3) * float(r.abs().max()), i
    xb = x.bfloat16()
    p16 = [params[0].bfloat16().float(), params[1].bfloat16().float(), *params[2:]]
    ref32 = _trunk_run(pt.packed_trunk_reference, xb.float(), p16)
    plain16 = _trunk_run(pt.packed_trunk_reference, xb, params)
    got16 = _trunk_run(pt.packed_trunk, xb, params)
    for i, (g, p, r) in enumerate(zip(got16, plain16, ref32)):
        env = _err(p, r)
        assert 0 < env and _err(g, r) <= 2 * env, (i, _err(g, r), env)


@pytest.mark.cuda
def test_packed_trunk_on_saved_residuals_at_40960_pixels(dev):
    """At (8, 64, 80, 64), n = 2, the wgrad's split-K grows its blocks past
    256 pixels to stay at 128 of them. K4 against the plain forward, and K5
    against the plain backward on the residuals K4 saved (so that both
    take the same PReLU branches: fed their own forwards, a PReLU input
    within f32 rounding of 0 can take the other branch at one of 5 M
    elements). f32, TF32 off: within 1e-4 (forward) and 1e-3 (gradients)
    of max|ref|."""
    from srgan_st_tpu_torch.kernels import packed_trunk as pt

    x, params = _trunk_inputs(dev, (8, 64, 80, 64), 2)
    dy = torch.randn_like(x)
    bp = (params[0], params[1], params[2], params[3], params[4], params[6])
    got = pt._launch_fwd(x, *params, 1e-5)
    ref = pt._reference_forward(x, *params, 1e-5)
    gb = pt._launch_bwd(dy, *got[1:], *bp, 1e-5)
    rb = pt._reference_backward(dy, *got[1:], *bp, 1e-5)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert _err(g, r) <= 1e-4 * float(r.abs().max())
    for i, (g, r) in enumerate(zip(gb, rb)):
        assert _err(g, r) <= 1e-3 * float(r.abs().max()), i


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_trunk_is_deterministic(dev, dtype):
    """Two runs of K4 and of K5 on the same inputs give the same bits: the
    BN sums and the split-K wgrad reduce in a fixed order."""
    from srgan_st_tpu_torch.kernels import packed_trunk as pt

    x, params = _trunk_inputs(dev, (4, 16, 16, 64), 3)
    x = x.to(dtype)
    fwd = [pt._launch_fwd(x, *params, 1e-5) for _ in range(2)]
    dy = torch.randn_like(x)
    bp = (params[0], params[1], params[2], params[3], params[4], params[6])
    bwd = [pt._launch_bwd(dy, *fwd[0][1:], *bp, 1e-5) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*fwd):
        assert torch.equal(a, b)
    for a, b in zip(*bwd):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_packed_trunk_raises_outside_its_gate(dev):
    """A CUDA tensor the kernels do not take raises; it never takes the
    plain version."""
    from srgan_st_tpu_torch.kernels import packed_trunk as pt

    _, params = _trunk_inputs(dev, (1, 4, 4, 64), 1)
    with pytest.raises(ValueError, match="even"):
        pt.packed_trunk(torch.zeros(1, 4, 7, 64, device=dev), *params)
    with pytest.raises(ValueError, match="multiple of 64"):
        pt.packed_trunk(torch.zeros(1, 4, 4, 32, device=dev), *[p[..., :32, :32] if p.dim() == 5
                                                                else p[..., :32] if p.dim() == 2
                                                                else p for p in params])
    with pytest.raises(ValueError, match="bf16/f32"):
        pt.packed_trunk(torch.zeros(1, 4, 4, 64, device=dev, dtype=torch.float16), *params)
    with pytest.raises(ValueError, match="contiguous"):
        pt.packed_trunk(torch.zeros(1, 64, 4, 4, device=dev).permute(0, 2, 3, 1), *params)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n", [((2, 12, 16, 128), 2), ((3, 22, 26, 64), 2),
                                     ((2, 6, 80, 64), 2)])
def test_packed_trunk_gates_on_saved_residuals(dev, shape, n):
    """chip_smoke's K4/K5 gates at two channel tiles (C = 128), at the edge
    shape (1,716 pixels, 31.6 padded-grid tiles) and at a width that takes
    the bf16 kernels' banded window: f32 within 1e-4 (forward) and 1e-3
    (gradients) of max|ref|, K5 fed K4's residuals; bf16 within 2x the
    plain version's bf16-vs-f32 envelope; a second run of each gives the
    same bits."""
    from srgan_st_tpu_torch.kernels import packed_trunk as pt

    x, params = _trunk_inputs(dev, shape, n)
    dy = torch.randn(x.shape, device=dev, generator=torch.Generator(device=dev).manual_seed(4))
    bp = (params[0], params[1], params[2], params[3], params[4], params[6])
    got = pt._launch_fwd(x, *params, 1e-5)
    ref = pt._reference_forward(x, *params, 1e-5)
    gb = pt._launch_bwd(dy, *got[1:], *bp, 1e-5)
    rb = pt._reference_backward(dy, *got[1:], *bp, 1e-5)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert _err(g, r) <= 1e-4 * float(r.abs().max())
    for i, (g, r) in enumerate(zip(gb, rb)):
        assert _err(g, r) <= 1e-3 * float(r.abs().max()), i
    xb, dyb = x.bfloat16(), dy.bfloat16()
    p16 = [params[0].bfloat16().float(), params[1].bfloat16().float(), *params[2:]]
    bp16 = (p16[0], p16[1], p16[2], p16[3], p16[4], p16[6])
    got16 = pt._launch_fwd(xb, *params, 1e-5)
    fwd = [(got16[i], pt._reference_forward(xb, *params, 1e-5)[i],
            pt._reference_forward(xb.float(), *p16, 1e-5)[i]) for i in (0, 4)]
    res16 = got16[1:]
    res32 = [t.float() for t in res16[:3]] + [res16[3]]
    gb16 = pt._launch_bwd(dyb, *res16, *bp, 1e-5)
    bwd = zip(gb16, pt._reference_backward(dyb, *res16, *bp, 1e-5),
              pt._reference_backward(dyb.float(), *res32, *bp16, 1e-5))
    torch.cuda.synchronize()
    for i, (g, p, r) in enumerate([*fwd, *bwd]):
        env = _err(p, r)
        assert 0 < env and _err(g, r) <= 2 * env, (i, _err(g, r), env)
    for a, b in zip(got16, pt._launch_fwd(xb, *params, 1e-5)):
        assert torch.equal(a, b)
    for a, b in zip(gb16, pt._launch_bwd(dyb, *res16, *bp, 1e-5)):
        assert torch.equal(a, b)
    for a, b in zip(gb, pt._launch_bwd(dy, *got[1:], *bp, 1e-5)):
        assert torch.equal(a, b)


# chip_smoke.py's TRUNK_SHAPES: the training shape, an edge shape, two
# channel tiles
TRUNK_SHAPES = [((16, 24, 24, 64), 16), ((3, 22, 26, 64), 2), ((2, 12, 16, 128), 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n", TRUNK_SHAPES)
def test_hybrid_trunk_gates(dev, shape, n):
    """TRUNK_MODE "hybrid": the plain forward, then K5 on that forward's
    residuals, against the plain backward on the same residuals. f32 (TF32
    off): y and stats within 1e-4 max|ref|, each of the 8 gradients within
    1e-3; bf16: within 2x the plain version's bf16-vs-f32 envelope; a second
    run gives the same bits. One K5 launch and no K4 a call."""
    from srgan_st_tpu_torch.kernels import packed_trunk as pt

    x, params = _trunk_inputs(dev, shape, n, seed=7)
    before = (pt.fwd_launches, pt.bwd_launches)
    got = _trunk_run(pt.hybrid_trunk, x, params)
    assert (pt.fwd_launches, pt.bwd_launches) == (before[0], before[1] + 1)
    ref = _trunk_run(pt.packed_trunk_reference, x, params)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert _err(g, r) <= (1e-4 if i < 2 else 1e-3) * float(r.abs().max()), i
    xb = x.bfloat16()
    p16 = [params[0].bfloat16().float(), params[1].bfloat16().float(), *params[2:]]
    ref32 = _trunk_run(pt.packed_trunk_reference, xb.float(), p16)
    plain16 = _trunk_run(pt.packed_trunk_reference, xb, params)
    got16 = _trunk_run(pt.hybrid_trunk, xb, params)
    for i, (g, p, r) in enumerate(zip(got16, plain16, ref32)):
        env = _err(p, r)
        assert 0 < env and _err(g, r) <= 2 * env, (i, _err(g, r), env)
    for a, b in zip(got16, _trunk_run(pt.hybrid_trunk, xb, params)):
        assert torch.equal(a, b)
    for a, b in zip(got, _trunk_run(pt.hybrid_trunk, x, params)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n", [TRUNK_SHAPES[0], TRUNK_SHAPES[2]])
def test_hybrid_dal_gate_holds_over_seeded_draws(dev, shape, n):
    """The "hybrid" slope gradient dal over 8 seeded draws (chip_smoke.py's
    hybrid seed sweep): f32 within 1e-3 max|ref| of the plain backward on
    the plain forward's residuals; bf16, each block's error rate against
    the float64 evaluation of the same residuals (over the block's sum of
    |dh * pre|) within 2x the plain bf16 version's worst rate. The bf16
    envelope over max|dal| failed once on the card where the plain
    version's own error happened to cancel; the kernel's error against f64
    stayed within 2x the plain version's (ROADMAP.md Queue C)."""
    from srgan_st_tpu_torch.kernels import packed_trunk as pt
    from srgan_st_tpu_torch.kernels._checks import dal_gate_ratio, trunk_backward_f64

    for seed in range(8):
        gen = torch.Generator(device=dev).manual_seed(1000 + seed)
        x, params = _trunk_inputs(dev, shape, n, seed=seed)
        dy = torch.randn(x.shape, device=dev, generator=gen)
        bp = (params[0], params[1], params[2], params[3], params[4], params[6])
        for dt in (torch.float32, torch.bfloat16):
            xd, dyd = x.to(dt), dy.to(dt)
            xg = xd.clone().requires_grad_()
            pg = [t.clone().requires_grad_() for t in params]
            y, _ = pt.hybrid_trunk(xg, *pg)
            y.backward(dyd)
            res = pt._reference_forward(xd, *params, 1e-5)[1:]
            plain = pt._reference_backward(dyd, *res, *bp, 1e-5)[7]
            if dt == torch.float32:
                assert _err(pg[6].grad, plain) <= 1e-3 * float(plain.abs().max()), seed
                continue
            bp16 = (bp[0].bfloat16().float(), bp[1].bfloat16().float(), *bp[2:])
            f64 = trunk_backward_f64(dyd, *res, *bp16, 1e-5)
            assert dal_gate_ratio(pg[6].grad, plain, f64[7], f64[8]) <= 1, seed


@pytest.mark.cuda
def test_conv3_kernel_path_has_the_plain_gradients(dev):
    """The coarse conv kernel's autograd Function: a kernel-A forward whose
    gradients are not zero and equal the plain path's (f32, TF32 off;
    tolerance: accumulation order)."""
    from srgan_st_tpu_torch.kernels import coarse_conv as cc
    from srgan_st_tpu_torch.ops.subpixel_conv import conv2d_subpixel_pre_shuffled

    rng = np.random.default_rng(8)
    y0 = _rand(rng, 2, 12, 16, 256, dev=dev) + 0.5
    w0 = _rand(rng, 9, 9, 64, 3, scale=0.05, dev=dev)
    b0 = _rand(rng, 3, dev=dev)
    grads = []
    for inner in (None, 1):
        y, w, b = (t.clone().requires_grad_() for t in (y0, w0, b0))
        before = cc.launches
        out = conv2d_subpixel_pre_shuffled(y, w, b, factor=2, inner_factor=inner)
        assert cc.launches == before + (inner is None)
        (out ** 2).sum().backward()
        grads.append([t.grad for t in (y, w, b)])
    for a, b in zip(*grads):
        assert float(a.abs().max()) > 0
        assert _err(a, b) <= 1e-4 * float(b.abs().max())


@pytest.mark.cuda
def test_generator_train_step_launches_the_kernels(dev):
    """A bf16 train-mode forward and backward of a narrow-depth full-width
    generator with trunk "packed" launches K4, K5 and kernel A once each,
    and gives every parameter a finite gradient, conv3's not zero."""
    from srgan_st_tpu_torch.kernels import launch_counts, reset_launch_counts
    from srgan_st_tpu_torch.models.generator import Generator, random_variables
    from srgan_st_tpu_torch.train.checkpoint import generator_state_dict_from_variables

    g = Generator(num_rcb=2, dtype=torch.bfloat16, trunk_mode="packed")
    g.load_state_dict(generator_state_dict_from_variables(random_variables(0, num_rcb=2)))
    g.to(dev)
    lr = torch.rand(4, 24, 24, 3, device=dev)
    reset_launch_counts()
    g(lr, train=True).square().mean().backward()
    torch.cuda.synchronize()
    assert launch_counts() == {"coarse_conv_s2d": 1, "serving_tail": 0,
                               "packed_trunk_fwd": 1, "packed_trunk_bwd": 1,
                               "fused_trunk": 0, "buddy_select": 0, "eval_trunk": 0,
                               "rrdb_dense": 0, "rrdb_hr": 0, "swin_attn": 0,
                               "rrdb_trunk": 0, "swin_trunk": 0, "window_attn": 0}
    for name, p in g.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
    assert float(g.conv3.weight.grad.abs().max()) > 0


# ---------------------------------------------------------------------------
# K7: buddy selection

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dist_norm,b,n,m,d", [
    ("l2", 2, 1024, 1344, 27),   # PatchwiseST / BestBuddy at 96px GT (batch cut to 2)
    ("l2", 2, 1024, 1344, 9),    # Gram
    ("l2", 3, 97, 131, 27),      # N and M divide no tile
    ("l2", 1, 40, 70, 147),      # ksize 7
    ("l1", 2, 100, 150, 27),
])
def test_buddy_select_matches_plain(dev, dtype, dist_norm, b, n, m, d):
    """K7 against its plain version: gate (a) on every index against the
    plain version's and the f64 ground truth of the same inputs, and
    gate (c): the gathered rows are bank rows, bit for bit."""
    from srgan_st_tpu_torch.kernels import _checks
    from srgan_st_tpu_torch.kernels import buddy_select as bs

    rng = np.random.default_rng(11)
    p1, p2, bank = (_rand(rng, b, k, d, dev=dev).to(dtype) for k in (n, n, m))
    before = bs.launches
    sel, idx = bs.buddy_select(p1, p2, bank, dist_norm=dist_norm, return_index=True)
    torch.cuda.synchronize()
    assert bs.launches == before + 1
    assert idx.dtype == torch.int32 and idx.shape == (b, n)
    ref = bs.buddy_select_reference(p1, p2, bank, dist_norm=dist_norm)
    scores = _checks.f64_scores(p1, p2, bank, dist_norm=dist_norm)
    assert bool(_checks.near_tie_agrees(idx, ref, scores).all())
    assert torch.equal(sel, torch.gather(bank, 1, idx.long()[..., None].expand(-1, -1, d)))


def _duplicate_heavy(rng, b, n, m, d, dev, dtype):
    """p1, p2 and a bank on a 1/255 grid whose second half copies the
    first, drawn in the order of the JAX package's first-occurrence test."""
    def grid(*s):
        return torch.from_numpy(np.round(rng.standard_normal(s) * 32).astype(np.float32) / 255)

    p1, p2, bank = grid(b, n, d), grid(b, n, d), grid(b, m, d)
    bank[:, m // 2:] = bank[:, : m - m // 2]
    return tuple(t.to(dev, dtype) for t in (p1, p2, bank))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_buddy_select_first_occurrence(dev, dtype):
    """Gate (b) on a duplicate-heavy bank at the PatchwiseST shape, for the
    kernel and its plain version; and gate (a) between them. At this size
    exact f64 ties between distinct grid rows occur, which f32 rounding
    may split: rows with a near tie are held by gate (a) alone."""
    from srgan_st_tpu_torch.kernels import _checks
    from srgan_st_tpu_torch.kernels import buddy_select as bs

    b, n, m, d = 2, 1024, 1344, 27
    p1, p2, bank = _duplicate_heavy(np.random.default_rng(12), b, n, m, d, dev, dtype)
    idx = bs.buddy_select_index(p1, p2, bank)
    ref = bs.buddy_select_reference(p1, p2, bank)
    scores = _checks.f64_scores(p1, p2, bank)
    assert _checks.first_occurrence_holds(idx, scores, m // 2)
    assert _checks.first_occurrence_holds(ref, scores, m // 2)
    assert bool(_checks.near_tie_agrees(idx, ref, scores).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_buddy_select_first_occurrence_exact(dev, dtype):
    """The JAX package's first-occurrence test on the card: its
    construction and seed (b=2, n=40, m=70, d=27), and the kernel's
    indices equal to the f64 first-occurrence argmin exactly, never in the
    copied half, and the gathered rows bank rows bit for bit."""
    from srgan_st_tpu_torch.kernels import _checks
    from srgan_st_tpu_torch.kernels import buddy_select as bs

    b, n, m, d = 2, 40, 70, 27
    p1, p2, bank = _duplicate_heavy(np.random.default_rng(0), b, n, m, d, dev, dtype)
    sel, idx = bs.buddy_select(p1, p2, bank, return_index=True)
    want = torch.argmin(_checks.f64_scores(p1.cpu(), p2.cpu(), bank.cpu()), dim=2)
    assert torch.equal(idx.cpu().long(), want)
    assert bool((idx < m // 2).all())
    assert torch.equal(sel, torch.gather(bank, 1, idx.long()[..., None].expand(-1, -1, d)))


@pytest.mark.cuda
def test_buddy_select_raises_on_inputs_it_does_not_take(dev):
    from srgan_st_tpu_torch.kernels import buddy_select as bs

    x = torch.zeros(1, 4, 161, device=dev)
    with pytest.raises(ValueError, match="d <= 160"):
        bs.buddy_select_index(x, x, x)
    y = torch.zeros(1, 4, 9, device=dev)
    with pytest.raises(ValueError, match="one dtype"):
        bs.buddy_select_index(y, y.bfloat16(), y)


@pytest.mark.cuda
def test_registry_picks_the_kernel_on_cuda(dev, monkeypatch):
    """PatchwiseST from the registry launches K7 once per call on CUDA
    tensors unless its spec says pallas=False. The indices each call
    selects agree with the plain selection on the same features, or are an
    f64 near tie (kernels/_checks.py, the smoke's gate (a)); the noise is
    seeded."""
    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.kernels import _checks
    from srgan_st_tpu_torch.kernels import buddy_select as bs
    from srgan_st_tpu_torch.losses import functions as LF
    from srgan_st_tpu_torch.losses.registry import build_one

    calls = []

    def recorded(select):
        def fn(p1, p2, bank, *args):
            idx = select(p1, p2, bank, *args)
            calls.append((p1, p2, bank, idx))
            return idx
        return fn

    monkeypatch.setattr(LF, "buddy_select_index", recorded(bs.buddy_select_index))
    monkeypatch.setattr(LF, "buddy_select_reference", recorded(bs.buddy_select_reference))
    rng = np.random.default_rng(13)
    gt = torch.from_numpy(rng.random((2, 96, 96, 3), dtype=np.float32)).to(dev)
    noise = torch.randn(gt.shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(13))
    sr = (gt + 0.05 * noise).clamp(0, 1)
    for spec, launched in (({}, 1), ({"pallas": False}, 0)):
        before = bs.launches
        calls.clear()
        loss = build_one(Config(), "PatchwiseST", spec)(sr, gt)
        assert bs.launches == before + launched
        assert torch.isfinite(loss) and len(calls) == 1
        p1, p2, bank, idx = calls[0]
        ref = bs.buddy_select_reference(p1, p2, bank)
        scores = _checks.f64_scores(p1, p2, bank)
        assert bool(_checks.near_tie_agrees(idx, ref, scores).all())


# ---------------------------------------------------------------------------
# K6: the whole-trunk forward

@pytest.mark.cuda
@pytest.mark.parametrize("shape,n", [((2, 8, 8, 64), 2), ((3, 22, 26, 64), 2),
                                     ((2, 6, 10, 128), 3)])
def test_fused_trunk_matches_plain(dev, shape, n):
    """K6 against its plain version: y, the residuals xs, a1s, a2s and the
    stats. f32 (TF32 off): within 1e-4 max|ref|. bf16: within 2x the plain
    version's bf16-vs-f32 envelope. One launch per call."""
    from srgan_st_tpu_torch.kernels import fused_trunk as ft

    x, params = _trunk_inputs(dev, shape, n, seed=5)
    before = ft.launches
    got = ft._launch_fwd(x, *params, 1e-5)
    ref = ft.fused_trunk_reference(x, *params, 1e-5)
    torch.cuda.synchronize()
    assert ft.launches == before + 1 and ft.last_grid > 0
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert _err(g, r) <= 1e-4 * float(r.abs().max()), i
    xb = x.bfloat16()
    p16 = [params[0].bfloat16().float(), params[1].bfloat16().float(), *params[2:]]
    ref32 = ft.fused_trunk_reference(xb.float(), *p16, 1e-5)
    plain16 = ft.fused_trunk_reference(xb, *params, 1e-5)
    got16 = ft._launch_fwd(xb, *params, 1e-5)
    for i, (g, p, r) in enumerate(zip(got16, plain16, ref32)):
        env = _err(p, r)
        assert 0 < env and _err(g, r) <= 2 * env, (i, _err(g, r), env)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_trunk_is_deterministic(dev, dtype):
    """Two runs of K6 on the same inputs give the same bits."""
    from srgan_st_tpu_torch.kernels import fused_trunk as ft

    x, params = _trunk_inputs(dev, (16, 24, 24, 64), 4)
    x = x.to(dtype)
    runs = [ft._launch_fwd(x, *params, 1e-5) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n", TRUNK_SHAPES + [((2, 6, 80, 64), 2), ((1, 3, 70, 128), 3),
                                                   ((16, 24, 24, 128), 2)])
def test_fused_trunk_bf16_has_k4_bits(dev, shape, n):
    """In bf16, K6 runs K4's conv tile and sums K4's partials in K4's order:
    y, xs, a1s, a2s and the stats equal K4's bit for bit, in one launch: at
    the smoke's shapes, at widths that take the banded window, and at C =
    128 with 338 tiles a conv, more than the grid's co-resident blocks (one
    an SM at this shared memory), so that each block walks several."""
    from srgan_st_tpu_torch.kernels import fused_trunk as ft
    from srgan_st_tpu_torch.kernels import packed_trunk as pt

    x, params = _trunk_inputs(dev, shape, n, seed=8)
    xb = x.bfloat16()
    before = ft.launches
    got = ft._launch_fwd(xb, *params, 1e-5)
    want = pt._launch_fwd(xb, *params, 1e-5)
    torch.cuda.synchronize()
    assert ft.launches == before + 1
    if shape[-1] == 128 and shape[0] == 16:
        assert ft.last_grid < 338
    for name, a, b in zip(("y", "xs", "a1s", "a2s", "stats"), got, want):
        assert torch.equal(a, b), name
    # a probed launch counts 2n grid barriers in every block, same bits
    probe = torch.zeros(ft.probe_words(xb.shape, n), dtype=torch.int64, device=dev)
    probed = ft._launch_fwd(xb, *params, 1e-5, probe=probe)
    torch.cuda.synchronize()
    assert ft.probe_syncs(probe) == 2 * n
    for name, a, b in zip(("y", "xs", "a1s", "a2s", "stats"), probed, want):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,syncs", [(torch.float32, lambda n: 6 * n - 1),
                                         (torch.bfloat16, lambda n: 2 * n)])
def test_fused_trunk_probe_counts_barriers(dev, dtype, syncs):
    """The probe counts the grid barriers each block passed (f32: after
    each conv, stats and apply phase but the last; bf16: after each conv),
    and a probe of the wrong dtype, empty, or too short for the launch's
    stamps (bf16) is refused before anything runs."""
    from srgan_st_tpu_torch.kernels import fused_trunk as ft

    n = 3
    x, params = _trunk_inputs(dev, (2, 8, 8, 64), n, seed=9)
    x = x.to(dtype)
    probe = torch.zeros(ft.probe_words(x.shape, n), dtype=torch.int64, device=dev)
    ft._launch_fwd(x, *params, 1e-5, probe=probe)
    torch.cuda.synchronize()
    assert ft.probe_syncs(probe) == syncs(n)
    before = ft.launches
    for bad in (probe.int(), probe[:0]):
        with pytest.raises(ValueError):
            ft._launch_fwd(x, *params, 1e-5, probe=bad)
    if dtype == torch.bfloat16:
        with pytest.raises(RuntimeError):
            ft._launch_fwd(x, *params, 1e-5, probe=probe[:1])
    assert ft.launches == before


@pytest.mark.cuda
def test_fused_trunk_gradients_match_plain(dev):
    """Gradients through fused_trunk on CUDA (K6 forward, the torch
    backward) equal the backward on the plain forward's residuals: f32,
    within 1e-3 max|ref| for each of the 8."""
    from srgan_st_tpu_torch.kernels import fused_trunk as ft

    x, params = _trunk_inputs(dev, (4, 12, 12, 64), 2, seed=6)
    got = _trunk_run(ft.fused_trunk, x, params)
    _, xs, a1s, a2s, stats = ft.fused_trunk_reference(x, *params, 1e-5)
    y = got[0]
    bp = (params[0], params[1], params[2], params[3], params[4], params[6])
    ref = ft.fused_trunk_backward(2 * y, xs, a1s, a2s, stats, *bp, 1e-5)
    for i, (g, r) in enumerate(zip(got[2:], ref)):
        assert g.shape == r.shape
        assert _err(g, r) <= 1e-3 * float(r.abs().max()), i


@pytest.mark.cuda
def test_fused_trunk_raises_outside_its_gate(dev):
    from srgan_st_tpu_torch.kernels import fused_trunk as ft

    _, params = _trunk_inputs(dev, (1, 4, 4, 64), 1)
    with pytest.raises(ValueError, match="multiple of 64"):
        ft.fused_trunk(torch.zeros(1, 4, 4, 32, device=dev),
                       *[p[..., :32, :32] if p.dim() == 5 else p[..., :32] if p.dim() == 2
                         else p for p in params])
    with pytest.raises(ValueError, match="contiguous"):
        ft.fused_trunk(torch.zeros(1, 64, 4, 4, device=dev).permute(0, 2, 3, 1), *params)


@pytest.mark.cuda
def test_generator_fused_trunk_launches_k6(dev):
    """A bf16 train step of a narrow-depth full-width generator with trunk
    "fused" launches K6 once and kernel A once, and gives every parameter a
    finite gradient."""
    from srgan_st_tpu_torch.kernels import launch_counts, reset_launch_counts
    from srgan_st_tpu_torch.models.generator import Generator, random_variables
    from srgan_st_tpu_torch.train.checkpoint import generator_state_dict_from_variables

    g = Generator(num_rcb=2, dtype=torch.bfloat16, trunk_mode="fused")
    g.load_state_dict(generator_state_dict_from_variables(random_variables(0, num_rcb=2)))
    g.to(dev)
    reset_launch_counts()
    g(torch.rand(4, 24, 24, 3, device=dev), train=True).square().mean().backward()
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["fused_trunk"] == 1 and counts["coarse_conv_s2d"] == 1, counts
    assert counts["packed_trunk_fwd"] == 0 and counts["packed_trunk_bwd"] == 0
    for name, p in g.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


def _content_vgg_taps_and_grad(device, dtype_name, npz, sr, gt):
    """ContentVGG on the VGG19 of `npz` at `dtype_name` on `device`: (loss,
    {tap: activation of sr}, d loss / d sr)."""
    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.losses.registry import build_one, content_vgg
    from srgan_st_tpu_torch.ops.color import imagenet_normalize

    cfg = Config()
    cfg.TPU.COMPUTE_DTYPE = dtype_name
    cfg.MODEL.G_LOSS.VGG19_WEIGHTS = npz
    fn = build_one(cfg, "ContentVGG", {"kind": "content_vgg"})
    s = sr.to(device).requires_grad_()
    loss = fn(s, gt.to(device))
    (grad,) = torch.autograd.grad(loss, s)
    with torch.no_grad():
        taps = content_vgg(cfg, {}).to(device)(imagenet_normalize(sr.to(device)))
    return (float(loss.detach()), {k: v.float().cpu() for k, v in taps.items()},
            grad.float().cpu())


@pytest.mark.cuda
def test_content_vgg_bf16_within_envelope(dev, tmp_path):
    """bf16 ContentVGG on the card against f32 ContentVGG on the card, on
    the same seeded images and weights: every tap activation and the sr
    gradient within 2x the envelope the same criterion loses in bf16 on the
    CPU (bf16 - f32 there), the loss finite; the f32 taps on the card within
    1e-4 of max|ref| of the CPU's (TF32 off). The f32 gradient is held to
    the CPU's in test_content_vgg_f32_grad_within_cpu_error."""
    from chip_smoke import write_vgg_npz

    npz = write_vgg_npz(str(tmp_path / "vgg19.npz"))
    rng = np.random.default_rng(20)
    sr = torch.from_numpy(rng.random((2, 48, 48, 3), np.float32))
    gt = torch.from_numpy(rng.random((2, 48, 48, 3), np.float32))
    cpu32, cpu16 = (_content_vgg_taps_and_grad("cpu", d, npz, sr, gt)
                    for d in ("float32", "bfloat16"))
    gpu32, gpu16 = (_content_vgg_taps_and_grad(dev, d, npz, sr, gt)
                    for d in ("float32", "bfloat16"))
    assert np.isfinite(gpu16[0]) and np.isfinite(gpu32[0])
    for t in gpu32[1]:
        assert _err(gpu32[1][t], cpu32[1][t]) <= 1e-4 * float(cpu32[1][t].abs().max()), t
    pairs = [(gpu32[1][t], gpu16[1][t], cpu32[1][t], cpu16[1][t]) for t in gpu32[1]]
    pairs.append((gpu32[2], gpu16[2], cpu32[2], cpu16[2]))
    for g32, g16, c32, c16 in pairs:
        env = _err(c16, c32)
        assert 0 < env and _err(g16, g32) <= 2 * env, (_err(g16, g32), env)


def _content_vgg_grad_f64(npz, sr, gt):
    """ContentVGG's d loss / d sr in f64 on the CPU: VGG19Features at f64
    and each tap's weighted mean squared difference, as content_loss_vgg
    computes them in f32."""
    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.models.vgg import VGG19Features, load_vgg19_npz
    from srgan_st_tpu_torch.ops.color import imagenet_normalize

    layers = dict(Config().MODEL.G_LOSS.VGG19_LAYERS)
    vgg = VGG19Features(tuple(layers), dtype=torch.float64)
    vgg.load_state_dict(load_vgg19_npz(npz, tuple(layers)))
    s = sr.double().requires_grad_()
    fs, fg = vgg(imagenet_normalize(s)), vgg(imagenet_normalize(gt.double()))
    loss = sum(w * ((fs[t] - fg[t]) ** 2).mean() for t, w in layers.items())
    return torch.autograd.grad(loss, s)[0]


@pytest.mark.cuda
def test_content_vgg_f32_grad_within_cpu_error(dev, tmp_path):
    """f32 ContentVGG's sr gradient on the card (TF32 off) against the f64
    gradient on the CPU, over 5 seeded image pairs: its error within 2x the
    CPU f32 gradient's own error against the same f64 gradient. Each
    seed's readings (errors over max|f64 grad|) are printed. No fixed
    epsilon on card against CPU fits: the gradient jumps where f32 rounding
    takes a ReLU or max-pool decision the other way from f64, on either
    device, and the jump covers a receptive field (on the H100, card
    against CPU: ~2e-5 on four seeds, 7.9e-3 on seed 20, where the CPU's
    error spans ~3,000 of the 13,824 input values and the card's does
    not)."""
    from chip_smoke import write_vgg_npz

    npz = write_vgg_npz(str(tmp_path / "vgg19.npz"))
    readings = []
    for seed in range(20, 25):
        rng = np.random.default_rng(seed)
        sr = torch.from_numpy(rng.random((2, 48, 48, 3), np.float32))
        gt = torch.from_numpy(rng.random((2, 48, 48, 3), np.float32))
        g64 = _content_vgg_grad_f64(npz, sr, gt)
        cpu = _content_vgg_taps_and_grad("cpu", "float32", npz, sr, gt)[2].double()
        gpu = _content_vgg_taps_and_grad(dev, "float32", npz, sr, gt)[2].double()
        scale = float(g64.abs().max())
        e_cpu, e_gpu = (float((g - g64).abs().max()) for g in (cpu, gpu))
        readings.append({"seed": seed, "max_abs_grad": scale, "cpu_f32": e_cpu / scale,
                         "card_f32": e_gpu / scale,
                         "card_vs_cpu": float((gpu - cpu).abs().max()) / scale})
        print("content_vgg f32 grad", readings[-1])
    for r in readings:
        assert 0 < r["cpu_f32"] and r["card_f32"] <= 2 * r["cpu_f32"], readings


@pytest.mark.cuda
def test_xpack_eval_within_envelope_of_unfused(dev):
    """The eval generator with trunk_mode="xpack" (BatchNorm folded into the
    trunk's convs) on the card against the unfused eval generator: f32
    within 1e-4 (TF32 off), bf16 within 2x the unfused network's own bf16
    envelope (bf16 - f32 on the card); no trunk kernel launches."""
    from srgan_st_tpu_torch.kernels import launch_counts, reset_launch_counts
    from srgan_st_tpu_torch.models.generator import Generator, random_variables
    from srgan_st_tpu_torch.train.checkpoint import generator_state_dict_from_variables

    sd = generator_state_dict_from_variables(random_variables(0, num_rcb=4))
    lr = torch.from_numpy(np.random.default_rng(21).random((1, 64, 96, 3), np.float32)).to(dev)
    out = {}
    reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        for mode in ("unfused", "xpack"):
            g = Generator(num_rcb=4, dtype=dtype, trunk_mode=mode)
            g.load_state_dict(sd)
            with torch.inference_mode():
                out[(dtype, mode)] = g.to(dev).eval()(lr)
    counts = launch_counts()
    assert counts["packed_trunk_fwd"] == counts["fused_trunk"] == counts["eval_trunk"] == 0
    ref = out[(torch.float32, "unfused")]
    assert _err(out[(torch.float32, "xpack")], ref) <= 1e-4
    env = _err(out[(torch.bfloat16, "unfused")], ref)
    assert 0 < env and _err(out[(torch.bfloat16, "xpack")], ref) <= 2 * env


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_buddy_refine_picks_the_exact_argmin(dev, dtype):
    """On kernels/_checks.py's near-tie bank, where the f32 expansion's
    rounding orders each patch's two close bank rows, K7 (the tensor-core
    kernel for bf16, the SIMT kernel for f32) returns every patch's
    f64-best row: its refine scores the expansion's two best exactly. The
    plain version refines alike, on the card and on the CPU, and returns
    the same rows."""
    from srgan_st_tpu_torch.kernels import _checks
    from srgan_st_tpu_torch.kernels import buddy_select as bs

    p1, p2, bank, best = _checks.near_tie_bank(np.random.default_rng(7), 3, 200, dtype=dtype)
    idx = bs.buddy_select_index(p1.to(dev), p2.to(dev), bank.to(dev))
    torch.cuda.synchronize()
    assert bs.last_variant == ("mma" if dtype == torch.bfloat16 else "simt")
    assert torch.equal(idx.cpu().long(), best)
    ref = bs.buddy_select_reference(p1.to(dev), p2.to(dev), bank.to(dev))
    assert torch.equal(ref.cpu().long(), best)
    assert torch.equal(bs.buddy_select_reference(p1, p2, bank).long(), best)


# ---------------------------------------------------------------------------
# the training steps as captured CUDA graphs (train/graphs.py)

def _graph_config(trunk, channels):
    from srgan_st_tpu_torch.core.config import Config, apply_overrides

    return apply_overrides(Config(), [
        "TPU.COMPUTE_DTYPE=bfloat16", f"TPU.TRUNK_MODE={trunk}", "DATA.BATCH_SIZE=2",
        "MODEL.G_N_RCB=2", f"MODEL.G_N_CHANNEL={channels}", "MODEL.D_N_CHANNEL=4",
        "SOLVER.D_UPDATE_INTERVAL=2", "DATA.SYNTHETIC=true"])


def _graph_run(cfg, dev, batches, graphs, kind):
    """4 steps of `kind` ("warmup", or "gan": chunks of 2 with D at each
    chunk's batch 0) from the seeded state; returns every tensor the steps
    update, the batch-0 metrics and the launch counts."""
    from srgan_st_tpu_torch.kernels import launch_counts, reset_launch_counts
    from srgan_st_tpu_torch.losses.registry import build_criterions, build_warmup_criterions
    from srgan_st_tpu_torch.models.discriminator import Discriminator
    from srgan_st_tpu_torch.models.generator import Generator
    from srgan_st_tpu_torch.train.steps import (
        create_gan_state, create_generator_state, make_gan_chunk_step, make_warmup_chunk_step,
    )

    if kind == "warmup":
        state = create_generator_state(cfg, Generator.from_config(cfg), 4, dev,
                                       milestones=False)
        chunk = make_warmup_chunk_step(cfg, build_warmup_criterions(cfg), graphs=graphs)
        run = lambda b: chunk(state, b)  # noqa: E731
    else:
        state = create_gan_state(cfg, Generator.from_config(cfg),
                                 Discriminator.from_config(cfg), 4, dev)
        chunk = make_gan_chunk_step(cfg, build_criterions(cfg), graphs=graphs)
        run = lambda b: chunk(state, b, True)  # noqa: E731
    reset_launch_counts()
    metrics = [run(batches[i:i + 2])[1] for i in (0, 2)]
    torch.cuda.synchronize()
    out = {}
    for tag, model, opt in (("g", state.g_model, state.g_opt), ("d", state.d_model, state.d_opt)):
        if model is not None:
            out.update({f"{tag}/{k}": v.clone() for k, v in model.state_dict().items()})
            for i, st in enumerate(opt.opt.state.values()):
                out.update({f"{tag}/adam{i}/{k}": v.clone() for k, v in st.items()})
    for i, m in enumerate(metrics):
        out.update({f"metric{i}/{k}": v for k, v in m.items()})
    return out, launch_counts(), state


@pytest.mark.cuda
@pytest.mark.parametrize("trunk,channels", [("packed", 64), ("unfused", 16)])
@pytest.mark.parametrize("kind", ["warmup", "gan"])
def test_graph_steps_equal_eager_steps(dev, trunk, channels, kind):
    """Warmup, G and G + D steps replayed from their graphs give the eager
    steps' parameters, running statistics, Adam moments and metrics bit for
    bit (cuDNN on deterministic algorithms), with the same launch counts:
    of 4 steps, the first of each kind runs eagerly, then it is captured
    and replayed."""
    from srgan_st_tpu_torch.kernels import graph_launch_counts
    from srgan_st_tpu_torch.train.graphs import StepGraphs

    torch.backends.cudnn.deterministic = True
    try:
        cfg = _graph_config(trunk, channels)
        rng = np.random.default_rng(5)
        batches = [torch.from_numpy(rng.integers(0, 256, (2, 96, 96, 3), dtype=np.uint8)).to(dev)
                   for _ in range(4)]
        eager, e_counts, _ = _graph_run(cfg, dev, batches, None, kind)
        graphs = StepGraphs(dev)
        graph, g_counts, _ = _graph_run(cfg, dev, batches, graphs, kind)
        replayed = graph_launch_counts()
    finally:
        torch.backends.cudnn.deterministic = False
    assert eager.keys() == graph.keys()
    differ = [k for k in eager if not torch.equal(eager[k], graph[k])]
    assert not differ, differ[:5]
    assert g_counts == e_counts
    per_step = {k: n // 4 for k, n in e_counts.items()}
    replays = 3 if kind == "warmup" else 2  # warmup: 1 eager + 3; gan: "gan" and "g" 1 + 1
    assert replayed == {k: n * replays for k, n in per_step.items()}
    assert e_counts["coarse_conv_s2d"] == 4
    if trunk == "packed":
        assert e_counts["packed_trunk_fwd"] == e_counts["packed_trunk_bwd"] == 4
    assert set(graphs.capture_seconds()) == ({"warmup"} if kind == "warmup" else {"gan", "g"})


@pytest.mark.cuda
def test_layout_cache_follows_graph_replays(dev):
    """Kernel A's weight layout, cached by an eval forward, is made again
    after graph replays moved the weights (a replay bumps no `_version`):
    the eval after replays equals a fresh model's on the same weights."""
    from srgan_st_tpu_torch.models.generator import Generator
    from srgan_st_tpu_torch.train.graphs import StepGraphs

    cfg = _graph_config("packed", 64)
    rng = np.random.default_rng(6)
    batches = [torch.from_numpy(rng.integers(0, 256, (2, 96, 96, 3), dtype=np.uint8)).to(dev)
               for _ in range(4)]
    x = torch.from_numpy(rng.random((1, 16, 16, 3), np.float32)).to(dev)
    graphs = StepGraphs(dev)
    _, _, state = _graph_run(cfg, dev, batches, graphs, "gan")
    with torch.no_grad():
        before = state.g_model(x)  # caches the layout
    # two replays of the captured G step (its batch and its empty draws)
    # move the weights in place
    for _ in range(2):
        graphs.run("g", state, None, batches[2], {})
    torch.cuda.synchronize()
    fresh = Generator.from_config(cfg).to(dev)
    fresh.load_state_dict(state.g_model.state_dict())
    with torch.no_grad():
        after, want = state.g_model(x), fresh(x)
    assert not torch.equal(before, after)
    assert torch.equal(after, want)


@pytest.mark.cuda
def test_capture_survives_an_earlier_graph_collected(dev):
    """The graphs of an earlier run (warmup()'s, when train() captures) sit
    in reference cycles (a StepGraphs and its steps hold each other). Here
    they are young garbage just as a new capture starts, and the cyclic
    collector is due at the next allocation: a collection inside the
    capture would destroy their executables there and invalidate it. The
    capture collects first and holds the collector off, so it succeeds and
    replays."""
    import gc

    from srgan_st_tpu_torch.train.graphs import StepGraphs

    x = torch.ones(64, device=dev)
    thresholds = gc.get_threshold()
    gc.set_threshold(0)  # no automatic collection: what is made stays young
    try:
        old = StepGraphs(dev)
        old.run("k", old, lambda t: [t * 2], x)
        assert old.launches_per_replay().keys() == {"k"}
        holder, calls = {"old": old}, []
        del old

        def fn(t):
            calls.append(len(calls))
            if len(calls) == 2:  # the capture: the earlier graphs become garbage
                holder.clear()
                gc.set_threshold(1)
            return [t + i for i in range(300)]

        new = StepGraphs(dev)
        new.run("k", new, fn, x)
        out = new.run("k", new, None, x + 1)
    finally:
        gc.set_threshold(*thresholds)
    torch.cuda.synchronize()
    assert calls == [0, 1] and not holder
    assert torch.equal(out[299], x + 300)


@pytest.mark.cuda
def test_dcp_restore_keeps_the_graphs_storage(dev, tmp_path):
    """EXP.ORBAX_CHECKPOINTS on the card: a GAN state whose steps were
    captured and replayed is saved as a DCP directory after one more
    replay of the G step; a further replay moves it, and restore_latest
    writes the saved values back into the same storage (the data_ptr of
    every parameter, buffer, Adam moment and count unchanged), bit for bit;
    the next replay then repeats the replay that followed the save, bit
    for bit (cuDNN on deterministic algorithms). Then what a resumed run
    does: the checkpoint restored into a fresh state, whose capturable Adam
    has no state yet (the restore makes it, in place), and G steps on it
    through a new set of graphs (the first captures, the second replays)
    equal, bit for bit, the same steps replayed on the saved state."""
    from srgan_st_tpu_torch.losses.registry import build_criterions
    from srgan_st_tpu_torch.models.discriminator import Discriminator
    from srgan_st_tpu_torch.models.generator import Generator
    from srgan_st_tpu_torch.train.checkpoint import (
        CheckpointPolicy, _dcp_tree, _flat, train_state_arrays,
    )
    from srgan_st_tpu_torch.train.graphs import StepGraphs
    from srgan_st_tpu_torch.train.steps import create_gan_state, make_gan_chunk_step

    def ptrs(state):
        return [t.data_ptr() for t in _flat(_dcp_tree(state)[0]).values()
                if t.device.type == "cuda"]

    def same(a, b):
        return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)

    torch.backends.cudnn.deterministic = True
    try:
        cfg = _graph_config("packed", 64)
        rng = np.random.default_rng(7)
        batches = [torch.from_numpy(rng.integers(0, 256, (2, 96, 96, 3), dtype=np.uint8)).to(dev)
                   for _ in range(5)]
        graphs = StepGraphs(dev)
        _, _, state = _graph_run(cfg, dev, batches, graphs, "gan")
        graphs.run("g", state, None, batches[4], {})
        torch.cuda.synchronize()
        policy = CheckpointPolicy(str(tmp_path), use_orbax=True)
        policy.save_epoch(state, 0, 1.0, 1.0)
        saved, before = train_state_arrays(state), ptrs(state)
        assert before and saved["g_opt.count"] == 5
        graphs.run("g", state, None, batches[0], {})
        torch.cuda.synchronize()
        after_save = train_state_arrays(state)
        assert not same(after_save, saved)
        assert policy.restore_latest(state)
        assert ptrs(state) == before
        assert same(train_state_arrays(state), saved)
        graphs.run("g", state, None, batches[0], {})
        torch.cuda.synchronize()
        assert same(train_state_arrays(state), after_save)

        # resume into a fresh state, then capture: G steps without D
        assert policy.restore_latest(state)
        crit = build_criterions(cfg)
        fresh = create_gan_state(cfg, Generator.from_config(cfg), Discriminator.from_config(cfg),
                                 4, dev, generator=torch.Generator().manual_seed(99))
        assert not fresh.g_opt.opt.state and fresh.g_opt._capturable
        model_ptrs = [t.data_ptr() for m in (fresh.g_model, fresh.d_model)
                      for t in m.state_dict().values()]
        assert policy.restore_latest(fresh)
        assert [t.data_ptr() for m in (fresh.g_model, fresh.d_model)
                for t in m.state_dict().values()] == model_ptrs
        assert same(train_state_arrays(fresh), saved)
        assert all(st["step"].is_cuda for st in fresh.g_opt.opt.state.values())
        resumed = StepGraphs(dev)
        steps = {id(state): make_gan_chunk_step(cfg, crit, graphs=graphs),
                 id(fresh): make_gan_chunk_step(cfg, crit, graphs=resumed)}
        for b in (batches[1], batches[2]):
            got = [train_state_arrays(steps[id(s)](s, [b], False)[0]) for s in (state, fresh)]
            torch.cuda.synchronize()
            differ = [k for k in got[0] if not np.array_equal(got[0][k], got[1][k])]
            assert not differ, differ[:5]
        assert resumed.launches_per_replay().keys() == {"g"}
    finally:
        torch.backends.cudnn.deterministic = False


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["warmup", "gan"])
def test_replayed_ops_take_the_regions_that_captured_them(dev, kind):
    """One traced chunk of 3 batches after a chunk that captured the step
    graphs: each replay's device ops match its graph's kernel, copy and
    memset nodes in count; 99% of busy time is labelled; every K5 wgrad
    tile is under `g.backward`; the ops under the K4/K5 launch spans are
    the kernels `trunk_roofline.train` matches by name (and the library's
    copy and memset), and the reverse; the foreach Adam kernels are under
    `optim.*`."""
    import os
    import sys

    from torch.profiler import ProfilerActivity, profile

    from srgan_st_tpu_torch.losses.registry import build_criterions, build_warmup_criterions
    from srgan_st_tpu_torch.models.discriminator import Discriminator
    from srgan_st_tpu_torch.models.generator import Generator
    from srgan_st_tpu_torch.train.graphs import StepGraphs
    from srgan_st_tpu_torch.tools import profile_step as T
    from srgan_st_tpu_torch.train.steps import (
        create_gan_state, create_generator_state, make_gan_chunk_step, make_warmup_chunk_step,
    )
    from srgan_st_tpu_torch.utils import profiling as P

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmark import harness

    trunk_names = harness.readers()["trunk_roofline.train"].NAMES
    cfg = _graph_config("packed", 64)
    rng = np.random.default_rng(8)
    chunk = [torch.from_numpy(rng.integers(0, 256, (2, 96, 96, 3), dtype=np.uint8)).to(dev)
             for _ in range(3)]
    graphs = StepGraphs(dev)
    if kind == "warmup":
        state = create_generator_state(cfg, Generator.from_config(cfg), 4, dev,
                                       milestones=False)
        step = make_warmup_chunk_step(cfg, build_warmup_criterions(cfg), graphs=graphs)
        run = lambda: step(state, chunk)  # noqa: E731
    else:
        state = create_gan_state(cfg, Generator.from_config(cfg),
                                 Discriminator.from_config(cfg), 4, dev)
        step = make_gan_chunk_step(cfg, build_criterions(cfg), graphs=graphs)
        run = lambda: step(state, chunk, True)  # noqa: E731
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ops, calls, spans = T.trace_events(prof)
    rec = T.program_trace(ops, calls, spans, graphs.node_regions())
    assert P._stack == [] and P._capture is None
    if kind == "warmup":
        assert graphs.graph_counts() == {"warmup": {"captures": 1, "replays": 5}}
    else:
        assert graphs.graph_counts() == {"gan": {"captures": 1, "replays": 1},
                                         "g": {"captures": 1, "replays": 3}}
    assert [r["kind"] for r in rec["replays"]] == (
        ["warmup"] * 3 if kind == "warmup" else ["gan", "g", "g"])
    assert all(r["ops"] == r["nodes"] for r in rec["replays"]), rec["replays"]
    assert rec["labelled_share"] >= 0.99
    ops = sorted(ops)
    parts = [set(lab.split("/")) if lab else set() for lab in rec["labels"]]
    wgrad = [p for op, p in zip(ops, parts) if "trunk_wgrad_wgmma" in op[2]]
    assert wgrad and all("g.backward" in p for p in wgrad)
    under = {i for i, p in enumerate(parts)
             if p & {"kernel.packed_trunk_fwd", "kernel.packed_trunk_bwd"}}
    named = {i for i, op in enumerate(ops) if trunk_names.match(op[2])}
    # the library's x copy and ticket memset (a graph may run the copy as
    # the driver's kernel `memcpy32_post`)
    copies = {i for i in under if ops[i][2].startswith(("Memcpy", "Memset", "memcpy"))}
    assert named and under - copies == named
    adam = [p for op, p in zip(ops, parts) if "multi_tensor_apply_kernel" in op[2]]
    assert adam and all(any(n.startswith("optim.") for n in p) for p in adam)


def _eval_trunk_operands(dev, n, seed=5):
    """Random eval trunk operands of n blocks at 64 channels: HWIO kernels
    N(0, 1/fan_in), BatchNorms with non-trivial running statistics as their
    f32 affine, slopes in [0.1, 0.3]."""
    from srgan_st_tpu_torch.kernels.eval_trunk import affine

    rng = np.random.default_rng(seed)
    m = 2 * n + 1
    ws = torch.from_numpy(rng.standard_normal((m, 3, 3, 64, 64), np.float32) / 24.0)
    gam = torch.from_numpy(rng.uniform(0.5, 1.0, (m, 64)).astype(np.float32))
    bet = torch.from_numpy(0.1 * rng.standard_normal((m, 64), np.float32))
    mean = torch.from_numpy(0.1 * rng.standard_normal((m, 64), np.float32))
    var = torch.from_numpy(rng.uniform(0.5, 1.5, (m, 64)).astype(np.float32))
    scale, shift = affine(gam, bet, mean, var, 1e-5)
    als = torch.from_numpy(rng.uniform(0.1, 0.3, n).astype(np.float32))
    return [t.to(dev) for t in (ws, scale, shift, als)], (gam, bet, mean, var)


def _eval_blocks_f32(x, ws, gam, bet, mean, var, als, eps=1e-5):
    """The g.trunk region as the f32 eval blocks compute it (TF32 off):
    conv, (a - m) rsqrt(v + eps) w + b, PReLU, conv, BN, + x; the fusion
    conv, BN, + the stem output. NHWC f32."""
    import torch.nn.functional as F

    def conv(h, i):
        a = F.conv2d(h.permute(0, 3, 1, 2), ws[i].permute(3, 2, 0, 1).float(), padding=1)
        a = a.permute(0, 2, 3, 1)
        return (a - mean[i]) * torch.rsqrt(var[i] + eps) * gam[i] + bet[i]

    x0 = h = x.float()
    for j in range(als.shape[0]):
        a = conv(h, 2 * j)
        h = h + conv(torch.where(a >= 0, a, als[j] * a), 2 * j + 1)
    return conv(h, 2 * als.shape[0]) + x0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 540, 960, 64), (2, 96, 96, 64), (1, 37, 53, 64)])
def test_eval_trunk_matches_plain(dev, shape):
    """Kernel E (16 blocks and the fusion conv) against its plain version
    on the same bf16 operands, and against the f32 eval blocks within 2x
    the blocks' own bf16 envelope; one call counted; a second call gives
    the same bits. (1, 37, 53) is odd and narrower than one 64-pixel row
    tile; (2, 96, 96) ends each row in a partial tile."""
    from srgan_st_tpu_torch.kernels import eval_trunk as et
    from srgan_st_tpu_torch.kernels.packed_trunk import _conv

    (ws, scale, shift, als), stats = _eval_trunk_operands(dev, 16)
    x = (torch.rand(shape, generator=torch.Generator(device=dev).manual_seed(7), device=dev)
         - 0.5).bfloat16()
    before = et.launches
    got = et.eval_trunk(x, ws, scale, shift, als)
    torch.cuda.synchronize()
    assert et.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, et.eval_trunk(x, ws, scale, shift, als))
    ref = et.eval_trunk_reference(x, ws, scale, shift, als)
    gam, bet, mean, var = (t.to(dev) for t in stats)
    ref32 = _eval_blocks_f32(x, ws, gam, bet, mean, var, als)
    # the blocks in bf16: each step rounded, as models/common.py computes them
    cdt, h = torch.bfloat16, x
    for j in range(16):
        a = _conv(h, ws[2 * j].bfloat16()).bfloat16()
        a = (a - mean[2 * j].to(cdt)) * torch.rsqrt(var[2 * j].to(cdt) + 1e-5) \
            * gam[2 * j].to(cdt) + bet[2 * j].to(cdt)
        a = torch.where(a >= 0, a, als[j].to(cdt) * a)
        b = _conv(a, ws[2 * j + 1].bfloat16()).bfloat16()
        h = h + ((b - mean[2 * j + 1].to(cdt)) * torch.rsqrt(var[2 * j + 1].to(cdt) + 1e-5)
                 * gam[2 * j + 1].to(cdt) + bet[2 * j + 1].to(cdt))
    b = _conv(h, ws[32].bfloat16()).bfloat16()
    blocks16 = x + ((b - mean[32].to(cdt)) * torch.rsqrt(var[32].to(cdt) + 1e-5)
                    * gam[32].to(cdt) + bet[32].to(cdt))
    env = _err(blocks16, ref32)
    err_ref, err32 = _err(got, ref), _err(got, ref32)
    print(f"eval_trunk {shape}: |kernel - plain| {err_ref}, |kernel - f32| {err32}, "
          f"|plain - f32| {_err(ref, ref32)}, envelope {env}")
    # the kernel and its plain version differ by their f32 sums' order: a
    # rounding flipped here and there, carried through the blocks, within
    # what the blocks' own roundings move
    assert 0 < env and err32 <= 2 * env
    assert err_ref <= env


@pytest.mark.cuda
def test_eval_trunk_raises_outside_its_gate(dev):
    from srgan_st_tpu_torch.kernels import eval_trunk as et

    (ws, scale, shift, als), _ = _eval_trunk_operands(dev, 1)
    for x in (torch.zeros(1, 8, 8, 64, device=dev),                       # f32
              torch.zeros(1, 8, 8, 32, device=dev, dtype=torch.bfloat16)):  # C = 32
        with pytest.raises(ValueError, match="eval_trunk"):
            et.eval_trunk(x, ws, scale, shift, als)


@pytest.mark.cuda
def test_serving_frame_takes_kernel_e_under_g_trunk(dev):
    """make_generator_apply on a 4K frame (960x540 in, batch 1, bf16, the
    default config) runs the g.trunk region as kernel E: one call a frame,
    33 kernel-E convs under `g.trunk` and none elsewhere, no eager
    BatchNorm or PReLU op under it; the output within 2x the bf16 network's
    envelope of the f32 network."""
    from torch.profiler import ProfilerActivity, profile

    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.eval.validate import make_generator_apply
    from srgan_st_tpu_torch.kernels import launch_counts, reset_launch_counts
    from srgan_st_tpu_torch.models.generator import random_variables
    from srgan_st_tpu_torch.tools import profile_step as T

    variables = random_variables(0)
    fns = {}
    for dtype in ("bfloat16", "float32"):
        cfg = Config()
        cfg.TPU.COMPUTE_DTYPE = dtype
        fns[dtype] = make_generator_apply(cfg, variables, dev)
    x = torch.rand(1, 540, 960, 3, generator=torch.Generator(device=dev).manual_seed(3),
                   device=dev)
    fns["bfloat16"](x)
    torch.cuda.synchronize()
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out16 = fns["bfloat16"](x)
        torch.cuda.synchronize()
    assert launch_counts()["eval_trunk"] == 1
    ops, calls, spans = T.trace_events(prof)
    rec = T.program_trace(ops, calls, spans)
    labels = [set(lab.split("/")) if lab else set() for lab in rec["labels"]]
    ops = sorted(ops)
    kernel_e = [p for op, p in zip(ops, labels) if "eval_trunk_conv" in op[2]]
    assert len(kernel_e) == 33 and all("g.trunk" in p and "kernel.eval_trunk" in p
                                       for p in kernel_e)
    trunk_ops = [op[2] for op, p in zip(ops, labels) if "g.trunk" in p]
    assert all("eval_trunk_conv" in name for name in trunk_ops), sorted(set(trunk_ops))
    out32 = fns["float32"](x)
    ref16 = make_generator_apply(_config_unfused(), variables, dev)(x)
    env = _err(ref16, out32)
    assert 0 < env and _err(out16, out32) <= 2 * env, (_err(out16, out32), env)


def _config_unfused():
    from srgan_st_tpu_torch.core.config import Config

    cfg = Config()
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    cfg.TPU.TRUNK_MODE = "unfused"
    return cfg


# ---------------------------------------------------------------------------
# The RRDB generator (Real-ESRGAN x4plus) on the serving path

@pytest.mark.cuda
def test_rrdb_frame_at_540p_matches_the_reference_and_launches_kernels_r_and_h(dev):
    """A 960 x 540 frame of the published configuration through
    make_generator_apply (bf16) against benchmark/reference/rrdb.py (f32,
    TF32 off) within the cell's limits. Of the port's kernels only kernel R
    (once, as many times as the trunk is counted) and kernel H (twice)
    launch; `g.trunk` holds R's 345 convs (23 x 3 x 5) under
    `kernel.rrdb_dense` and conv_body's cuDNN conv, and no conv of the HR
    stage; no `torch.cat` copy or LeakyReLU runs under it; it takes at
    least 0.65 of the four regions' device time (75% measured at 540p on an
    H100). `g.upsample` and `g.tail` each hold one kernel H call under
    `kernel.rrdb_hr` (two convs each, nearest x2 folded into the up convs'
    reads) and nothing else: no nearest copy, cuDNN conv or LeakyReLU."""
    import os
    import sys

    from torch.profiler import ProfilerActivity, profile

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmark import compare, harness, seeded, seeded_rrdb
    from benchmark.drivers.serve_rrdb import program_config
    from benchmark.reference.rrdb import upscale
    from srgan_st_tpu_torch.eval.validate import make_generator_apply
    from srgan_st_tpu_torch.kernels import launch_counts, reset_launch_counts
    from srgan_st_tpu_torch.models.rrdb import RRDBNet
    from srgan_st_tpu_torch.tools import profile_step as T

    cfg = harness.load_json("configs", "realesrgan_x4plus.json")
    limits = harness.load_json("workloads", "realesrgan_x4plus.video_4k.json")["limits"]
    gen = seeded.generator_for(2**31 + 99, dev)
    sd = seeded_rrdb.state(cfg, gen, dev)
    fn = make_generator_apply(program_config(cfg), sd, dev)
    assert isinstance(fn.model, RRDBNet) and fn.model.dtype == torch.bfloat16
    x = torch.rand(1, 540, 960, 3, generator=gen, device=dev)
    fn(x)
    torch.cuda.synchronize()
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sr = fn(x)
        torch.cuda.synchronize()
    counts = launch_counts()
    assert counts.pop("rrdb_trunk") == counts.pop("rrdb_dense") == 1
    assert counts.pop("rrdb_hr") == 2
    assert set(counts.values()) == {0}, counts
    ops, calls, spans = T.trace_events(prof)
    rec = T.program_trace(ops, calls, spans)
    ops = sorted(ops)
    labels = [set(lab.split("/")) if lab else set() for lab in rec["labels"]]
    kernel_r = [p for op, p in zip(ops, labels) if "rrdb_dense_conv" in op[2]]
    assert len(kernel_r) == 345 and all("g.trunk" in p and "kernel.rrdb_dense" in p
                                        for p in kernel_r)
    convs = [p for op, p in zip(ops, labels) if "fprop" in op[2] or "conv" in op[2].lower()]
    in_trunk = [p for p in convs if "g.trunk" in p]
    assert len(in_trunk) >= 346 and not any("g.upsample" in p or "g.tail" in p
                                            for p in in_trunk)
    trunk_ops = [op[2] for op, p in zip(ops, labels) if "g.trunk" in p]
    assert not any("CatArray" in n or "leaky" in n.lower() for n in trunk_ops), \
        sorted(set(trunk_ops))
    assert rec["regions"]["g.trunk"] >= 0.65 * sum(rec["regions"][r] for r in (
        "g.stem", "g.trunk", "g.upsample", "g.tail"))
    for region in ("g.upsample", "g.tail"):
        here = [op[2] for op, p in zip(ops, labels) if region in p]
        convs_h = [op[2] for op, p in zip(ops, labels)
                   if region in p and "kernel.rrdb_hr" in p and "rrdb_hr_conv" in op[2]]
        assert len(convs_h) == 2 and all("rrdb_hr" in n for n in here), (region, here)
    ref = upscale(sd, x)
    rms, big = compare.frame_gaps(sr, ref)
    assert sr.shape == (1, 2160, 3840, 3)
    assert rms <= limits["frame_rms_gap"] and big <= limits["frame_max_gap"], (rms, big)
    print(f"rrdb 540p frame: rms {rms}, max {big}")


def _rrdb_operands(dev, n, seed=11):
    """chip_smoke's random operands of n RRDBs at the published widths,
    from a seeded generator on `dev`."""
    from chip_smoke import rrdb_operands

    return rrdb_operands(torch.Generator(device=dev).manual_seed(seed), dev, n)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,n", [((1, 37, 53, 64), 2), ((2, 64, 96, 64), 2),
                                     ((1, 540, 960, 64), 1)])
def test_rrdb_dense_matches_plain(dev, shape, n):
    """Kernel R against its plain version on the same bf16 operands, and
    against the plain version in f32 within 2x the plain version's own
    bf16 envelope; one call counted; a second call gives the same bits.
    (1, 37, 53) is odd and narrower than one 64-pixel tile, with a ragged
    last row group; (2, 64, 96) ends each row in a partial tile; (1, 540,
    960) is the video cell's frame, 540 rows a ragged last row group."""
    from srgan_st_tpu_torch.kernels import rrdb_dense as R

    ws, bs = _rrdb_operands(dev, n)
    x = (torch.rand(shape, generator=torch.Generator(device=dev).manual_seed(7), device=dev)
         - 0.5).bfloat16()
    before = R.launches
    got = R.rrdb_dense(x, ws, bs, 0.2, 0.2)
    torch.cuda.synchronize()
    assert R.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got, R.rrdb_dense(x, ws, bs, 0.2, 0.2))
    plain16 = R.rrdb_dense_reference(x, ws, bs, 0.2, 0.2)
    ref32 = R.rrdb_dense_reference(x.float(), [w.bfloat16().float() for w in ws], bs, 0.2, 0.2)
    env, err32, err16 = _err(plain16, ref32), _err(got, ref32), _err(got, plain16)
    print(f"rrdb_dense {shape} n={n}: |kernel - plain| {err16}, |kernel - f32| {err32}, "
          f"envelope {env}, max|ref| {float(ref32.abs().max())}")
    # the kernel and its plain version differ by their f32 sums' order: a
    # rounding flipped here and there, carried through the convs as far as
    # the roundings themselves carry (measured: up to ~1.4x the envelope)
    assert 0 < env and err32 <= 2 * env
    assert err16 <= 2 * env
    # a residual scale of a quarter is far outside the gate
    assert _err(got, R.rrdb_dense_reference(x, ws, bs, 0.2, 0.25)) > 4 * env


@pytest.mark.cuda
def test_rrdb_dense_raises_outside_its_gate(dev):
    from srgan_st_tpu_torch.kernels import rrdb_dense as R

    ws, bs = _rrdb_operands(dev, 1)
    for x in (torch.zeros(1, 8, 8, 64, device=dev),                       # f32
              torch.zeros(1, 8, 8, 32, device=dev, dtype=torch.bfloat16)):  # nf = 32
        with pytest.raises(ValueError, match="rrdb_dense"):
            R.rrdb_dense(x, ws, bs, 0.2, 0.2)
    x = torch.zeros(1, 8, 8, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="rrdb_dense"):
        R.rrdb_dense(x, ws[:10], bs[:10], 0.2, 0.2)  # not whole RRDBs


def _small_rrdb(dev, dtype, n=2):
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmark import harness, seeded, seeded_rrdb
    from srgan_st_tpu_torch.models.rrdb import RRDBNet

    cfg = dict(harness.load_json("configs", "realesrgan_x4plus.json"), num_block=n)
    m = RRDBNet(num_block=n, dtype=dtype)
    m.load_state_dict(seeded_rrdb.state(cfg, seeded.generator_for(2**31 + 5, "cpu"), "cpu"))
    return m.to(dev).eval()


@pytest.mark.cuda
def test_rrdbnet_forward_with_and_without_kernel_r(dev, monkeypatch):
    """The whole RRDBNet forward (2 RRDBs, published widths, bf16) with
    kernel R and with the torch blocks (the gate forced off): both within
    2x the torch blocks' bf16 envelope of the f32 network, kernel R
    counted once and only on its path."""
    from srgan_st_tpu_torch.kernels import launch_counts, reset_launch_counts
    from srgan_st_tpu_torch.kernels import rrdb_dense as R

    lr = torch.rand(1, 72, 100, 3, generator=torch.Generator(device=dev).manual_seed(4),
                    device=dev)
    m16, m32 = _small_rrdb(dev, torch.bfloat16), _small_rrdb(dev, torch.float32)
    with torch.inference_mode():
        ref = m32(lr)
        reset_launch_counts()
        kern = m16(lr)
        assert launch_counts()["rrdb_dense"] == launch_counts()["rrdb_trunk"] == 1
        assert launch_counts()["rrdb_hr"] == 2
        monkeypatch.setattr(R, "gate", lambda *a: False)
        reset_launch_counts()
        blocks = m16(lr)
        assert launch_counts()["rrdb_dense"] == 0 and launch_counts()["rrdb_trunk"] == 1
        assert launch_counts()["rrdb_hr"] == 2
    env = _err(blocks, ref)
    print(f"rrdbnet: |kernel - f32| {_err(kern, ref)}, |blocks - f32| {env}")
    assert 0 < env and _err(kern, ref) <= 2 * env


@pytest.mark.cuda
def test_rrdb_tiled_eval_equals_the_whole_frame_with_kernel_r(dev):
    """Tiled eval at the exact halo (15 n + 4) through kernel R, ragged
    edge tiles in batches of 4, within the bf16 envelope of the whole
    frame through kernel R; kernel R ran once a batch and once for the
    whole frame."""
    from srgan_st_tpu_torch.eval.tiled import TiledApplier, generator_halo
    from srgan_st_tpu_torch.kernels import launch_counts, reset_launch_counts

    m16, m32 = _small_rrdb(dev, torch.bfloat16), _small_rrdb(dev, torch.float32)

    def fn(x):
        with torch.inference_mode():
            return m16(torch.as_tensor(x, device=dev)).cpu()

    halo = generator_halo(2, 4, "rrdb")
    lr = torch.rand(1, 130, 150, 3, generator=torch.Generator().manual_seed(6))
    reset_launch_counts()
    whole = fn(lr).numpy()
    tiled = TiledApplier(fn, upscale=4, tile=32, halo=halo, tile_batch=4)(lr)
    counts = launch_counts()
    assert counts["rrdb_dense"] == counts["rrdb_trunk"] == 1 + 7  # 25 tiles, 4 a batch
    assert counts["rrdb_hr"] == 2 * (1 + 7)
    with torch.inference_mode():
        env = _err(torch.from_numpy(whole), m32(lr.to(dev)).cpu())
    gap = float(np.abs(tiled - whole).max())
    print(f"rrdb tiled: |tiled - whole| {gap}, envelope {env}")
    assert tiled.shape == whole.shape and gap <= env


def _hr_operands(dev, seed=13):
    """chip_smoke's random operands of the HR stage at the published
    widths, from a seeded generator on `dev`."""
    from chip_smoke import hr_operands

    return hr_operands(torch.Generator(device=dev).manual_seed(seed), dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 540, 960, 64), (3, 37, 53, 64), (2, 17, 131, 64)])
def test_rrdb_hr_matches_plain(dev, shape):
    """Kernel H against its plain version on the same bf16 operands: the
    upsample call's u2 (read back from its planes) and the frame, each
    within 2x the plain version's own bf16 envelope of the plain version in
    f32, the frame's zero border intact; two calls counted; a second pair
    of calls gives the same bits. (1, 540, 960) is the video cell's frame;
    (3, 37, 53) is a batch of odd tiles narrower than one 64-pixel tile,
    with ragged last row groups; (2, 17, 131) ends each row in a partial
    tile."""
    from srgan_st_tpu_torch.kernels import rrdb_hr as H

    ws, bs = _hr_operands(dev)
    laid = H.layout(ws, bs)
    x = (torch.rand(shape, generator=torch.Generator(device=dev).manual_seed(7), device=dev)
         - 0.5).bfloat16()
    before = H.launches
    up = H.rrdb_hr_upsample(x, ws, bs, 0.2, laid)
    got = H.rrdb_hr_tail(up, ws, bs, 0.2, laid)
    torch.cuda.synchronize()
    assert H.launches == before + 2
    b, h, w, _ = shape
    assert got.dtype == torch.float32 and got.shape == (b, 4 * h, 4 * w, 3)
    assert torch.isfinite(got).all() and float(got.min()) >= 0 and float(got.max()) <= 1
    again = H.rrdb_hr_tail(H.rrdb_hr_upsample(x, ws, bs, 0.2), ws, bs, 0.2)
    assert torch.equal(got, again)
    # the zero border: rows -1 and 4h, x = -1 at index 1 and x = 4w at 4w + 2
    # (the stored rows' unused pixels, indices 0 and 4w + 3, are not written)
    planes = up.grid()[:, :, :, 1:4 * w + 3]
    assert not planes[:, :, 0].any() and not planes[:, :, -1].any()
    assert not planes[:, :, :, 0].any() and not planes[:, :, :, -1].any()
    u16 = H.upsample_reference(x, ws, bs, 0.2)
    u32 = H.upsample_reference(x.float(), ws, bs, 0.2)
    u_env, u_err = _err(u16, u32), _err(up.nhwc(), u32)
    plain16 = H.rrdb_hr_reference(x, ws, bs, 0.2)
    ref32 = H.rrdb_hr_reference(x.float(), ws, bs, 0.2)
    env, err32, err16 = _err(plain16, ref32), _err(got, ref32), _err(got, plain16)
    print(f"rrdb_hr {shape}: u2 |kernel - f32| {u_err}, envelope {u_env}; frame |kernel - "
          f"plain| {err16}, |kernel - f32| {err32}, envelope {env}")
    assert 0 < u_env and u_err <= 2 * u_env and _err(up.nhwc(), u16) <= 2 * u_env
    assert 0 < env and err32 <= 2 * env and err16 <= 2 * env
    # conv_hr's bias dropped is far outside the gate
    bad = H.rrdb_hr_reference(x, ws, [bs[0], bs[1], torch.zeros_like(bs[2]), bs[3]], 0.2)
    assert _err(got, bad) > 4 * env


@pytest.mark.cuda
def test_rrdb_hr_raises_outside_its_gate(dev):
    from srgan_st_tpu_torch.kernels import rrdb_hr as H

    ws, bs = _hr_operands(dev)
    for x in (torch.zeros(1, 8, 8, 64, device=dev),                       # f32
              torch.zeros(1, 8, 8, 32, device=dev, dtype=torch.bfloat16),   # nf = 32
              torch.zeros(1, 8, 8, 64, device=dev, dtype=torch.bfloat16)[:, :, 1:]):  # strided
        with pytest.raises(ValueError, match="rrdb_hr"):
            H.rrdb_hr_upsample(x, ws, bs, 0.2)
    x = torch.zeros(1, 8, 8, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="rrdb_hr"):
        H.rrdb_hr_upsample(x, ws[:3] + [ws[2]], bs[:3] + [bs[2]], 0.2)  # a 64-channel frame
    with pytest.raises(ValueError, match="rrdb_hr"):
        H.rrdb_hr_tail(torch.zeros(1, 32, 32, 64, device=dev, dtype=torch.bfloat16), ws, bs, 0.2)


@pytest.mark.cuda
def test_swinir_frame_at_540p_launches_kernel_h_and_matches_the_torch_hr_path(dev, monkeypatch):
    """SwinIR-M at its published widths through make_generator_apply on a
    540p frame (padded to 544 rows, cropped back), torch's fused attention
    made to raise: one trunk, 36 attention cores, each kernel W (`swin_attn`
    = `window_attn`), and two kernel H calls (`rrdb_hr` = 2 x `swin_trunk`),
    the frame within the cell's limits of the plain reference; with kernel H's gate
    shut, the torch HR modules (conv_last's bias plus the mean added after
    it) give a frame within the same limits, and the two frames lie within
    the rms limit of each other."""
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    from benchmark import compare, harness, seeded, seeded_swinir
    from benchmark.drivers.serve_swinir import program_config
    from benchmark.reference.swinir import upscale
    from srgan_st_tpu_torch.eval.validate import make_generator_apply
    from srgan_st_tpu_torch.kernels import launch_counts, reset_launch_counts
    from srgan_st_tpu_torch.kernels import rrdb_hr as H
    from srgan_st_tpu_torch.models.swinir import SwinIR

    def refused(*args, **kwargs):
        raise AssertionError("the port called scaled_dot_product_attention")
    monkeypatch.setattr(torch.nn.functional, "scaled_dot_product_attention", refused)
    cfg = harness.load_json("configs", "swinir_m_realsr_x4.json")
    limits = harness.load_json("workloads", "swinir_m_realsr_x4.video_4k_swinir.json")["limits"]
    gen = seeded.generator_for(2**31 + 97, dev)
    sd = seeded_swinir.state(cfg, gen, dev)
    fn = make_generator_apply(program_config(cfg), sd, dev)
    assert isinstance(fn.model, SwinIR) and fn.model.dtype == torch.bfloat16
    x = torch.rand(1, 540, 960, 3, generator=gen, device=dev)
    fn(x)
    reset_launch_counts()
    sr = fn(x)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts.pop("swin_trunk") == 1
    assert counts.pop("window_attn") == counts.pop("swin_attn") == 36
    assert counts.pop("rrdb_hr") == 2 and set(counts.values()) == {0}, counts
    monkeypatch.setattr(H, "gate", lambda *a: False)
    reset_launch_counts()
    sr_torch = fn(x)
    torch.cuda.synchronize()
    assert launch_counts()["rrdb_hr"] == 0
    ref = upscale(sd, x)
    assert sr.shape == sr_torch.shape == (1, 2160, 3840, 3)
    for got in (sr, sr_torch):
        rms, big = compare.frame_gaps(got, ref)
        assert rms <= limits["frame_rms_gap"] and big <= limits["frame_max_gap"], (rms, big)
    between = compare.frame_gaps(sr, sr_torch)
    print(f"swinir 540p frame: kernel H vs reference {compare.frame_gaps(sr, ref)}, torch HR "
          f"vs reference {compare.frame_gaps(sr_torch, ref)}, between {between}")
    assert between[0] <= limits["frame_rms_gap"]
