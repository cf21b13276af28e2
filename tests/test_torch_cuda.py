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
                                   (16, 48, 48, 256)])
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
    assert _err(cc.coarse_conv_s2d(xb, wb), ref_b) <= 2 * env


@pytest.mark.cuda
@pytest.mark.parametrize("bhw", [(1, 8, 8), (1, 14, 38), (2, 100, 70), (1, 2, 2)])
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
