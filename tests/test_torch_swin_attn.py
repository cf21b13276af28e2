"""Kernel W, SwinIR's window attention core (csrc/swin_attn.cu,
kernels/swin_attn.py), on a GPU.

Every test here is marked `cuda` and skips without a GPU; none imports
JAX, so they run on a machine with only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_swin_attn.py -m cuda --noconftest -p no:cacheprovider

Tolerance: against softmax(scale q k^T + table[index] + mask) v computed in
float64 from the same bf16 q, k and v, max |kernel - f64| <= 2^-7 max |v|:
the kernel rounds p and the output once each to bf16 (relative error at
most 2^-8 each, bf16's unit roundoff; sum p |v| <= max |v| and |out| <=
max |v|), and its f32 sums err far below that; and within
2x the plain version's own distance from f64 on the card (the bf16
envelope rule of tests/test_torch_cuda.py). The gate, the labels and the
plain version's arithmetic are tested on the CPU (tests/test_torch_swinir.py).
"""

import pytest
import torch

from tests import torch_threads  # noqa: F401  (this process's share of the cores)

FRAME = (544, 960)  # a 540p frame padded to the window: 8,160 windows


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _labels(batch, dev):
    """A shifted block's labels at FRAME for `batch` frames, as SwinIR's
    plan makes them (the 187 windows a frame that the mask reaches)."""
    from srgan_st_tpu_torch.models import swinir as S

    lab = S.shift_labels(*FRAME, 8, 4, dev)
    reached = (lab != lab[:, :1]).any(1)
    return lab[reached].repeat(batch, 1).contiguous()


def _case(windows, heads, hd, dev, seed=0):
    """qkv (windows, 64, 3 heads hd) bf16 of std 1.5 and a bias table of
    std 2 (the cell's seeded tables): peaked rows, the bias and the mask
    both matter."""
    from srgan_st_tpu_torch.models import swinir as S

    g = torch.Generator(device=dev).manual_seed(seed)
    qkv = (torch.randn(windows, 64, 3 * heads * hd, generator=g, device=dev) * 1.5).bfloat16()
    table = torch.randn(225, heads, generator=g, device=dev) * 2
    return qkv, table, S.relative_position_index(8).to(dev)


def _float64(qkv, table, index, heads, scale, labels):
    from srgan_st_tpu_torch.kernels.swin_attn import label_mask, table_bias

    w, n, c3 = qkv.shape
    hd = c3 // (3 * heads)
    q, k, v = qkv.view(w, n, 3, heads, hd).permute(2, 0, 3, 1, 4).double()
    s = q @ k.transpose(-2, -1) * scale + table_bias(table, index).double()
    if labels is not None:
        s[w - labels.shape[0]:] += label_mask(labels).double().unsqueeze(1)
    return (torch.softmax(s, -1) @ v).transpose(1, 2).reshape(w, n, heads * hd), v


def _check(qkv, table, index, heads, labels):
    from srgan_st_tpu_torch.kernels import swin_attn as W

    scale = (qkv.shape[-1] // (3 * heads)) ** -0.5
    before = W.launches
    got = W.swin_attn(qkv, table, index, heads, scale, labels)
    torch.cuda.synchronize()
    assert W.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (*qkv.shape[:2], qkv.shape[-1] // 3)
    assert torch.equal(got, W.swin_attn(qkv, table, index, heads, scale, labels))  # no atomics
    want, v = _float64(qkv, table, index, heads, scale, labels)
    plain = W.swin_attn_reference(qkv, table, index, heads, scale, labels)
    err, env = float((got.double() - want).abs().max()), float((plain.double() - want).abs().max())
    print(f"swin_attn {tuple(qkv.shape)} heads {heads} edge "
          f"{0 if labels is None else labels.shape[0]}: |kernel - f64| {err}, plain {env}, "
          f"max|v| {float(v.abs().max())}")
    assert 0 < env and err <= 2 * env and err <= 2.0 ** -7 * float(v.abs().max())
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("shifted", [False, True])
def test_kernel_w_matches_float64_at_the_cells_shape(dev, shifted):
    """(8160, 64, 540), heads of 30: an unshifted block, and a shifted one
    whose last 187 windows take the mask (split 8160 - 187); the mask
    moves those windows far past the tolerance."""
    from srgan_st_tpu_torch.kernels import swin_attn as W

    labels = _labels(1, dev) if shifted else None
    qkv, table, index = _case(8160, 6, 30, dev)
    if shifted:
        assert labels.shape == (187, 64)
    got, want = _check(qkv, table, index, 6, labels)
    if shifted:
        free = W.swin_attn(qkv, table, index, 6, 30 ** -0.5)
        edge = slice(8160 - 187, None)
        assert torch.equal(free[:edge.start], got[:edge.start])
        assert float((free[edge].double() - want[edge]).abs().max()) > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("windows,heads,hd,edge", [
    (2 * 8160, 6, 30, 374),  # two frames in one call, each frame's edge windows last
    (301, 6, 30, 0),         # windows no multiple of the CTAs, none masked
    (301, 6, 32, 187),       # heads of 32
    (1000, 8, 32, 187),      # C = 256: the ring's two stages
    (133, 3, 16, 133),       # narrow heads, every window masked (split 0)
])
def test_kernel_w_batch_ragged_windows_and_head_widths(dev, windows, heads, hd, edge):
    labels = _labels(2, dev)[:edge].contiguous() if edge else None
    qkv, table, index = _case(windows, heads, hd, dev, seed=windows + hd)
    _check(qkv, table, index, heads, labels)


@pytest.mark.cuda
def test_swin_attn_raises_outside_its_gate(dev):
    from srgan_st_tpu_torch.kernels import swin_attn as W

    qkv, table, index = _case(8, 6, 30, dev)
    lab = torch.zeros(4, 64, dtype=torch.uint8, device=dev)
    for args in ((qkv.float(), table, index, 6),                          # f32
                 (qkv[:, :16].contiguous(), table, index[:16, :16], 6),   # window 4
                 (torch.zeros(8, 64, 3 * 6 * 34, device=dev, dtype=torch.bfloat16), table,
                  index, 6),                                              # heads of 34
                 (torch.zeros(8, 64, 541, device=dev, dtype=torch.bfloat16)[..., 1:], table,
                  index, 6),                                              # strided
                 (qkv, table[:, :3], index, 6)):                          # another table
        with pytest.raises(ValueError, match="swin_attn"):
            W.swin_attn(*args, 0.2)
    with pytest.raises(ValueError, match="swin_attn"):
        W.swin_attn(qkv, table, index, 6, 0.2, lab.float())
    with pytest.raises(ValueError, match="swin_attn"):
        W.swin_attn(qkv, table, index, 6, 0.2, torch.zeros(9, 64, dtype=torch.uint8,
                                                            device=dev))
