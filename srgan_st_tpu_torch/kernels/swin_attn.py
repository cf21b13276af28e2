"""SwinIR's window attention core as one hand-written kernel (kernel W,
`csrc/swin_attn.cu`; it replaces no TPU kernel: the JAX package has no
SwinIR).

For W windows of N tokens, from qkv (W, N, 3 C) as SwinIR's qkv linear
writes it (q, k and v, each `heads` heads of hd = C / heads columns), a
block's relative-position bias table ((2 window - 1)^2, heads) float32 and
index (N, N), and the region labels (E, N) uint8 of the last E windows
(those a shifted block's mask reaches, `SwinIR.plan` puts them last):

    s   = scale q k^T + table[index]
    s  += -100 between two tokens of different labels    (the last E windows)
    out = softmax(s) v           (W, N, C), the heads concatenated

with the scores, their max, exponentials and row sums in float32, p rounded
once to qkv's dtype for p v, which accumulates in float32, and the output
rounded once. `swin_attn_reference` is that arithmetic in torch ops (the
plain version); `label_mask` is the mask the labels give, SwinIR's
`calculate_mask` rule.

`swin_attn` runs the plain version on a CPU tensor and launches the kernel
on a CUDA one (bf16, N = 64, hd even and at most MAX_HEAD_DIM, at most
MAX_HEADS heads: what its shared memory holds; one launch a call, counted
in `launches`) or raises; the kernel has no backward. `gate` is
models/swinir.py's choice of this path, a pure function of what the core
observes.
"""

from __future__ import annotations

import ctypes

import torch

from srgan_st_tpu_torch.kernels import _build
from srgan_st_tpu_torch.utils.profiling import span

# calls of the CUDA kernel since import (or the last reset): one a core
launches = 0

MASKED = -100.0
TOKENS = 64        # N: window 8 (csrc/swin_attn.cu N)
TABLE_ROWS = 225   # (2 window - 1)^2 relative positions (TABLE_ROWS)
MAX_HEAD_DIM = 32  # the mma's two k steps (csrc/swin_attn.cu MAX_HD)
MAX_HEADS = 8      # the bias table's rows in shared memory (MAX_HEADS)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"swin_attn_bf16": [_P] * 5 + [_I] * 4 + [_F, _P]}


def gate(grad_enabled: bool, device_type: str, dtype: torch.dtype, tokens: int, heads: int,
         head_dim: int) -> bool:
    """Whether the attention core runs this kernel: no gradient (the kernel
    has no backward), a CUDA bf16 qkv, windows of TOKENS, heads of an even
    width of at most MAX_HEAD_DIM, at most MAX_HEADS of them."""
    return (not grad_enabled and device_type == "cuda" and dtype == torch.bfloat16
            and tokens == TOKENS and 0 < heads <= MAX_HEADS
            and 0 < head_dim <= MAX_HEAD_DIM and head_dim % 2 == 0)


def label_mask(labels: torch.Tensor) -> torch.Tensor:
    """(E, N, N) float32: 0 between two tokens of one label, MASKED between
    two labels."""
    return torch.where(labels[:, :, None] != labels[:, None, :], MASKED, 0.0)


def table_bias(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """(heads, N, N) float32: the relative-position bias, table[index]."""
    n = index.shape[0]
    return table.float()[index.reshape(-1).long()].view(n, n, -1).permute(2, 0, 1)


def swin_attn_reference(qkv, table, index, heads: int, scale: float, labels=None):
    """The plain version: the kernel's arithmetic in torch ops (module
    docstring), on any device and dtype."""
    w, n, c3 = qkv.shape
    hd = c3 // (3 * heads)
    q, k, v = qkv.view(w, n, 3, heads, hd).permute(2, 0, 3, 1, 4).float()
    s = q @ k.transpose(-2, -1) * scale + table_bias(table, index)
    if labels is not None and labels.shape[0]:
        s[w - labels.shape[0]:] += label_mask(labels).unsqueeze(1)
    p = torch.softmax(s, -1).to(qkv.dtype).float()
    return (p @ v).to(qkv.dtype).transpose(1, 2).reshape(w, n, heads * hd)


def swin_attn(qkv, table, index, heads: int, scale: float, labels=None):
    """qkv (W, N, 3 C), table ((2 window - 1)^2, heads), index (N, N),
    labels (E, N) uint8 or None -> (W, N, C): on the CPU the plain version;
    on CUDA the kernel (bf16, `gate`'s shapes; qkv contiguous and 16-byte
    aligned, table float32, index int64 and labels contiguous on its
    device). Raises on anything else."""
    global launches
    if qkv.device.type == "cpu":
        return swin_attn_reference(qkv, table, index, heads, scale, labels)
    if qkv.device.type != "cuda":
        raise ValueError(f"swin_attn: no kernel for device {qkv.device}")
    w, n, c3 = qkv.shape if qkv.dim() == 3 else (0, 0, 0)
    hd = c3 // (3 * heads) if heads > 0 else 0
    if not (gate(False, "cuda", qkv.dtype, n, heads, hd) and c3 == 3 * heads * hd and w > 0):
        raise ValueError(f"swin_attn: the kernel takes qkv (W, {TOKENS}, 3 heads hd) bf16 with "
                         f"hd even, at most {MAX_HEAD_DIM}, and at most {MAX_HEADS} heads; got "
                         f"{tuple(qkv.shape)} {qkv.dtype} over {heads} heads")
    e = 0 if labels is None else labels.shape[0]
    want = ((table, (TABLE_ROWS, heads), torch.float32), (index, (n, n), torch.int64),
            *(() if labels is None else ((labels, (e, n), torch.uint8),)))
    for x, shape, dtype in ((qkv, qkv.shape, torch.bfloat16), *want):
        if (tuple(x.shape) != tuple(shape) or x.dtype != dtype or x.device != qkv.device
                or not x.is_contiguous() or x.data_ptr() % 16):
            raise ValueError(f"swin_attn: the operands contiguous, 16-byte aligned on "
                             f"{qkv.device}: table {want[0][1]} float32, index {want[1][1]} "
                             f"int64, labels (E, {n}) uint8; got {tuple(x.shape)} {x.dtype} "
                             f"on {x.device}")
    if e > w:
        raise ValueError(f"swin_attn: labels for {e} of {w} windows")
    out = torch.empty((w, n, heads * hd), device=qkv.device, dtype=qkv.dtype)
    lib = _build.load("swin_attn", _SIGNATURES)
    with torch.cuda.device(qkv.device), span("kernel.swin_attn"):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.swin_attn_bf16(qkv.data_ptr(), table.data_ptr(), index.data_ptr(),
                                 labels.data_ptr() if e else None, out.data_ptr(), w, w - e,
                                 heads, hd, float(scale), stream)
    _build.check(err, "swin_attn")
    launches += 1
    return out
