"""Best-buddy selection (port of srgan_st_tpu/kernels/buddy_select.py: K7
`_buddy_kernel`).

For each batch element and each row n of the candidate patches,

    idx[n] = argmin_m  alpha * s(p1[n], bank[m]) + beta * s(p2[n], bank[m])

with s the squared l2 distance (clamped at 0) or the l1 distance, scores in
f32 from inputs upcast to f32, ties to the first occurrence (as torch.min
and jnp.argmin). With l2 both the kernels and the plain version keep each
row's two best by the f32 expansion |p|^2 + |q|^2 - 2 p.q and return the
one whose exact score (p - q)^2, summed in f64 in feature order, is
smaller (the lower index on an exact tie): the expansion cancels, and
its rounding can order two close rows either way (csrc/buddy_select.cu,
"Near ties"). The JAX kernel keeps the expansion's order (ROADMAP.md Queue
C). `buddy_select_index` returns the (B, N) int32 indices: on
a CUDA tensor it launches a hand-written kernel of csrc/buddy_select.cu,
chosen by the function: bf16 inputs with l2 scores take the tensor-core
kernel ("mma": the cross terms by mma.sync, exact bf16 products into f32),
f32 inputs and l1 scores the SIMT kernel ("simt": l1 has no product form,
and f32 on the tensor cores would be TF32). On a CPU tensor it runs the
plain version `buddy_select_reference`.
`buddy_select` gathers the selected bank rows outside the kernel, exactly,
and without gradient: the bank derives from ground truth and an argmin has
none (the reference's gather backward is dead code).
"""

from __future__ import annotations

import ctypes

import torch

from srgan_st_tpu_torch.kernels import _build
from srgan_st_tpu_torch.ops.pairwise import batch_pairwise_distance
from srgan_st_tpu_torch.utils.profiling import span

# launches of the CUDA kernels since import (or the last reset), and the
# variant the last one ran
launches = 0
last_variant = ""

# (dtype, dist_norm) -> (variant, C function): every input either kernel takes
_KERNELS = {(torch.bfloat16, "l2"): ("mma", "buddy_select_bf16_mma"),
            (torch.bfloat16, "l1"): ("simt", "buddy_select_bf16"),
            (torch.float32, "l2"): ("simt", "buddy_select_f32"),
            (torch.float32, "l1"): ("simt", "buddy_select_f32")}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {"buddy_select_bf16": [_P] * 4 + [_I] * 4 + [_F, _F, _I, _P],
               "buddy_select_f32": [_P] * 4 + [_I] * 4 + [_F, _F, _I, _P],
               "buddy_select_bf16_mma": [_P] * 4 + [_I] * 4 + [_F, _F, _P]}
MAX_D = 160  # feature width the kernel takes (ksize 7 gives 3 * 49 = 147)


def _exact_scores(p1, p2, rows, alpha: float, beta: float) -> torch.Tensor:
    """alpha |p1 - q|^2 + beta |p2 - q|^2 in f64 for p1, p2 (B, N, d) and
    rows (B, N, k, d) -> (B, N, k), summed over the features in order as
    the kernels' `exact_score` does, alpha and beta taken as f32."""
    a, c = (p.double()[:, :, None] for p in (p1, p2))
    q = rows.double()
    s1 = s2 = torch.zeros(q.shape[:-1], dtype=torch.float64, device=q.device)
    for k in range(q.shape[-1]):
        s1 = s1 + (a[..., k] - q[..., k]) ** 2
        s2 = s2 + (c[..., k] - q[..., k]) ** 2
    f32 = lambda v: float(torch.tensor(v, dtype=torch.float32))  # noqa: E731
    return f32(alpha) * s1 + f32(beta) * s2


@torch.no_grad()
def expansion_scores(p1, p2, bank, alpha: float = 1.0, beta: float = 1.0,
                     dist_norm: str = "l2") -> torch.Tensor:
    """The (B, N, M) f32 scores alpha * d(p1, bank) + beta * d(p2, bank) by
    ops/pairwise.py from inputs upcast to f32 (l2: ||p||^2 + ||q||^2 -
    2 p.q, the cross term a batched product with TF32 off)."""
    bank = bank.float()
    return (alpha * batch_pairwise_distance(p1.float(), bank, dist_norm)
            + beta * batch_pairwise_distance(p2.float(), bank, dist_norm))


@torch.no_grad()
def buddy_select_reference(p1, p2, bank, alpha: float = 1.0, beta: float = 1.0,
                           dist_norm: str = "l2") -> torch.Tensor:
    """The plain version: the argmin of `expansion_scores` over the bank
    (first occurrence); with l2, of that row and the next best (the first
    occurrence among the rest) the one with the smaller exact score, as the
    kernels refine. Returns (B, N) int32."""
    score = expansion_scores(p1, p2, bank, alpha, beta, dist_norm)
    i1 = torch.argmin(score, dim=2, keepdim=True)
    if dist_norm != "l2":
        return i1[..., 0].to(torch.int32)
    rest = score.scatter(2, i1, float("inf"))
    i2 = torch.argmin(rest, dim=2, keepdim=True)
    two = torch.cat([i1, i2], dim=2)  # (B, N, 2)
    b, n, _ = two.shape
    rows = torch.gather(bank, 1, two.reshape(b, 2 * n, 1).expand(-1, -1, bank.shape[-1]))
    e = _exact_scores(p1, p2, rows.reshape(b, n, 2, -1), alpha, beta)
    e1, e2 = e[..., 0], e[..., 1]
    j1, j2 = i1[..., 0], i2[..., 0]
    take = (torch.isfinite(torch.gather(rest, 2, i2)[..., 0])
            & ((e2 < e1) | ((e2 == e1) & (j2 < j1))))
    return torch.where(take, j2, j1).to(torch.int32)


def _launch(p1, p2, bank, alpha, beta, dist_norm) -> torch.Tensor:
    global launches, last_variant
    if dist_norm not in ("l1", "l2"):
        raise NotImplementedError(f"{dist_norm} norm has not been supported.")
    dt = bank.dtype
    if (dt, dist_norm) not in _KERNELS or p1.dtype != dt or p2.dtype != dt:
        raise ValueError(f"buddy_select: the kernel takes bf16 or f32 inputs of one "
                         f"dtype; got {p1.dtype}, {p2.dtype}, {bank.dtype}")
    b, n, d = p1.shape
    m = bank.shape[1]
    if p2.shape != p1.shape or bank.shape != (b, m, d) or not 0 < d <= MAX_D:
        raise ValueError(f"buddy_select: p1, p2 (B, N, d) and bank (B, M, d) with "
                         f"d <= {MAX_D}; got {tuple(p1.shape)}, {tuple(p2.shape)}, "
                         f"{tuple(bank.shape)}")
    if min(b, n, m) == 0:
        raise ValueError("buddy_select: empty input")
    p1, p2, bank = (t.contiguous() for t in (p1, p2, bank))
    idx = torch.empty((b, n), device=bank.device, dtype=torch.int32)
    variant, fn = _KERNELS[dt, dist_norm]
    lib = _build.load("buddy_select", _SIGNATURES)
    ptrs = (p1.data_ptr(), p2.data_ptr(), bank.data_ptr(), idx.data_ptr())
    with torch.cuda.device(bank.device), span("kernel.buddy_select"):
        stream = torch.cuda.current_stream().cuda_stream
        if variant == "mma":
            err = getattr(lib, fn)(*ptrs, b, n, m, d, float(alpha), float(beta), stream)
        else:
            err = getattr(lib, fn)(*ptrs, b, n, m, d, float(alpha), float(beta),
                                   int(dist_norm == "l1"), stream)
    _build.check(err, f"buddy_select ({variant})")
    launches += 1
    last_variant = variant
    return idx


@torch.no_grad()
def buddy_select_index(p1, p2, bank, alpha: float = 1.0, beta: float = 1.0,
                       dist_norm: str = "l2") -> torch.Tensor:
    """(B, N) int32 indices of the selected bank rows: the CUDA kernel on a
    CUDA tensor (it raises on inputs it does not take), the plain version
    on a CPU one."""
    if bank.device.type == "cpu":
        return buddy_select_reference(p1, p2, bank, alpha, beta, dist_norm)
    if bank.device.type != "cuda":
        raise ValueError(f"buddy_select: no kernel for device {bank.device}")
    return _launch(p1, p2, bank, alpha, beta, dist_norm)


def gather_rows(bank: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """bank[b, idx[b, n]] for every (b, n), without gradient."""
    index = idx.long()[..., None].expand(-1, -1, bank.shape[-1])
    return torch.gather(bank.detach(), 1, index)


def buddy_select(p1, p2, bank, alpha: float = 1.0, beta: float = 1.0,
                 dist_norm: str = "l2", return_index: bool = False):
    """p1, p2 (B, N, d); bank (B, M, d) -> the selected rows (B, N, d)
    (and the (B, N) int32 indices with `return_index`)."""
    idx = buddy_select_index(p1, p2, bank, alpha, beta, dist_norm)
    sel = gather_rows(bank, idx)
    return (sel, idx) if return_index else sel
