"""The algorithm's work, counted from the shapes whatever implements it,
and the card's peaks.

A convolution or matrix product costs 2 FLOPs a multiply-accumulate. A
trained layer costs its forward, the gradient of its input (dgrad) and
of its weights (wgrad): three forwards. A frozen network that a gradient
flows through costs two, and one that only scores its input, one. Bytes
count each input once and each output once, in the compute dtype, as
the least any implementation has to move."""

from __future__ import annotations

import importlib
import math

PEAK_BF16_FLOPS = 989e12   # H100 SXM, dense bf16 tensor cores (data sheet)
PEAK_HBM_BYTES_PER_S = 3.35e12
BF16 = 2

# (out-channel multiple of the base width, stride) of the discriminator's
# convolutions after its first (model.py:7-71)
D_LAYERS = ((1, 2), (2, 1), (2, 2), (4, 1), (4, 2), (8, 1), (8, 2))


def conv_macs(h_out: int, w_out: int, cin: int, cout: int, k: int) -> int:
    return h_out * w_out * cin * cout * k * k


def generator_fwd_flops(lr_h: int, lr_w: int, cfg: dict) -> float:
    """SRResNet forward of one LR image: 9x9 stem, 2 convs a residual
    block, the fusion conv, the x2 sub-pixel convs, the 9x9 reconstruction
    conv at the HR size."""
    c = cfg["g_channels"]
    macs = conv_macs(lr_h, lr_w, cfg["g_in_channels"], c, 9)
    macs += (2 * cfg["g_num_rcb"] + 1) * conv_macs(lr_h, lr_w, c, c, 3)
    h, w = lr_h, lr_w
    for _ in range(int(round(math.log2(cfg["upscale_factor"])))):
        macs += conv_macs(h, w, c, 4 * c, 3)
        h, w = 2 * h, 2 * w
    macs += conv_macs(h, w, c, cfg["g_out_channels"], 9)
    return 2.0 * macs


def discriminator_fwd_flops(cfg: dict, upto_tap: int | None = None) -> float:
    """The discriminator's forward of one GT-sized image, or of its layers
    up to the LeakyReLU "features.{upto_tap}"."""
    s, c = cfg["gt_image_size"], cfg["d_channels"]
    macs = conv_macs(s, s, cfg["d_in_channels"], c, 3)
    prev = c
    for j, (mult, stride) in enumerate(D_LAYERS):
        if upto_tap is not None and 2 + 3 * j > upto_tap:
            return 2.0 * macs
        s //= stride
        macs += conv_macs(s, s, prev, mult * c, 3)
        prev = mult * c
    macs += s * s * prev * 1024 + 1024 * cfg["d_out_channels"]
    return 2.0 * macs


def st_bank_rows(cfg: dict, ksize: int = 3) -> tuple[int, int, int]:
    """(N, M, d) of PatchwiseST's selection: N patches of sr, a bank of M
    patches of gt at 1, 1/2 and 1/4 scale, d = 3 k k features."""
    s = cfg["gt_image_size"]
    n = (s // ksize) ** 2
    m = n + (s // 2 // ksize) ** 2 + (s // 4 // ksize) ** 2
    return n, m, 3 * ksize * ksize


def buddy_selection(batch: int, n: int, m: int, d: int) -> tuple[float, float]:
    """(FLOPs, bytes) of the buddy selection: two (N x M) distance
    matrices over d features (p1 and p2 against the bank), their cross
    terms 2 FLOPs a multiply-accumulate; p1, p2 and the bank read in bf16,
    one int32 index a row written."""
    flops = 2 * 2.0 * batch * n * m * d
    return flops, BF16 * batch * d * (2 * n + m) + 4.0 * batch * n


# FLOPs of one G step's criterion for one GT patch, by kind
def _criterion_flops(kind: str, cfg: dict) -> float | None:
    if kind in ("pixel",):
        return 0.0
    if kind == "adversarial":   # D on sr, frozen, the gradient flows through it
        return 2 * discriminator_fwd_flops(cfg)
    if kind == "content_disc":  # the taps of the frozen content D: sr fwd + dgrad, gt fwd
        deepest = max(int(t.split(".")[1]) for t in cfg["content_disc_taps"])
        return 3 * discriminator_fwd_flops(cfg, deepest)
    if kind == "patchwise_st":
        n, m, d = st_bank_rows(cfg)
        return buddy_selection(1, n, m, d)[0]
    name = f"benchmark.work_{kind}"  # a criterion added later counts itself there
    try:
        module = importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:
            raise
        return None
    return module.flops_per_patch(cfg)


def train_flops_per_patch(cfg: dict, phase: str) -> float | None:
    """Model FLOPs of one GT patch in a step of `phase` ("warmup" or
    "gan"): G trained (3 forwards), each criterion's networks, and in
    "gan" the D update every d_update_interval batches (D trained on gt and
    sr). None where a criterion's work is not counted here."""
    s = cfg["gt_image_size"] // cfg["upscale_factor"]
    total = 3 * generator_fwd_flops(s, s, cfg)
    criteria = cfg["criteria"] if phase == "gan" else cfg["warmup_criteria"]
    for spec in criteria.values():
        f = _criterion_flops(spec["kind"], cfg)
        if f is None:
            return None
        total += f
    if phase == "gan":
        total += 2 * 3 * discriminator_fwd_flops(cfg) / cfg["d_update_interval"]
    return total


def trunk(batch: int, h: int, w: int, c: int, n_rcb: int) -> dict:
    """(FLOPs, bytes) of the residual trunk's forward and backward in a
    train step: 2 n 3x3 convs C -> C; backward = dgrad + wgrad. Forward
    reads x and the kernels and writes y; backward reads dy, x and the
    kernels and writes dx and the kernels' gradients (f32)."""
    conv = 2.0 * conv_macs(h, w, c, c, 3) * batch * 2 * n_rcb
    act = BF16 * batch * h * w * c
    kernels = 2 * n_rcb * 9 * c * c
    return {"fwd": (conv, 2 * act + BF16 * kernels),
            "bwd": (2 * conv, 3 * act + BF16 * kernels + 4 * kernels)}


def coarse_tail(batch: int, h: int, w: int, c_pre: int, cout: int, k: int = 9) -> tuple:
    """(FLOPs, bytes) of the reconstruction conv on the last sub-pixel
    stage's pre-shuffle activation (B, h, w, c_pre): a k x k conv of
    c_pre / 4 channels at (2h, 2w) to cout; the activation read once, the
    output and the kernel in bf16."""
    cin = c_pre // 4
    flops = 2.0 * batch * conv_macs(2 * h, 2 * w, cin, cout, k)
    nbytes = BF16 * (batch * h * w * c_pre + batch * 4 * h * w * cout + k * k * cin * cout)
    return flops, nbytes


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the compute and
    the memory bound."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)
