"""SwinIR's work a frame, counted from the shapes whatever implements it
(2 FLOPs a multiply-accumulate; bytes in bf16, each input once and each
output once), on the frame padded to a multiple of the window, by part:
the trunk (patch_embed.norm through conv_after_body and the skip: the
`g.trunk` region), its window-attention cores (`g.attn_core`: q k^T and p
v of every head) and the HR stage (conv_before_upsample, then Real-
ESRGAN's: benchmark/work_rrdb.py `hr_stage`). At 540 x 960 (padded to 544):
14.27 TFLOP a frame, 12.74 of them the trunk's, 9.75 its linears', 0.87
its attention cores'."""

from __future__ import annotations

from benchmark import work_rrdb
from benchmark.work import BF16, bound_seconds, conv_macs


def padded(h: int, w: int, cfg: dict) -> tuple[int, int]:
    """The frame's size after SwinIR's reflect padding to the window."""
    ws = cfg["window_size"]
    return -(-h // ws) * ws, -(-w // ws) * ws


def _dims(cfg: dict) -> tuple[int, int, int, int]:
    """(C, hidden, N = window^2, blocks)."""
    c = cfg["embed_dim"]
    return c, int(c * cfg["mlp_ratio"]), cfg["window_size"] ** 2, sum(cfg["depths"])


def block_linear_macs_per_token(cfg: dict) -> int:
    """qkv, proj, fc1 and fc2 at one token (259,200 at 180 / 360)."""
    c, hidden, _, _ = _dims(cfg)
    return c * (3 * c + c + 2 * hidden)


def attn_core(h: int, w: int, cfg: dict) -> tuple[float, float]:
    """(FLOPs, bytes) of one attention core over an LR frame of h x w:
    q k^T and p v of every head of every window (2 N C multiply-adds a
    token); q, k and v read once and the heads' output written once, and
    the frame's additive tensors once a frame, spread over its cores:
    each block's bias (heads x N x N) and one shift mask (windows x N x N)."""
    hp, wp = padded(h, w, cfg)
    c, _, n, blocks = _dims(cfg)
    tokens = hp * wp
    windows = tokens // n
    flops = 2.0 * 2 * tokens * n * c
    additive = blocks * cfg["num_heads"][0] * n * n + windows * n * n
    return flops, BF16 * (4 * tokens * c + additive / blocks)


def trunk_flops(h: int, w: int, cfg: dict) -> float:
    """The `g.trunk` region: every block's linears and attention core, each
    RSTB's 3x3 conv and conv_after_body (LayerNorms, GELU and adds are not
    counted)."""
    hp, wp = padded(h, w, cfg)
    c, _, n, blocks = _dims(cfg)
    tokens = hp * wp
    macs = blocks * tokens * (block_linear_macs_per_token(cfg) + 2 * n * c)
    macs += (len(cfg["depths"]) + 1) * conv_macs(hp, wp, c, c, 3)
    return 2.0 * macs


def trunk_bytes(h: int, w: int, cfg: dict) -> float:
    """The trunk's input and output (C channels at the padded size) and
    its weights."""
    hp, wp = padded(h, w, cfg)
    c, _, _, blocks = _dims(cfg)
    weights = blocks * block_linear_macs_per_token(cfg) + (len(cfg["depths"]) + 1) * 9 * c * c
    return BF16 * (2 * hp * wp * c + weights)


def hr_stage(h: int, w: int, cfg: dict) -> tuple[float, float]:
    """(FLOPs, bytes) of the `g.upsample` and `g.tail` regions:
    conv_before_upsample (C -> num_feat at the padded size) and
    Real-ESRGAN's HR stage on the padded map."""
    hp, wp = padded(h, w, cfg)
    nf = cfg["num_feat"]
    flops, nbytes = work_rrdb.hr_stage(hp, wp, {"num_feat": nf, "num_out_ch": cfg["in_chans"]})
    flops += 2.0 * conv_macs(hp, wp, cfg["embed_dim"], nf, 3)
    nbytes += BF16 * (hp * wp * cfg["embed_dim"] + 9 * cfg["embed_dim"] * nf)
    return flops, nbytes


def frame_flops(h: int, w: int, cfg: dict) -> float:
    """The whole forward of one LR frame: conv_first, the trunk, the HR
    stage."""
    hp, wp = padded(h, w, cfg)
    stem = 2.0 * conv_macs(hp, wp, cfg["in_chans"], cfg["embed_dim"], 3)
    return stem + trunk_flops(h, w, cfg) + hr_stage(h, w, cfg)[0]


def trunk_bound_seconds(h: int, w: int, cfg: dict) -> float:
    return bound_seconds(trunk_flops(h, w, cfg), trunk_bytes(h, w, cfg))


def attn_core_bound_seconds(h: int, w: int, cfg: dict) -> float:
    return bound_seconds(*attn_core(h, w, cfg))
