"""SwinIR (Liang et al., arXiv:2108.10257; models/network_swinir.py of
github.com/JingyunLiang/SwinIR) with the `nearest+conv` x4 upsampler of its
real-world SR release, the port's third generator (MODEL.G_ARCH "swinir");
eval only. The published model (main_test_swinir.py, task `real_sr`) is
SwinIR-M: embed 180, 6 RSTBs of 6 Swin blocks, 6 heads of 30, window 8,
MLP ratio 2, 64 features in the HR stage; 11,715,559 parameters.

  reflect padding to a multiple of the window (`check_image_size`), minus
    the mean (0.4488, 0.4371, 0.4040)
  conv_first 3x3, 3 -> C; patch_embed.norm (LayerNorm over C)
  trunk: RSTBs, RSTB(x) = x + conv(blocks(x)) (a 3x3 conv C -> C), then
    norm, conv_after_body and the skip from conv_first
  Swin block: x + proj(W-MSA(norm1(x))), then x + fc2(gelu(fc1(norm2(x))));
    W-MSA over windows of window^2 tokens, heads of C / heads, scores
    scaled by (C / heads)^-0.5 plus a learned relative-position bias (a
    (2 window - 1)^2 x heads table); every second block's windows are
    rolled by window / 2 first (and back after), with -100 added across
    the rolled regions
  conv_before_upsample 3x3, C -> 64, LeakyReLU(0.01) (torch's default)
  Real-ESRGAN's HR stage (models/rrdb.py `hr_stage`): nearest x2 + conv +
    LeakyReLU(0.2) twice, conv_hr + LeakyReLU(0.2), conv_last; the mean
    added back, clamped to [0, 1] (main_test_swinir.py clamps;
    network_swinir.py's forward does not) and cropped to 4h x 4w.

The state-dict names are SwinIR's. Its derived buffers are recomputed
here: `relative_position_index` is a buffer left out of the state dict,
and the shift mask is made for each frame shape (SwinIR's `attn_mask` is
for its img_size, 64): `release_state` drops both from a release.

Input and output are NHWC. The trunk keeps its tokens in NHWC order,
(B, H, W, C), so that each RSTB's conv reads them in place as a
channels_last map; the residual stream is float32 (376 MB at 540p), so
that one block's fault is not lost under bf16 roundings of 36 blocks.
Linears and convs take compute-dtype operands with f32 accumulation;
LayerNorm statistics (from the f32 stream), the softmax and the GELU (erf)
run in f32, each result rounded once to the compute dtype. A window
partition, with its roll, is one gather of the tokens by a permutation
made once per frame shape, and its reverse the inverse permutation. The
gather puts the windows the shift mask reaches (the last row and column
of windows: 187 of 8,160 at 540p) after the others, the frames' in turn,
with each of their tokens' region labels (`shift_labels`), from which the
mask is made. The attention core (`window_attention`) reads q, k and v as
the qkv linear writes them, each block's bias through its own table and
index, and the mask from the labels: kernel W (kernels/swin_attn.py)
under its gate, elsewhere its plain version.

The HR stage runs as kernel H (kernels/rrdb_hr.py) under its gate, with
conv_last's bias plus the mean; elsewhere as the torch modules.

Regions: `g.forward`; `g.stem` (the pad, the mean, conv_first); `g.trunk`
(patch_embed.norm through the skip over the trunk), in it each block's
`g.attn` (norm1 through the attention half's residual add), which holds
`g.attn_core` (from q, k, v to the heads' output before proj), and
`g.mlp` (norm2 through its residual add); `g.upsample`
(conv_before_upsample and the two nearest x2 stages); `g.tail`. Counters:
`trunk_calls` ("swin_trunk" in `kernels.launch_counts()`), one a trunk,
and `attn_calls` ("window_attn"), one an attention core, whatever computes
it (kernel W's launches count apart, "swin_attn", under the span
`kernel.swin_attn` inside `g.attn_core`)."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from srgan_st_tpu_torch.kernels import swin_attn
from srgan_st_tpu_torch.kernels.swin_attn import label_mask, table_bias
from srgan_st_tpu_torch.models.rrdb import Conv3x3, hr_stage
from srgan_st_tpu_torch.utils.profiling import span

MEAN = (0.4488, 0.4371, 0.4040)
LN_EPS = 1e-5
BEFORE_UPSAMPLE_SLOPE = 0.01
# the key a state dict of this architecture has and the others have not
MARK = "layers.0.residual_group.blocks.0.attn.qkv.weight"
# SwinIR's buffers derived from the shapes (and, for the mask, its img_size)
DERIVED = ("relative_position_index", "attn_mask")

# calls of the trunk (`g.trunk`) and of the attention core since import or
# the last reset
trunk_calls = 0
attn_calls = 0


def relative_position_index(window: int) -> torch.Tensor:
    """(window^2, window^2): the bias table's row for each pair of
    positions in a window (network_swinir.py's WindowAttention)."""
    coords = torch.stack(torch.meshgrid(torch.arange(window), torch.arange(window),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0) + (window - 1)
    return rel[:, :, 0] * (2 * window - 1) + rel[:, :, 1]


def window_order(h: int, w: int, window: int, shift: int, device=None) -> torch.Tensor:
    """(h w,) int64: the token (y w + x) at each slot of the windows of the
    map rolled by -shift on both axes, windows in row-major order and
    tokens row-major inside each: a window partition, with its roll, as
    one gather."""
    ys = (torch.arange(h, device=device) + shift) % h
    xs = (torch.arange(w, device=device) + shift) % w
    grid = ys[:, None] * w + xs[None, :]
    return grid.view(h // window, window, w // window, window).permute(0, 2, 1, 3).reshape(-1)


def shift_labels(h: int, w: int, window: int, shift: int, device=None) -> torch.Tensor:
    """(nW, window^2) uint8: the region (0..8) of each token of each window
    of the map rolled by -shift, windows in row-major order and tokens
    row-major inside each (network_swinir.py's `calculate_mask` regions)."""
    def regions(n):
        r = torch.zeros(n, dtype=torch.uint8, device=device)
        r[n - window:n - shift] = 1
        r[n - shift:] = 2
        return r

    label = regions(h)[:, None] * 3 + regions(w)[None, :]
    windows = label.view(h // window, window, w // window, window).permute(0, 2, 1, 3)
    return windows.reshape(-1, window * window)


def shift_mask(h: int, w: int, window: int, shift: int, device=None) -> torch.Tensor:
    """(nW, window^2, window^2) float32: 0 between two tokens of a window
    from one region of the rolled map, -100 between two regions
    (network_swinir.py's `calculate_mask`)."""
    return label_mask(shift_labels(h, w, window, shift, device))


def window_attention(qkv: torch.Tensor, table: torch.Tensor, index: torch.Tensor, heads: int,
                     scale: float, labels: torch.Tensor | None = None) -> torch.Tensor:
    """The attention core: qkv (W, N, 3 C) as the qkv linear writes it
    (q, k, v, each heads x C / heads) for W windows, a block's bias table
    and index, and labels (E, N) uint8, the regions of the last E windows'
    tokens, or None -> (W, N, C), the heads' outputs concatenated, before
    proj: softmax(scale q k^T + table[index] + mask) v, the mask -100
    between tokens of two regions of the last E windows. Kernel W under
    its gate (kernels/swin_attn.py), else its plain version."""
    global attn_calls
    attn_calls += 1
    n = qkv.shape[1]
    hd = qkv.shape[-1] // (3 * heads)
    if swin_attn.gate(torch.is_grad_enabled(), qkv.device.type, qkv.dtype, n, heads, hd):
        return swin_attn.swin_attn(qkv, table, index, heads, scale, labels)
    return swin_attn.swin_attn_reference(qkv, table, index, heads, scale, labels)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int):
        super().__init__()
        self.heads, self.window = heads, window
        self.scale = (dim // heads) ** -0.5
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("relative_position_index", relative_position_index(window),
                             persistent=False)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def bias(self) -> torch.Tensor:
        """(heads, N, N) float32: the relative-position bias of a window."""
        return table_bias(self.relative_position_bias_table, self.relative_position_index)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


def _linear(x: torch.Tensor, m: nn.Linear) -> torch.Tensor:
    return F.linear(x, m.weight.to(x.dtype), m.bias.to(x.dtype))


def _norm(x: torch.Tensor, m: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """LayerNorm of the f32 stream, rounded once to `dtype`."""
    return F.layer_norm(x, m.normalized_shape, m.weight, m.bias, LN_EPS).to(dtype)


class SwinBlock(nn.Module):
    """SwinTransformerBlock: its window attention, shifted by `shift`."""

    def __init__(self, dim: int, heads: int, window: int, shift: int, hidden: int):
        super().__init__()
        self.shift = shift
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, heads, window)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, hidden)

    def forward(self, x: torch.Tensor, order: tuple, labels: torch.Tensor | None,
                dtype: torch.dtype) -> torch.Tensor:
        """x (B, H, W, C) float32, the stream; order: the gather and its
        inverse of this block's windows; labels: the regions of the windows
        its mask reaches, or None (`SwinIR.plan`'s). Returns a new stream
        tensor."""
        b, h, w, c = x.shape
        perm, inv = order
        attn = self.attn
        n = attn.window ** 2
        with span("g.attn"):
            tokens = _norm(x, self.norm1, dtype).view(b * h * w, c)
            qkv = _linear(torch.index_select(tokens, 0, perm), attn.qkv)
            with span("g.attn_core"):
                heads = window_attention(qkv.view(-1, n, 3 * c), attn.relative_position_bias_table,
                                         attn.relative_position_index, attn.heads, attn.scale,
                                         labels)
            out = _linear(heads, attn.proj).view(b * h * w, c)
            x = x + torch.index_select(out, 0, inv).view(b, h, w, c)
        with span("g.mlp"):
            y = F.gelu(_linear(_norm(x, self.norm2, dtype), self.mlp.fc1))
            x += _linear(y, self.mlp.fc2)
        return x


class BasicLayer(nn.Module):
    def __init__(self, blocks: list[SwinBlock]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)


class RSTB(nn.Module):
    """Residual Swin Transformer Block: the blocks, a 3x3 conv, the skip."""

    def __init__(self, dim: int, depth: int, heads: int, window: int, hidden: int):
        super().__init__()
        self.residual_group = BasicLayer([
            SwinBlock(dim, heads, window, 0 if j % 2 == 0 else window // 2, hidden)
            for j in range(depth)])
        self.conv = Conv3x3(dim, dim)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)


class SwinIR(nn.Module):
    """SwinIR x4 with the `nearest+conv` upsampler. Input NHWC in [0, 1];
    output NHWC float32 in [0, 1]."""

    def __init__(self, in_channels: int = 3, embed_dim: int = 180, num_rstb: int = 6,
                 depth: int = 6, heads: int = 6, window: int = 8, mlp_ratio: float = 2.0,
                 hr_channels: int = 64, upscale: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        if upscale != 4:
            raise ValueError(f"the SwinIR generator is x4 only (nearest+conv), got {upscale}")
        if in_channels != 3:
            raise ValueError(f"the SwinIR generator takes RGB (3 channels), got {in_channels}")
        if embed_dim % heads or window % 2:
            raise ValueError(f"SwinIR: embed {embed_dim} over {heads} heads, window {window}")
        self.dtype, self.window = dtype, window
        hidden = int(embed_dim * mlp_ratio)
        self.conv_first = Conv3x3(in_channels, embed_dim)
        self.patch_embed = PatchEmbed(embed_dim)
        self.layers = nn.ModuleList([RSTB(embed_dim, depth, heads, window, hidden)
                                     for _ in range(num_rstb)])
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.conv_after_body = Conv3x3(embed_dim, embed_dim)
        self.conv_before_upsample = nn.Sequential(
            Conv3x3(embed_dim, hr_channels),
            nn.LeakyReLU(BEFORE_UPSAMPLE_SLOPE, inplace=True))
        self.conv_up1 = Conv3x3(hr_channels, hr_channels)
        self.conv_up2 = Conv3x3(hr_channels, hr_channels)
        self.conv_hr = Conv3x3(hr_channels, hr_channels)
        self.conv_last = Conv3x3(hr_channels, in_channels)
        self.register_buffer("mean", torch.tensor(MEAN).view(1, -1, 1, 1), persistent=False)
        init_weights(self)
        self.to(memory_format=torch.channels_last)
        # kernel H's operands, conv_last's bias plus the mean
        from srgan_st_tpu_torch.kernels.rrdb_hr import RRDBHRWeights

        self._hr_weights = RRDBHRWeights(MEAN)
        self._hr_convs = [self.conv_up1, self.conv_up2, self.conv_hr, self.conv_last]
        self._blocks = [blk for layer in self.layers for blk in layer.residual_group.blocks]
        self._plan_key = None
        self._plan = None

    @classmethod
    def from_config(cls, config, dtype: torch.dtype | None = None) -> "SwinIR":
        """MODEL.G_EMBED_DIM, G_N_RSTB, G_RSTB_DEPTH, G_N_HEADS, G_WINDOW,
        G_MLP_RATIO and G_HR_CHANNEL; in and out are MODEL.G_IN_CHANNEL."""
        from srgan_st_tpu_torch.core.device import compute_dtype

        m = config.MODEL
        if m.G_OUT_CHANNEL != m.G_IN_CHANNEL:
            raise ValueError("the SwinIR generator writes as many channels as it reads")
        return cls(in_channels=m.G_IN_CHANNEL, embed_dim=m.G_EMBED_DIM, num_rstb=m.G_N_RSTB,
                   depth=m.G_RSTB_DEPTH, heads=m.G_N_HEADS, window=m.G_WINDOW,
                   mlp_ratio=m.G_MLP_RATIO, hr_channels=m.G_HR_CHANNEL,
                   upscale=config.DATA.UPSCALE_FACTOR,
                   dtype=dtype or compute_dtype(config.TPU.COMPUTE_DTYPE))

    def plan(self, b: int, h: int, w: int, device) -> tuple[dict, dict]:
        """The gathers of b frames of h x w ({shift: (perm, inv)}, over the
        frames' tokens flattened; the windows the shift mask reaches after
        the others) and the region labels of those windows' tokens ({shift:
        (E, N) uint8, frame after frame}, None for shift 0). Made again for
        another shape or device; only the last is kept."""
        key = (b, h, w, str(device))
        if key != self._plan_key:
            self._plan = None  # the old tensors go before the new are made
            orders, labels = {}, {}
            n = self.window * self.window
            frames = torch.arange(b, device=device).view(b, 1, 1) * (h * w)
            for shift in sorted({blk.shift for blk in self._blocks}):
                windows = window_order(h, w, self.window, shift, device).view(-1, n)
                split = windows.shape[0]
                labels[shift] = None
                if shift:
                    lab = shift_labels(h, w, self.window, shift, device)
                    reached = (lab != lab[:, :1]).any(1)
                    first = torch.argsort(reached.to(torch.int8), stable=True)
                    split -= int(reached.sum())
                    windows = windows[first]
                    labels[shift] = lab[first[split:]].repeat(b, 1)
                tokens = windows + frames
                perm = torch.cat([tokens[:, :split].reshape(-1), tokens[:, split:].reshape(-1)])
                inv = torch.empty_like(perm)
                inv[perm] = torch.arange(perm.numel(), device=device)
                orders[shift] = (perm, inv)
            self._plan, self._plan_key = (orders, labels), key
        return self._plan

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x NHWC in [0, 1]. Its regions are the spans `g.forward`,
        `g.stem`, `g.trunk` (its blocks' `g.attn`, `g.attn_core`, `g.mlp`),
        `g.upsample` and `g.tail` (the module docstring)."""
        global trunk_calls
        b, h, w, _ = x.shape
        ws = self.window
        with span("g.forward"):
            with span("g.stem"):
                # check_image_size's reflect padding, then the mean, in f32
                lr = F.pad(x.float().permute(0, 3, 1, 2), (0, (-w) % ws, 0, (-h) % ws),
                           mode="reflect")
                lr = lr - self.mean
                feat = self.conv_first(lr.to(self.dtype).contiguous(
                    memory_format=torch.channels_last))
            with span("g.trunk"):
                trunk_calls += 1
                feat = feat + self.conv_after_body(self._trunk(feat).permute(0, 3, 1, 2))
            with span("g.upsample"):
                feat = self.conv_before_upsample(feat)
            out = hr_stage(feat, self._hr_convs, self._hr_weights, self.training)
            return out[:, :4 * h, :4 * w]

    def _trunk(self, feat: torch.Tensor) -> torch.Tensor:
        """conv_first's output (B, C, H, W), channels_last -> norm(the
        RSTBs' stream) (B, H, W, C) in the compute dtype."""
        _, _, hp, wp = feat.shape
        orders, labels = self.plan(feat.shape[0], hp, wp, feat.device)
        x = F.layer_norm(feat.permute(0, 2, 3, 1).float(), self.patch_embed.norm.normalized_shape,
                         self.patch_embed.norm.weight, self.patch_embed.norm.bias, LN_EPS)
        for layer in self.layers:
            skip = x
            for blk in layer.residual_group.blocks:
                x = blk(x, orders[blk.shift], labels[blk.shift], self.dtype)
            conv = layer.conv(x.to(self.dtype).permute(0, 3, 1, 2))
            x = skip + conv.permute(0, 2, 3, 1)
        return _norm(x, self.norm, self.dtype)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator | None = None) -> None:
    """SwinIR's init (`_init_weights`): linears and the bias tables
    trunc-normal(0.02) (a plain normal: its cut at +-2 never acts), linear
    biases 0, LayerNorms weight 1 and bias 0; convs torch's default."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            nn.init.normal_(m.weight, std=0.02, generator=generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, WindowAttention):
            nn.init.normal_(m.relative_position_bias_table, std=0.02, generator=generator)


def is_swinir_state(state: dict) -> bool:
    return MARK in state


def release_state(state: dict) -> dict:
    """A SwinIR state dict (tensors or arrays) without its derived buffers
    (`relative_position_index`, `attn_mask`), which this module
    recomputes: what `load_state_dict` takes."""
    return {k: torch.as_tensor(v) for k, v in state.items()
            if k.rsplit(".", 1)[-1] not in DERIVED}


def arch_of_state(state: dict) -> dict:
    """The constructor's arguments of a SwinIR state dict: the real-SR
    model's `nearest+conv` x4 upsampler and `1conv` RSTBs; raises on
    SwinIR's other upsamplers and residual connections."""
    if "conv_up2.weight" not in state or "conv_before_upsample.0.weight" not in state:
        raise ValueError("SwinIR: only the x4 'nearest+conv' upsampler (the real-SR model) "
                         "is served")
    if "layers.0.conv.weight" not in state:
        raise ValueError("SwinIR: only '1conv' residual connections are served")
    num_rstb = 0
    while f"layers.{num_rstb}.conv.weight" in state:
        num_rstb += 1
    depth = 0
    while f"layers.0.residual_group.blocks.{depth}.norm1.weight" in state:
        depth += 1
    block = "layers.0.residual_group.blocks.0"
    rows, heads = state[f"{block}.attn.relative_position_bias_table"].shape
    embed = int(state["conv_first.weight"].shape[0])
    return {"in_channels": int(state["conv_first.weight"].shape[1]), "embed_dim": embed,
            "num_rstb": num_rstb, "depth": depth, "heads": int(heads),
            "window": (round(rows ** 0.5) + 1) // 2,
            "mlp_ratio": int(state[f"{block}.mlp.fc1.weight"].shape[0]) / embed,
            "hr_channels": int(state["conv_up1.weight"].shape[0]), "upscale": 4}
