"""Real-ESRGAN x4plus's generator, RRDBNet (ESRGAN, arXiv:1809.00219;
Real-ESRGAN, arXiv:2107.10833; basicsr's basicsr/archs/rrdbnet_arch.py),
the port's second generator (MODEL.G_ARCH "rrdb"); eval only.

  conv_first 3x3, 3 -> nf
  body: `num_block` RRDBs, RRDB(x) = x + 0.2 RDB3(RDB2(RDB1(x))), and
    RDB(x) = x + 0.2 c5([x, x1..x4]), x_k = lrelu(c_k([x, x1..x_{k-1}])):
    c1..c4 write gc channels from nf, nf + gc, .., nf + 3 gc; c5 writes nf
    from nf + 4 gc
  feat = conv_first(x) + conv_body(body(conv_first(x)))
  two stages of nearest x2 + 3x3 conv + lrelu (conv_up1, conv_up2)
  conv_last(lrelu(conv_hr(feat))), clamped to [0, 1] (Real-ESRGAN's
    inference clamps; basicsr's forward does not)

Every conv is 3x3 with bias and SAME padding, lrelu is LeakyReLU(0.2).
The state-dict names are basicsr's, so a released state dict loads with
`load_state_dict` unchanged. No BatchNorm, no PReLU; basicsr's init
(`default_init_weights`): the RDB convs kaiming-normal x 0.1 with zero
bias, the others torch's default.

Input and output are NHWC, as `Generator`'s; inside, NCHW modules in
`torch.channels_last` memory. Parameters are float32 and cast to the
compute dtype at use.

The RRDBs run in one of two ways. In eval without gradients on a CUDA
bf16 activation at the published widths (nf 64, gc 32: kernels/rrdb_dense.py
`gate`), as kernel R (csrc/rrdb_dense.cu), one call of 1 + 15 n launches:
each dense block's features in one zero-bordered buffer (planes of 8
channels) whose channel prefixes its convs read in place, the bias,
LeakyReLU and both 0.2-scaled residuals in the convs' f32 epilogues, one
rounding a conv. Everywhere else (float32,
the CPU, other widths, gradients) as the modules below: the dense
concatenation is `torch.cat` of each conv's input in channels_last memory
(cuDNN takes a dense NHWC operand, so a channel prefix of one wider buffer
would be copied to a dense tensor before each conv anyway: the layout probe in PERF.md §4).
conv_body and the global skip stay torch ops on both paths. Each call of
the dense trunk adds one to `trunk_calls` (`kernels.launch_counts()`'s
"rrdb_trunk"), and each kernel R call one to "rrdb_dense".

The HR stage likewise: under kernels/rrdb_hr.py's `gate` (eval, no
gradient, CUDA, bf16, nf 64, 3 outputs) as kernel H (csrc/rrdb_hr.cu),
one call in `g.upsample` (both nearest x2 stages, the nearest x2 folded
into each conv's read) and one in `g.tail` (conv_hr, conv_last and the
clamp, the float32 frame written by the kernel), each counted in
"rrdb_hr"; everywhere else as the modules below."""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from srgan_st_tpu_torch.utils.profiling import span

SLOPE = 0.2
RES_SCALE = 0.2
# the key a state dict of this architecture has and SRResNet's has not
MARK = "body.0.rdb1.conv1.weight"

# calls of the dense trunk (`g.trunk`) since import or the last reset
trunk_calls = 0


class Conv3x3(nn.Conv2d):
    """3x3 SAME conv whose float32 weight and bias are cast to the input's
    dtype at use; the bias is added by the convolution itself."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), 1, 1)


def lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, SLOPE, inplace=True)


class ResidualDenseBlock(nn.Module):
    """basicsr's ResidualDenseBlock: five 3x3 convs, each reading every
    feature before it."""

    def __init__(self, nf: int, gc: int):
        super().__init__()
        for k in range(1, 5):
            setattr(self, f"conv{k}", Conv3x3(nf + (k - 1) * gc, gc))
        self.conv5 = Conv3x3(nf + 4 * gc, nf)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = x
        for conv in (self.conv1, self.conv2, self.conv3, self.conv4):
            feats = torch.cat([feats, lrelu(conv(feats))], 1)
        return torch.add(x, self.conv5(feats), alpha=RES_SCALE)


class RRDB(nn.Module):
    def __init__(self, nf: int, gc: int):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(nf, gc)
        self.rdb2 = ResidualDenseBlock(nf, gc)
        self.rdb3 = ResidualDenseBlock(nf, gc)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.add(x, self.rdb3(self.rdb2(self.rdb1(x))), alpha=RES_SCALE)


class RRDBNet(nn.Module):
    """RRDBNet x4. Input NHWC in [0, 1]; output NHWC float32 in [0, 1]."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3, channels: int = 64,
                 num_block: int = 23, growth: int = 32, upscale: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if upscale != 4:
            raise ValueError(f"the RRDB generator is x4 only, got upscale {upscale}")
        self.dtype = dtype
        self.conv_first = Conv3x3(in_channels, channels)
        self.body = nn.Sequential(*[RRDB(channels, growth) for _ in range(num_block)])
        self.conv_body = Conv3x3(channels, channels)
        self.conv_up1 = Conv3x3(channels, channels)
        self.conv_up2 = Conv3x3(channels, channels)
        self.conv_hr = Conv3x3(channels, channels)
        self.conv_last = Conv3x3(channels, out_channels)
        init_weights(self)
        self.to(memory_format=torch.channels_last)
        # kernel R's operands, laid out again only when a parameter changes
        from srgan_st_tpu_torch.kernels.rrdb_dense import RRDBDenseWeights
        from srgan_st_tpu_torch.kernels.rrdb_hr import RRDBHRWeights

        self._dense_weights = RRDBDenseWeights()
        self._dense_convs = [conv for rrdb in self.body for rdb in rrdb.children()
                             for conv in rdb.children()]
        # kernel H's operands, the same way
        self._hr_weights = RRDBHRWeights()
        self._hr_convs = [self.conv_up1, self.conv_up2, self.conv_hr, self.conv_last]
        self.growth = growth

    @classmethod
    def from_config(cls, config, dtype: torch.dtype | None = None) -> "RRDBNet":
        """MODEL.G_N_CHANNEL is num_feat, MODEL.G_N_RCB the RRDBs,
        MODEL.G_N_GROW the growth width."""
        from srgan_st_tpu_torch.core.device import compute_dtype

        m = config.MODEL
        return cls(in_channels=m.G_IN_CHANNEL, out_channels=m.G_OUT_CHANNEL,
                   channels=m.G_N_CHANNEL, num_block=m.G_N_RCB, growth=m.G_N_GROW,
                   upscale=config.DATA.UPSCALE_FACTOR,
                   dtype=dtype or compute_dtype(config.TPU.COMPUTE_DTYPE))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x NHWC in [0, 1]. Its regions are the spans `g.forward`,
        `g.stem` (conv_first), `g.trunk` (the RRDBs, conv_body and the
        skip), `g.upsample` (both nearest + conv + lrelu stages) and
        `g.tail` (conv_hr, lrelu, conv_last and the clamp)."""
        global trunk_calls
        with span("g.forward"):
            x = x.to(self.dtype).permute(0, 3, 1, 2)
            with span("g.stem"):
                feat = self.conv_first(x)
            with span("g.trunk"):
                trunk_calls += 1
                feat = feat + self.conv_body(self._body(feat))
            return self._hr_stage(feat)

    def _hr_stage(self, feat: torch.Tensor) -> torch.Tensor:
        """The HR stage on the NCHW trunk output, NHWC float32 out: kernel
        H where its gate holds, one call in each region, else the modules."""
        from srgan_st_tpu_torch.kernels import rrdb_hr as H

        if H.gate(self.training, torch.is_grad_enabled(), feat.device.type, feat.dtype,
                  feat.shape[1], self.conv_last.out_channels):
            with span("g.upsample"):
                ws, bs, laid = self._hr_weights.get(
                    [(c._parameters["weight"], c._parameters["bias"]) for c in self._hr_convs])
                up = H.rrdb_hr_upsample(feat.permute(0, 2, 3, 1).contiguous(), ws, bs, SLOPE,
                                        laid)
            with span("g.tail"):
                return H.rrdb_hr_tail(up, ws, bs, SLOPE, laid)
        with span("g.upsample"):
            for conv in (self.conv_up1, self.conv_up2):
                feat = lrelu(conv(F.interpolate(feat, scale_factor=2, mode="nearest")))
        with span("g.tail"):
            out = self.conv_last(lrelu(self.conv_hr(feat)))
            return torch.clamp(out.float(), 0.0, 1.0).permute(0, 2, 3, 1)

    def _body(self, feat: torch.Tensor) -> torch.Tensor:
        """The RRDBs on the NCHW stem output: kernel R where its gate holds,
        else the modules."""
        from srgan_st_tpu_torch.kernels import rrdb_dense as R

        if not R.gate(self.training, torch.is_grad_enabled(), feat.device.type, feat.dtype,
                      feat.shape[1], self.growth):
            return self.body(feat)
        # the tensors read from the modules' dicts: the cache's key is read
        # every frame, and Module.__getattr__ would cost more than the check
        ws, bs, laid = self._dense_weights.get(
            [(c._parameters["weight"], c._parameters["bias"]) for c in self._dense_convs])
        y = R.rrdb_dense(feat.permute(0, 2, 3, 1).contiguous(), ws, bs, SLOPE, RES_SCALE, laid)
        return y.permute(0, 3, 1, 2)


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator | None = None) -> None:
    """basicsr's init: torch's default for every conv, then each RDB conv
    kaiming-normal (fan_in, gain sqrt 2) x 0.1 with a zero bias."""
    for m in module.modules():
        if isinstance(m, ResidualDenseBlock):
            for conv in m.children():
                nn.init.kaiming_normal_(conv.weight, generator=generator)
                conv.weight.mul_(0.1)
                nn.init.zeros_(conv.bias)


def is_rrdb_state(state: dict) -> bool:
    return MARK in state


def arch_of_state(state: dict) -> dict:
    """(channels, num_block, growth, in and out channels) of an RRDBNet
    state dict; its upscale is 4."""
    blocks = 0
    while f"body.{blocks}.rdb1.conv1.weight" in state:
        blocks += 1
    first, last = state["conv_first.weight"], state["conv_last.weight"]
    return {"channels": int(first.shape[0]), "num_block": blocks,
            "growth": int(state[MARK].shape[0]), "in_channels": int(first.shape[1]),
            "out_channels": int(last.shape[0]), "upscale": 4}


def receptive_radius(num_block: int) -> int:
    """The LR pixels on each side that one output pixel of the x4 net
    depends on: conv_first (1), 3 RDBs of 5 chained convs an RRDB (15),
    conv_body (1), and the HR stage's 2: conv_up1 at 2x and conv_up2,
    conv_hr, conv_last at 4x (after two nearest x2, the exact rows of LR
    rows [a, b] are HR rows [4a + 5, 4b - 2], whole LR rows [a + 2, b - 2])."""
    return 1 + 15 * num_block + 1 + 2
