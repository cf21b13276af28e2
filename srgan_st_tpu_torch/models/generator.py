"""SRResNet generator (port of srgan_st_tpu/models/generator.py).

Architecture parity with reference model.py:74-184: 9x9 conv + PReLU head,
`num_rcb` residual conv blocks (conv3x3-BN-PReLU-conv3x3-BN + identity), a
3x3 conv + BN fusion layer, global skip-add back to the head activations,
sub-pixel upsample blocks (conv3x3 to channels*r^2 + PReLU + pixel-shuffle),
a 9x9 reconstruction conv and a clamp to [0, 1].

Input and output are NHWC, as in the JAX package. Inside, the NCHW modules
run in `torch.channels_last` memory format, so the activation that reaches
a kernel is already NHWC in memory. The state_dict keys are the
reference's (`conv1.0.weight`, `trunk.{i}.rcb.{0..4}`,
`upsampling.{i}.upsample_block.{0,2}`, `conv3.*`; see
tests/reference_impls.py TorchSRResNet). Parameters are float32 and cast
to the compute dtype at use, as the JAX package's are.

`forward(x, train=True)` normalizes with batch statistics and updates the
running statistics in place (the JAX package's mutable batch_stats); with
a data-parallel `group` of several processes, over the global batch
(sync-BN) or, under `local_bn`, per process with a global-moment EMA. The
trunk then runs as per-block modules ("unfused") or, with
trunk_mode="packed" (the auto in a bf16 train step) inside its gate,
through the hand-written K4/K5 kernels (kernels/packed_trunk.py); "hybrid"
is the plain forward with the K5 backward; "fused", in any train step, runs
the K6 forward and its torch backward (kernels/fused_trunk.py); "xpack"
is "packed" in training and, in eval, kernels/xpack_trunk.py's trunk with
each BatchNorm folded into its conv. In eval without gradients, a CUDA bf16
64-channel trunk under the auto or "packed", "hybrid" or "fused" runs the
whole `g.trunk` region (blocks, fusion layer, global skip) as kernel E
(kernels/eval_trunk.py), one call a frame; an explicit "unfused" keeps the
blocks. The last upsample block's shuffle is elided and the
reconstruction conv runs on its pre-shuffle activation
(conv2d_subpixel_pre_shuffled), through the hand-written coarse conv kernel
by default; TAIL_MODE="fused" runs the last up-conv, PReLU and conv3 as one
kernel in eval (kernels/serving_tail.py). With `remat` (TPU.REMAT) each
residual block of the unfused trunk runs under torch.utils.checkpoint
(`remat_block`), as the JAX package's `nn.remat`; the kernel trunks keep
their saved residuals.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn

from srgan_st_tpu_torch.models.common import (
    BatchNorm, Conv2d, PReLU, TapConv, init_weights, pixel_shuffle, set_data_parallel,
)
from srgan_st_tpu_torch.utils.profiling import span

_TRUNK_MODES = ("unfused", "packed", "hybrid", "fused", "xpack", "xpack_eval")


class ResidualConvBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.rcb = nn.Sequential(
            Conv2d(channels, channels, 3, 1, 1, bias=False),
            BatchNorm(channels),
            PReLU(),
            Conv2d(channels, channels, 3, 1, 1, bias=False),
            BatchNorm(channels),
        )

    def forward(self, x, train: bool = False, update_stats: bool = True):
        conv1, bn1, prelu, conv2, bn2 = self.rcb
        h = prelu(bn1(conv1(x), train, update_stats))
        return bn2(conv2(h), train, update_stats) + x


def remat_block(block: ResidualConvBlock, x: torch.Tensor, train: bool) -> torch.Tensor:
    """`block(x, train)` under torch.utils.checkpoint (non-reentrant): its
    activations are recomputed in the backward instead of saved, as the JAX
    package's `nn.remat` of the block (generator.py:264-272). The
    recomputation leaves the BatchNorm running statistics alone, so they
    move once a step, as without remat."""
    from torch.utils.checkpoint import checkpoint

    calls = []

    def run(h):
        out = block(h, train, update_stats=not calls)
        calls.append(1)
        return out

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


def stack_rcb_params(blocks) -> tuple:
    """The residual blocks' parameters stacked as the trunk kernels take
    them (kernels/fused_trunk.py stack_rcb_params): conv kernels
    (n, 3, 3, C, C) HWIO, BN scales and biases (n, C), PReLU slopes (n,).
    Differentiable: gradients flow back to each block's parameters."""
    rcbs = [blk.rcb for blk in blocks]
    hwio = lambda i: torch.stack([r[i].weight for r in rcbs]).permute(0, 3, 4, 2, 1)  # noqa: E731
    vec = lambda i, name: torch.stack([getattr(r[i], name) for r in rcbs])  # noqa: E731
    return (hwio(0), hwio(3), vec(1, "weight"), vec(1, "bias"), vec(4, "weight"),
            vec(4, "bias"), torch.cat([r[2].weight for r in rcbs]))


class UpsampleBlock(nn.Module):
    """conv3x3 to channels*r^2 + PReLU + pixel-shuffle. PReLU runs before
    the shuffle: its single shared slope commutes with it. With
    `fuse_shuffle` the block returns the PRE-shuffle activation (the
    consumer elides the matching space-to-depth)."""

    def __init__(self, channels: int, upscale_factor: int,
                 fuse_shuffle: bool = False):
        super().__init__()
        r = upscale_factor
        self.upscale_factor = r
        self.fuse_shuffle = fuse_shuffle
        self.upsample_block = nn.Sequential(
            Conv2d(channels, channels * r * r, 3, 1, 1),
            nn.PixelShuffle(r),
            PReLU(),
        )

    def forward(self, x):
        """x: NCHW (channels_last)."""
        x = self.upsample_block[2](self.upsample_block[0](x))
        if self.fuse_shuffle:
            return x
        x = pixel_shuffle(x.permute(0, 2, 3, 1), self.upscale_factor)
        return x.permute(0, 3, 1, 2)


class Generator(nn.Module):
    """SRResNet. Input NHWC in [0, 1]; output NHWC float32 in [0, 1].

    The parameters are float32 and every module casts them to the compute
    dtype `dtype` at use, as the JAX package does. Weights are initialized
    as the reference's (kaiming-normal convs, zero biases)."""

    def __init__(self, in_channels: int = 3, out_channels: int = 3,
                 channels: int = 64, num_rcb: int = 16, upscale: int = 4,
                 dtype: torch.dtype = torch.float32,
                 trunk_mode: str | None = None, stem_mode: str | None = None,
                 conv3_mode: str | None = None,
                 conv3_inner: int | str | None = None,
                 tail_mode: str | None = None, group=None, local_bn: bool = False,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.channels = channels
        self.out_channels = out_channels
        self.upscale = upscale
        self.dtype = dtype
        if trunk_mode is not None and trunk_mode not in _TRUNK_MODES:
            raise ValueError(f"unknown trunk_mode {trunk_mode!r}")
        self.trunk_mode = trunk_mode
        self.tail_mode = tail_mode
        # the fused tail kernel's weight layouts, rebuilt only when a
        # parameter changes
        from srgan_st_tpu_torch.kernels.serving_tail import TailWeights

        self._tail_weights = TailWeights()
        # kernel E's operands of the eval trunk, likewise
        from srgan_st_tpu_torch.kernels.eval_trunk import EvalTrunkWeights

        self._eval_trunk_weights = EvalTrunkWeights()
        factors = self._up_factors()
        # conv3_mode None: the last block's pixel-shuffle and the
        # reconstruction conv's space-to-depth are exact inverses, so both
        # are elided (ops/subpixel_conv.py conv2d_subpixel_pre_shuffled)
        self.fuse = conv3_mode is None

        if stem_mode == "s2d":
            stem = TapConv(in_channels, channels, 9, subpixel_factor=4)
        else:
            stem = TapConv(in_channels, channels, 9, mode="xla")
        self.conv1 = nn.Sequential(stem, PReLU())
        self.trunk = nn.Sequential(*[ResidualConvBlock(channels) for _ in range(num_rcb)])
        self.conv2 = nn.Sequential(
            Conv2d(channels, channels, 3, 1, 1, bias=False), BatchNorm(channels))
        # kernel E's modules in its order: conv1_j, conv2_j of each block and
        # the fusion conv, their BatchNorms, the blocks' PReLUs
        self._eval_trunk_modules = (
            [m for blk in self.trunk for m in (blk.rcb[0], blk.rcb[3])] + [self.conv2[0]],
            [m for blk in self.trunk for m in (blk.rcb[1], blk.rcb[4])] + [self.conv2[1]],
            [blk.rcb[2] for blk in self.trunk])
        self.upsampling = nn.Sequential(*[
            UpsampleBlock(channels, r, fuse_shuffle=self.fuse and i == len(factors) - 1)
            for i, r in enumerate(factors)
        ])
        self.conv3 = TapConv(
            channels, out_channels, 9, mode=conv3_mode,
            pre_shuffle_factor=factors[-1] if self.fuse else 0,
            inner_factor=conv3_inner)
        init_weights(self)
        self.to(memory_format=torch.channels_last)
        # across processes: sync-BN, or per-rank normalization (local_bn)
        self.group = group
        self.local_bn = local_bn
        set_data_parallel(self, group, local_bn)

    @classmethod
    def from_config(cls, config, dtype: torch.dtype | None = None,
                    group=None) -> "Generator":
        from srgan_st_tpu_torch.core.device import compute_dtype

        return cls(
            in_channels=config.MODEL.G_IN_CHANNEL,
            out_channels=config.MODEL.G_OUT_CHANNEL,
            channels=config.MODEL.G_N_CHANNEL,
            num_rcb=config.MODEL.G_N_RCB,
            upscale=config.DATA.UPSCALE_FACTOR,
            dtype=dtype or compute_dtype(config.TPU.COMPUTE_DTYPE),
            trunk_mode=config.TPU.get("TRUNK_MODE"),
            stem_mode=config.TPU.get("STEM_MODE"),
            conv3_inner=config.TPU.get("CONV3_INNER"),
            tail_mode=config.TPU.get("TAIL_MODE"),
            group=group,
            local_bn=bool(config.TPU.get("LOCAL_BN")),
            remat=bool(config.TPU.get("REMAT")),
        )

    def _up_factors(self):
        if self.upscale in (2, 4, 8):
            return [2] * int(math.log2(self.upscale))
        if self.upscale == 3:
            return [3]
        raise ValueError(f"unsupported upscale factor {self.upscale}")

    def _use_fused_tail(self, x, r: int) -> bool:
        """Dispatch gate of the fused serving tail: explicit opt-in
        (tail_mode="fused"), the conv3 fusion active, a x2 last block, and
        the kernel's shape gate (serving_tail.fits_budget). x: NCHW."""
        if self.tail_mode != "fused" or not self.fuse or r != 2:
            return False
        from srgan_st_tpu_torch.kernels.serving_tail import fits_budget

        _, c, h, w = x.shape
        return fits_budget(h, w, c, self.channels * 4, self.out_channels)

    def _fused_tail(self, x, i: int):
        """The fused tail kernel on the composed path's own parameters.
        x: NCHW (channels_last) input of the last upsample block."""
        from srgan_st_tpu_torch.kernels.serving_tail import serving_tail

        up = self.upsampling[i].upsample_block
        # the parameters as HWIO views, cast in the plain path; the kernel
        # reads its layouts of them from self._tail_weights
        out = serving_tail(
            x.permute(0, 2, 3, 1), up[0].weight.permute(2, 3, 1, 0), up[0].bias,
            up[2].weight, self.conv3.weight.permute(2, 3, 1, 0), self.conv3.bias,
            self._tail_weights)
        return torch.clamp(out.float(), 0.0, 1.0)

    def _packed_ok(self, x: torch.Tensor) -> bool:
        """Gate of the K4/K5 trunk (generator.py:164-189): bf16, even W, C a
        multiple of 64 (packed_trunk.fits). The JAX gate's multi-device
        condition (LOCAL_BN) is in _trunk_mode; its VMEM cap is a TPU budget
        with no counterpart. x: NHWC."""
        from srgan_st_tpu_torch.kernels.packed_trunk import fits

        return x.dtype == torch.bfloat16 and fits(x.shape, x.dtype)

    def _trunk_mode(self, train: bool, x: torch.Tensor) -> str:
        """The trunk path (the JAX package's generator.py:191-262). Auto is
        "packed" (the K4/K5 kernels) in a bf16 train step, where the JAX
        package's auto is xpack, and "unfused" otherwise: paired on the
        H100, a packed GAN step took 0.52-0.61 (Adversarial) and 0.66-0.70
        (run job 0) of an unfused one (PERF.md, "Where the time goes"). In
        a train step "xpack" is "packed": the JAX xpack trunk is K4/K5's
        function in a TPU lane layout. In eval, "eval" (kernel E, the whole
        `g.trunk` region in one call) wherever kernels/eval_trunk.py's
        `gate` holds: no gradient, a CUDA bf16 activation of 64 channels,
        and the auto, "packed", "hybrid" or "fused" (the JAX package's eval
        auto is the unfused blocks, its folded trunk opt-in); an explicit "xpack"
        takes the BatchNorm-folded trunk and every other case the unfused
        blocks (the training kernel trunks have no eval mode);
        "xpack_eval" is eval only and takes even widths, as the JAX
        Generator does; "packed" and "hybrid" run inside the K4/K5 gate,
        "fused" at any dtype and shape (on CUDA its kernel raises on what
        it does not take). With more than one process the kernel trunks run
        only under LOCAL_BN: sync-BN needs the unfused blocks' cross-rank
        moments. Elsewhere: unfused."""
        from srgan_st_tpu_torch.kernels import eval_trunk

        if train and self.trunk_mode == "xpack_eval":
            raise ValueError(
                "trunk_mode='xpack_eval' is an eval-only formulation; use "
                "trunk_mode='xpack' (eval resolves it to the BN-folded eval "
                "trunk automatically)")
        if not train:
            if self.trunk_mode in ("xpack", "xpack_eval"):
                return "unfused" if x.shape[2] % 2 else "xpack_eval"
            if eval_trunk.gate(train, torch.is_grad_enabled(), x.device.type, x.dtype,
                               x.shape[-1], self.trunk_mode):
                return "eval"
            return "unfused"
        mode = self.trunk_mode or ("packed" if self.dtype == torch.bfloat16 else "unfused")
        if mode == "xpack":
            mode = "packed"
        if mode != "unfused" and self.group is not None and self.group.active \
                and not self.local_bn:
            # the kernel trunks normalize with the batch moments they compute
            # per rank; sync-BN needs the unfused blocks' cross-rank mean.
            # Auto falls back, a forced kernel trunk is an error
            # (generator.py:243-257)
            if self.trunk_mode is not None:
                raise ValueError(
                    f"trunk_mode={self.trunk_mode!r} computes per-rank batch stats in "
                    "its kernels; with more than one process it requires "
                    "TPU.LOCAL_BN=True or trunk_mode='unfused'")
            return "unfused"
        if mode in ("packed", "hybrid") and not self._packed_ok(x):
            return "unfused"
        return mode

    def _eval_trunk_operands(self) -> tuple:
        """Kernel E's operands of the blocks' own parameters and running
        statistics (kernels/eval_trunk.py `EvalTrunkWeights`), laid out
        once per parameter version."""
        convs, bns, prelus = self._eval_trunk_modules
        # the tensors read from the modules' dicts: the cache's key is read
        # every frame, and Module.__getattr__ would cost more than the check
        return self._eval_trunk_weights.get(
            [c._parameters["weight"] for c in convs],
            [(b._parameters["weight"], b._parameters["bias"], b._buffers["running_mean"],
              b._buffers["running_var"]) for b in bns],
            [a._parameters["weight"] for a in prelus], bns[0].eps)

    def _eval_trunk(self, x: torch.Tensor) -> torch.Tensor:
        """The `g.trunk` region in eval as kernel E. x: the NHWC stem
        output; NHWC out."""
        from srgan_st_tpu_torch.kernels.eval_trunk import eval_trunk

        return eval_trunk(x.contiguous(), *self._eval_trunk_operands())

    def _trunk(self, x: torch.Tensor, train: bool, mode: str) -> torch.Tensor:
        """The residual trunk on NHWC x in `mode` (not "eval"); NHWC out.
        Every path but the unfused blocks reads the blocks' parameters
        stacked, and in a train step feeds the batch moments it returns to
        the running-stat EMA."""
        if mode == "unfused":
            h = x.permute(0, 3, 1, 2)
            remat = self.remat and torch.is_grad_enabled()
            for blk in self.trunk:
                h = remat_block(blk, h, train) if remat else blk(h, train)
            return h.permute(0, 2, 3, 1)
        from srgan_st_tpu_torch.kernels.fused_trunk import fused_trunk
        from srgan_st_tpu_torch.kernels.packed_trunk import hybrid_trunk, packed_trunk
        from srgan_st_tpu_torch.kernels.xpack_trunk import xpack_trunk_eval

        operands = stack_rcb_params(self.trunk)
        if mode == "xpack_eval":  # the running statistics m1s, v1s, m2s, v2s
            running = [torch.stack([getattr(blk.rcb[i], name) for blk in self.trunk])
                       for i in (1, 4) for name in ("running_mean", "running_var")]
            return xpack_trunk_eval(x, *operands, *running, 1e-5)
        fn = {"fused": fused_trunk, "hybrid": hybrid_trunk, "packed": packed_trunk}[mode]
        y, stats = fn(x.contiguous(), *operands, 1e-5)
        nelem = x.numel() // x.shape[-1]
        if self.group is not None and self.group.active:
            # LOCAL_BN: the EMA takes the global moments, the variance from
            # the global E[x^2] (not an average of per-rank variances)
            m, v = stats[:, 0::2], stats[:, 1::2]
            gm, ge2 = self.group.pmean([torch.stack([m, v + m * m])])[0]
            stats = torch.stack([gm, torch.clamp(ge2 - gm * gm, min=0.0)], 2).flatten(1, 2)
            nelem *= self.group.world_size
        for i, blk in enumerate(self.trunk):
            blk.rcb[1].update_running(stats[i, 0], stats[i, 1], nelem)
            blk.rcb[4].update_running(stats[i, 2], stats[i, 3], nelem)
        return y

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """x NHWC in [0, 1]. train=True: batch statistics, running
        statistics updated in place. Its regions are the spans `g.forward`,
        `g.stem`, `g.trunk` (the trunk, the fusion layer and the global
        skip), `g.upsample` and `g.tail` (conv3, or kernel B, and the
        clamp)."""
        with span("g.forward"):
            x = x.to(self.dtype)

            # Low-frequency information extraction layer (model.py:100-103)
            with span("g.stem"):
                conv1 = self.conv1[1](self.conv1[0](x))

            # High-frequency trunk + linear fusion layer + global skip
            with span("g.trunk"):
                mode = self._trunk_mode(train, conv1)
                if mode == "eval":
                    h = self._eval_trunk(conv1).permute(0, 3, 1, 2)
                else:
                    h = self._trunk(conv1, train, mode).permute(0, 3, 1, 2)
                    conv_fuse, bn_fuse = self.conv2
                    h = bn_fuse(conv_fuse(h), train) + conv1.permute(0, 3, 1, 2)

            # Sub-pixel zoom blocks (model.py:118-124)
            factors = self._up_factors()
            fused_tail = None
            with span("g.upsample"):
                for i, r in enumerate(factors):
                    if i == len(factors) - 1 and not train and self._use_fused_tail(h, r):
                        fused_tail = i
                        break
                    h = self.upsampling[i](h)

            # Reconstruction (model.py:127) + clamp (model.py:150)
            with span("g.tail"):
                if fused_tail is not None:
                    return self._fused_tail(h, fused_tail)
                out = self.conv3(h.permute(0, 2, 3, 1))
                return torch.clamp(out.float(), 0.0, 1.0)


def random_variables(seed: int, channels: int = 64, num_rcb: int = 16,
                     upscale: int = 4, in_channels: int = 3,
                     out_channels: int = 3) -> dict:
    """Seeded random generator weights as a JAX-format variables tree of
    float32 numpy arrays ({"params", "batch_stats"}; load with
    train/checkpoint.py generator_state_dict_from_variables).

    Kernels are drawn N(0, 1/fan_in), BN statistics and affine terms near
    identity, and conv3 is halved with a 0.5 bias, so that most of the
    output of an image in [0, 1] lies inside (0, 1) and the final clamp
    hides little: weights for parity tests and smoke runs, not a trained
    model."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def conv(k, cin, cout, bias=True, scale=1.0):
        std = scale / np.sqrt(k * k * cin)
        tree = {"kernel": (rng.standard_normal((k, k, cin, cout)) * std).astype(f32)}
        if bias:
            tree["bias"] = (0.1 * rng.standard_normal(cout)).astype(f32)
        return tree

    def prelu():
        return {"alpha": f32(rng.uniform(0.1, 0.3))}

    def bn():
        return ({"scale": rng.uniform(0.5, 1.0, channels).astype(f32),
                 "bias": (0.1 * rng.standard_normal(channels)).astype(f32)},
                {"mean": (0.1 * rng.standard_normal(channels)).astype(f32),
                 "var": rng.uniform(0.5, 1.5, channels).astype(f32)})

    params = {"conv1": conv(9, in_channels, channels), "prelu1": prelu()}
    stats = {}
    for i in range(num_rcb):
        (p1, s1), (p2, s2) = bn(), bn()
        params[f"rcb{i}"] = {"conv1": conv(3, channels, channels, bias=False),
                             "bn1": p1, "prelu": prelu(),
                             "conv2": conv(3, channels, channels, bias=False),
                             "bn2": p2}
        stats[f"rcb{i}"] = {"bn1": s1, "bn2": s2}
    params["conv2"] = conv(3, channels, channels, bias=False)
    params["bn2"], stats["bn2"] = bn()
    factors = [3] if upscale == 3 else [2] * int(math.log2(upscale))
    for i, r in enumerate(factors):
        params[f"up{i}"] = {"conv": conv(3, channels, channels * r * r),
                            "prelu": prelu()}
    params["conv3"] = conv(9, channels, out_channels, scale=0.5)
    params["conv3"]["bias"] = np.full(out_channels, 0.5, f32)
    return {"params": params, "batch_stats": stats}


GENERATOR_ARCHS = ("srresnet", "rrdb", "swinir")


def build_generator(config, dtype: torch.dtype | None = None) -> nn.Module:
    """The generator MODEL.G_ARCH names: SRResNet (`Generator.from_config`),
    Real-ESRGAN's RRDBNet (models/rrdb.py) or SwinIR (models/swinir.py);
    the last two eval only."""
    arch = config.MODEL.get("G_ARCH", "srresnet")
    if arch == "srresnet":
        return Generator.from_config(config, dtype)
    if arch == "rrdb":
        from srgan_st_tpu_torch.models.rrdb import RRDBNet

        return RRDBNet.from_config(config, dtype)
    if arch == "swinir":
        from srgan_st_tpu_torch.models.swinir import SwinIR

        return SwinIR.from_config(config, dtype)
    raise ValueError(f"MODEL.G_ARCH={arch!r}: expected one of {GENERATOR_ARCHS}")
