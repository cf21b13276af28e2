"""Ahead-of-time export of the eval generator as a serving artifact (port of
srgan_st_tpu/eval/export.py).

    python -m srgan_st_tpu_torch export \\
        --gpath results/patchwise-st/g_best.npz --out srgan_x4.srganx

    from srgan_st_tpu_torch.eval.export import load_runner
    run = load_runner("srgan_x4.srganx")      # fn(lr_nhwc01) -> sr_nhwc01
    sr = run(lr)                              # any (B, H, W, 3)

A `torch.export` program takes the place of the JAX package's StableHLO:

* **Dynamic by default**: exported with symbolic (b, h, w), so one artifact
  serves every batch and image size, odd sizes included. `--fixed BxHxW`
  pins the input shape instead.
* **Self-describing**: the file is the JAX artifact's framing (a magic
  line, an 8-byte little-endian length, a JSON header, then the program)
  with `format: "srgan-st-tpu-torch/torch.export"`; the header carries the
  upscale factor, the model's dims, the compute dtype, the device kinds the
  program was checked on (`devices`, where the JAX header has `platforms`)
  and the torch version. `inspect_artifact(path)` reads it without loading
  the program.
* **Plain versions only**: as JAX forces its portable formulations
  (conv3_inner=1), the exported generator runs the plain coarse conv
  (CONV3_INNER=1) and the composed tail, never a hand-written kernel: the
  kernels are ctypes launches, which torch.export does not trace, so the
  program needs nothing of this package to run. (Kernels registered as
  torch.library custom ops with fake implementations could be traced, but
  would tie the artifact to this package; ROADMAP.md Queue C.) On a CUDA
  device an artifact therefore runs slower than the live path, which
  launches kernels A, B and E. A dynamic export runs the unfused eval trunk
  (the JAX package falls back to it under symbolic widths); a fixed one
  keeps TPU.TRUNK_MODE's BatchNorm-folded trunk under an xpack mode and
  runs the unfused blocks under every other (`export_trunk_mode`).

The weights are baked into the program: the artifact is the complete
model. `export_generator` checks the program against the live module, bit
for bit, on a seeded input on the device it exported on (cuDNN pinned to
deterministic algorithms for that check). `load_runner` moves the program
to the device it serves on, the CUDA device unless the caller asks for
another. Loading a program unpickles its tensors: load only artifacts from
a trusted source.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re

import numpy as np
import torch

_MAGIC = b"SRGANX1\n"
FORMAT = "srgan-st-tpu-torch/torch.export"


def derive_arch(variables) -> dict:
    """Recover (channels, num_rcb, upscale) from a generator variable tree:
    conv1's kernel carries the width, the ``rcb{i}`` subtrees the depth,
    and each ``up{i}`` block's conv expands channels by r^2."""
    params = variables.get("params", variables)
    channels = int(np.asarray(params["conv1"]["kernel"]).shape[-1])
    num_rcb = sum(1 for k in params if re.fullmatch(r"rcb\d+", k))
    upscale = 1
    for k in params:
        if re.fullmatch(r"up\d+", k):
            out = int(np.asarray(params[k]["conv"]["kernel"]).shape[-1])
            upscale *= math.isqrt(out // channels)
    return {"channels": channels, "num_rcb": num_rcb, "upscale": upscale}


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN on fixed, deterministic algorithms inside the block: the
    artifact-vs-live check needs both to pick the same convolutions."""
    old = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old


class _EvalGenerator(torch.nn.Module):
    def __init__(self, g):
        super().__init__()
        self.g = g

    def forward(self, x):
        return self.g(x, train=False)


def export_trunk_mode(trunk_mode: str | None, dynamic: bool) -> str:
    """The trunk an export traces: the BatchNorm-folded trunk for a fixed-
    shape export of an xpack mode, else the unfused blocks. No mode may
    reach a hand-written kernel (the eval auto's kernel E among them): a
    ctypes launch is not traced by torch.export."""
    return trunk_mode if not dynamic and trunk_mode in ("xpack", "xpack_eval") else "unfused"


def plain_eval_generator(config, variables, dynamic: bool = True, device=None):
    """The eval generator on the plain paths an export traces: the plain
    coarse conv3 (CONV3_INNER=1), the composed tail, and the trunk of
    `export_trunk_mode`. Returns a module `fn(x) -> sr` on `device`."""
    from srgan_st_tpu_torch.core.device import compute_dtype, resolve_device
    from srgan_st_tpu_torch.models.generator import Generator
    from srgan_st_tpu_torch.train.checkpoint import generator_state_dict_from_variables

    g = Generator(in_channels=config.MODEL.G_IN_CHANNEL,
                  out_channels=config.MODEL.G_OUT_CHANNEL,
                  channels=config.MODEL.G_N_CHANNEL, num_rcb=config.MODEL.G_N_RCB,
                  upscale=config.DATA.UPSCALE_FACTOR,
                  dtype=compute_dtype(config.TPU.COMPUTE_DTYPE),
                  trunk_mode=export_trunk_mode(config.TPU.get("TRUNK_MODE"), dynamic),
                  stem_mode=config.TPU.get("STEM_MODE"), conv3_inner=1)
    g.load_state_dict(generator_state_dict_from_variables(variables))
    return _EvalGenerator(g).to(resolve_device(device)).eval()


def export_generator(config, variables, fixed_shape: tuple[int, int, int] | None = None,
                     device=None) -> tuple[bytes, dict]:
    """Export the eval generator; returns (blob, meta). `fixed_shape` =
    (B, H, W) pins the input shape; None exports symbolic (b, h, w)."""
    from torch.export import Dim
    from torch.export.passes import move_to_device_pass

    module = plain_eval_generator(config, variables, fixed_shape is None, device)
    dev = next(module.parameters()).device
    if fixed_shape is None:
        # Dim.DYNAMIC: dynamic, with the shape guards cuDNN's layout choice
        # adds kept as checks (a named Dim refuses them on some versions)
        example, spec = (2, 10, 14), "b,h,w,3"
        dims = {"x": {0: Dim.DYNAMIC, 1: Dim.DYNAMIC, 2: Dim.DYNAMIC}}
    else:
        example, spec, dims = tuple(fixed_shape), "{},{},{},3".format(*fixed_shape), None
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(*example, 3, generator=gen).to(dev)
    with torch.no_grad():
        program = torch.export.export(module, (x,), dynamic_shapes=dims)
    with torch.inference_mode(), deterministic_cudnn():
        if not torch.equal(program.module()(x), module(x)):
            raise RuntimeError(f"the exported program differs from the live generator on {dev}")
    buf = io.BytesIO()  # saved from host memory; load_runner moves it
    torch.export.save(move_to_device_pass(program, torch.device("cpu")), buf)
    meta = {
        "format": FORMAT,
        "input": f"NHWC float32 in [0,1], shape ({spec})",
        "output": "NHWC float32 in [0,1], H and W scaled by `upscale`",
        "upscale": int(config.DATA.UPSCALE_FACTOR),
        "channels": int(config.MODEL.G_N_CHANNEL),
        "num_rcb": int(config.MODEL.G_N_RCB),
        "compute_dtype": str(config.TPU.COMPUTE_DTYPE),
        "devices": [dev.type],
        "fixed_shape": list(fixed_shape) if fixed_shape else None,
        "n_params": int(sum(p.numel() for p in module.parameters())),
        "torch_version": torch.__version__,
    }
    return buf.getvalue(), meta


def save_artifact(path: str, blob: bytes, meta: dict) -> None:
    header = json.dumps(meta).encode()
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        f.write(blob)


def _read_header(f, path: str) -> dict:
    """Parse the header (magic, 8-byte LE length, JSON); leaves the file at
    the program."""
    if f.read(len(_MAGIC)) != _MAGIC:
        raise ValueError(f"{path}: not a srgan-st-tpu export artifact")
    meta = json.loads(f.read(int.from_bytes(f.read(8), "little")))
    if meta.get("format") != FORMAT:
        raise ValueError(f"{path}: a {meta.get('format')!r} artifact, not {FORMAT!r}")
    return meta


def inspect_artifact(path: str) -> dict:
    """The JSON header, without loading the program."""
    with open(path, "rb") as f:
        return _read_header(f, path)


def load_runner(path: str, device=None):
    """An artifact as a callable `fn(lr_nhwc01) -> sr` (a float32 tensor on
    `device`); `fn.meta` is its header."""
    from torch.export.passes import move_to_device_pass

    from srgan_st_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    with open(path, "rb") as f:
        meta = _read_header(f, path)
        program = torch.export.load(io.BytesIO(f.read()))
    module = move_to_device_pass(program, dev).module()

    def run(lr) -> torch.Tensor:
        with torch.inference_mode():
            return module(torch.as_tensor(lr, dtype=torch.float32, device=dev))

    run.meta = meta
    run.device = dev
    return run


def main(argv=None) -> None:
    import argparse

    from srgan_st_tpu_torch.core.config import Config
    from srgan_st_tpu_torch.train.checkpoint import load_params_npz

    parser = argparse.ArgumentParser(
        description="Export the generator as a torch.export serving artifact "
        "(dynamic shapes by default).")
    parser.add_argument("--gpath", type=str, required=True, help="generator weights (.npz)")
    parser.add_argument("--out", type=str, required=True, help="output artifact path (.srganx)")
    parser.add_argument("--upscale", type=int, default=None,
                        help="cross-check only: the factor (like the width and "
                             "depth) is derived from the weights; a mismatch errors out")
    parser.add_argument("--fixed", type=str, default=None,
                        help="pin the input shape BxHxW (default: dynamic)")
    parser.add_argument("--bf16", action="store_true", help="export the bfloat16-compute graph")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to export and check on (default cuda)")
    args = parser.parse_args(argv)

    config = Config()
    if args.bf16:
        config.TPU.COMPUTE_DTYPE = "bfloat16"
    fixed = None
    if args.fixed:
        fixed = tuple(int(v) for v in args.fixed.lower().split("x"))
        if len(fixed) != 3:
            raise SystemExit(f"--fixed expects BxHxW, got {args.fixed}")
    variables = load_params_npz(args.gpath)
    arch = derive_arch(variables)
    config.MODEL.G_N_CHANNEL = arch["channels"]
    config.MODEL.G_N_RCB = arch["num_rcb"]
    config.DATA.UPSCALE_FACTOR = arch["upscale"]
    if args.upscale is not None and args.upscale != arch["upscale"]:
        raise SystemExit(f"--upscale {args.upscale} conflicts with the checkpoint "
                         f"(x{arch['upscale']} per its upsample-block shapes)")
    blob, meta = export_generator(config, variables, fixed_shape=fixed, device=args.device)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_artifact(args.out, blob, meta)
    print(f"{args.out}: {os.path.getsize(args.out)} bytes  {json.dumps(meta)}")


if __name__ == "__main__":
    main()
