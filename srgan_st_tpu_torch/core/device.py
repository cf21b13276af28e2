"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU. With no
GPU and no explicit request for the CPU they raise: nothing falls back to
the CPU quietly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means "cuda"; a CUDA device without a usable GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def compute_dtype(name: str) -> torch.dtype:
    """Config dtype name ("float32" / "bfloat16") -> torch dtype."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if name not in dtypes:
        raise ValueError(f"unsupported compute dtype {name!r}")
    return dtypes[name]


_CONSTANTS: dict = {}


def device_constant(key, make, device, dtype=None) -> torch.Tensor:
    """The array `make()` as a tensor on `device` (in `dtype`), made once
    per (key, device, dtype) and kept. A copy from host memory in every call
    would be a pageable copy inside each step, which a CUDA graph capture
    refuses; a step's first (eager) call fills the cache before its capture.
    The tensor is shared: callers must not write to it. It is made outside
    inference mode (an inference tensor cannot enter a later autograd
    step), and one that a tracer made (a fake or functional tensor of
    torch.export) is not kept."""
    k = (key, str(torch.device(device)), dtype)
    t = _CONSTANTS.get(k)
    if t is None:
        with torch.inference_mode(False):
            t = torch.as_tensor(make(), dtype=dtype, device=device)
        if type(t) is torch.Tensor:
            _CONSTANTS[k] = t
    return t
