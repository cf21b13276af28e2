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
