"""Hand-written Hopper kernels of the port, with their plain versions.

| module | CUDA source | replaces (Pallas, srgan_st_tpu/kernels/) |
|---|---|---|
| coarse_conv.py  | csrc/coarse_conv.cu  | coarse_conv.py `_kernel`, `_kernel_tiled` |
| serving_tail.py | csrc/serving_tail.cu | serving_tail.py `_kernel` |
| packed_trunk.py | csrc/packed_trunk.cu | packed_trunk.py `_fwd_kernel`, `_bwd_kernel` |
| fused_trunk.py  | csrc/fused_trunk.cu  | fused_trunk.py `_kernel` |
| buddy_select.py | csrc/buddy_select.cu | buddy_select.py `_buddy_kernel` |
| eval_trunk.py   | csrc/eval_trunk.cu   | none: the eval trunk, plain XLA there (kernel E) |
| rrdb_dense.py   | csrc/rrdb_dense.cu   | none: Real-ESRGAN's dense trunk, no JAX counterpart (kernel R) |
| rrdb_hr.py      | csrc/rrdb_hr.cu      | none: Real-ESRGAN's HR stage, no JAX counterpart (kernel H) |
| swin_attn.py    | csrc/swin_attn.cu    | none: SwinIR's window attention core, no JAX counterpart (kernel W) |

Each wrapper counts its launches in a module-level integer; a replay of a
captured CUDA graph adds the launches made while it was captured
(`add_launch_counts`). Beside them, "rrdb_trunk" counts the calls of
models/rrdb.py's dense trunk, whatever computes it (kernel R, counted
as "rrdb_dense", or the torch blocks), and "swin_trunk" and
"window_attn" the calls of models/swinir.py's trunk and of its window
attention core, whatever computes it (kernel W, counted as "swin_attn",
or its plain version; kernel H counts SwinIR's HR stage too). xpack_trunk.py has no kernel: the
JAX module it ports is plain XLA, so its eval trunk is plain torch, and
its training trunk is packed_trunk.py's.
"""


# Replays of captured CUDA graphs since import (train/graphs.py). A replay
# updates parameters in place without bumping their `_version`, so the
# weight-layout caches (coarse_conv.KernelWeights, serving_tail.TailWeights)
# key on this generation too.
generation = 0

# launches made by graph replays, by `launch_counts` name: a replay adds the
# launches its graph recorded at capture (they are in `launch_counts` too)
_replayed: dict[str, int] = {}

_COUNTERS = {"coarse_conv_s2d": ("coarse_conv", "launches"),
             "serving_tail": ("serving_tail", "launches"),
             "packed_trunk_fwd": ("packed_trunk", "fwd_launches"),
             "packed_trunk_bwd": ("packed_trunk", "bwd_launches"),
             "fused_trunk": ("fused_trunk", "launches"),
             "buddy_select": ("buddy_select", "launches"),
             "eval_trunk": ("eval_trunk", "launches"),
             "rrdb_dense": ("rrdb_dense", "launches"),
             "rrdb_hr": ("rrdb_hr", "launches"),
             "swin_attn": ("swin_attn", "launches"),
             "rrdb_trunk": ("srgan_st_tpu_torch.models.rrdb", "trunk_calls"),
             "swin_trunk": ("srgan_st_tpu_torch.models.swinir", "trunk_calls"),
             "window_attn": ("srgan_st_tpu_torch.models.swinir", "attn_calls")}


def _module(name: str):
    """A kernel wrapper of this package by its name, or a module by its
    full name."""
    import importlib

    return importlib.import_module(name if "." in name else f"srgan_st_tpu_torch.kernels.{name}")


def reset_launch_counts() -> None:
    for module, attr in _COUNTERS.values():
        setattr(_module(module), attr, 0)
    _replayed.clear()


def launch_counts() -> dict[str, int]:
    """Executed launches of each kernel (kernels E, R, H and W: calls), eager
    calls and graph replays, the dense trunk's calls ("rrdb_trunk") and
    SwinIR's trunk and attention-core calls ("swin_trunk", "window_attn")."""
    return {name: getattr(_module(module), attr) for name, (module, attr) in _COUNTERS.items()}


def graph_launch_counts() -> dict[str, int]:
    """The part of `launch_counts` that graph replays made."""
    return {name: _replayed.get(name, 0) for name in _COUNTERS}


def add_launch_counts(delta: dict[str, int], replayed: bool = False) -> None:
    """Add `delta` to the counters: a graph's capture takes back the
    launches its capture counted (nothing ran), each replay adds them
    (`replayed`)."""
    for name, n in delta.items():
        module, attr = _COUNTERS[name]
        mod = _module(module)
        setattr(mod, attr, getattr(mod, attr) + n)
        if replayed:
            _replayed[name] = _replayed.get(name, 0) + n
