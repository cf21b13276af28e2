"""Hand-written Hopper kernels of the port, with their plain versions.

| module | CUDA source | replaces (Pallas, srgan_st_tpu/kernels/) |
|---|---|---|
| coarse_conv.py  | csrc/coarse_conv.cu  | coarse_conv.py `_kernel`, `_kernel_tiled` |
| serving_tail.py | csrc/serving_tail.cu | serving_tail.py `_kernel` |
| packed_trunk.py | csrc/packed_trunk.cu | packed_trunk.py `_fwd_kernel`, `_bwd_kernel` |
| fused_trunk.py  | csrc/fused_trunk.cu  | fused_trunk.py `_kernel` |
| buddy_select.py | csrc/buddy_select.cu | buddy_select.py `_buddy_kernel` |

Each wrapper counts its launches in a module-level integer. xpack_trunk.py
has no kernel: the JAX module it ports is plain XLA, so its eval trunk is
plain torch, and its training trunk is packed_trunk.py's.
"""


def reset_launch_counts() -> None:
    from srgan_st_tpu_torch.kernels import (
        buddy_select, coarse_conv, fused_trunk, packed_trunk, serving_tail,
    )

    coarse_conv.launches = 0
    serving_tail.launches = 0
    packed_trunk.fwd_launches = 0
    packed_trunk.bwd_launches = 0
    fused_trunk.launches = 0
    buddy_select.launches = 0


def launch_counts() -> dict[str, int]:
    from srgan_st_tpu_torch.kernels import (
        buddy_select, coarse_conv, fused_trunk, packed_trunk, serving_tail,
    )

    return {"coarse_conv_s2d": coarse_conv.launches,
            "serving_tail": serving_tail.launches,
            "packed_trunk_fwd": packed_trunk.fwd_launches,
            "packed_trunk_bwd": packed_trunk.bwd_launches,
            "fused_trunk": fused_trunk.launches,
            "buddy_select": buddy_select.launches}
