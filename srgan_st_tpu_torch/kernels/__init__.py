"""Hand-written Hopper kernels of the port, with their plain versions.

| module | CUDA source | replaces (Pallas, srgan_st_tpu/kernels/) |
|---|---|---|
| coarse_conv.py  | csrc/coarse_conv.cu  | coarse_conv.py `_kernel`, `_kernel_tiled` |
| serving_tail.py | csrc/serving_tail.cu | serving_tail.py `_kernel` |

Each wrapper counts its launches in a module-level `launches` integer.
"""


def reset_launch_counts() -> None:
    from srgan_st_tpu_torch.kernels import coarse_conv, serving_tail

    coarse_conv.launches = 0
    serving_tail.launches = 0


def launch_counts() -> dict[str, int]:
    from srgan_st_tpu_torch.kernels import coarse_conv, serving_tail

    return {"coarse_conv_s2d": coarse_conv.launches,
            "serving_tail": serving_tail.launches}
