"""Command-line front door: ``python -m srgan_st_tpu_torch <command>``.

Usage:
    python -m srgan_st_tpu_torch run ...        # job_index experiment sweep
    python -m srgan_st_tpu_torch warmup ...     # SRResNet warmup (pixel loss)
    python -m srgan_st_tpu_torch train ...      # adversarial training
    python -m srgan_st_tpu_torch infer ...      # upscale arbitrary images
    python -m srgan_st_tpu_torch validate ...   # PSNR/SSIM eval on a test set
    python -m srgan_st_tpu_torch export ...     # torch.export serving artifact
    python -m srgan_st_tpu_torch prepare-dataset ...  # tile HR images (+ --pack)
    python -m srgan_st_tpu_torch curves ...     # PSNR/SSIM curves (host only)
    python -m srgan_st_tpu_torch feature-maps ...  # content-loss feature maps
    python -m srgan_st_tpu_torch buddy-viz ...  # best-buddy illustration
    python -m srgan_st_tpu_torch doctor ...     # GPU health probe

Each command forwards to its module's CLI (same flags as running the
module directly) and is imported lazily. Every command that computes on a
device takes `--device` (default cuda).
"""

from __future__ import annotations

import sys

# command -> (module, attr, one-line help)
_COMMANDS: dict[str, tuple[str, str, str]] = {
    "run": (
        "srgan_st_tpu_torch.main", "main",
        "job_index-driven experiment sweep: train, then test",
    ),
    "warmup": (
        "srgan_st_tpu_torch.train.warmup", "cli",
        "PSNR-oriented SRResNet warmup (pixel loss only)",
    ),
    "train": (
        "srgan_st_tpu_torch.train.train", "cli",
        "adversarial (GAN) training",
    ),
    "validate": (
        "srgan_st_tpu_torch.eval.validate", "main",
        "PSNR/SSIM evaluation on a test set (Set5-style layout)",
    ),
    "infer": (
        "srgan_st_tpu_torch.eval.infer", "main",
        "upscale image files/directories with npz weights or an artifact",
    ),
    "export": (
        "srgan_st_tpu_torch.eval.export", "main",
        "export the generator as a torch.export serving artifact",
    ),
    "prepare-dataset": (
        "srgan_st_tpu_torch.data.prepare_dataset", "main",
        "tile HR images into training patches (--pack: patches.pack.npy)",
    ),
    "curves": (
        "srgan_st_tpu_torch.viz.training_curves", "main",
        "plot training curves from TB events / JSONL scalars",
    ),
    "feature-maps": (
        "srgan_st_tpu_torch.viz.feature_maps", "main",
        "visualize content-loss feature maps for an image pair",
    ),
    "buddy-viz": (
        "srgan_st_tpu_torch.viz.buddy_illustration", "main",
        "mark a patch and its best-buddy candidates on an image",
    ),
    "doctor": (
        "srgan_st_tpu_torch.utils.cuda_health", "main",
        "probe whether the CUDA device is usable (clean child processes)",
    ),
}


def _usage() -> str:
    width = max(len(name) for name in _COMMANDS)
    lines = [
        "usage: python -m srgan_st_tpu_torch <command> [args...]",
        "",
        "commands:",
        *(f"  {name:<{width}}  {help_}" for name, (_, _, help_) in _COMMANDS.items()),
        "",
        "Run `python -m srgan_st_tpu_torch <command> --help` for per-command flags.",
    ]
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_usage())
        return
    name, rest = argv[0], argv[1:]
    if name not in _COMMANDS:
        print(f"unknown command: {name!r}\n\n{_usage()}", file=sys.stderr)
        raise SystemExit(2)
    module_name, attr, _ = _COMMANDS[name]
    import importlib

    fn = getattr(importlib.import_module(module_name), attr)
    fn(rest)


if __name__ == "__main__":
    main()
