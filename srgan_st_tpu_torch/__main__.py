"""Command-line front door: ``python -m srgan_st_tpu_torch <command>``.

Usage:
    python -m srgan_st_tpu_torch infer ...      # upscale arbitrary images
    python -m srgan_st_tpu_torch validate ...   # PSNR/SSIM eval on a test set

Each command forwards to its module's CLI (same flags as running the
module directly) and is imported lazily. The other commands of
``python -m srgan_st_tpu`` wait for their slices (ROADMAP.md Queue A).
"""

from __future__ import annotations

import sys

# command -> (module, attr, one-line help)
_COMMANDS: dict[str, tuple[str, str, str]] = {
    "validate": (
        "srgan_st_tpu_torch.eval.validate", "main",
        "PSNR/SSIM evaluation on a test set (Set5-style layout)",
    ),
    "infer": (
        "srgan_st_tpu_torch.eval.infer", "main",
        "upscale image files/directories with npz generator weights",
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
