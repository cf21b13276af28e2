"""Training-curve figures from logged scalars (port of
srgan_st_tpu/viz/training_curves.py; the reference's
tensorboard-visualization notebook): the Test/PSNR and Test/SSIM series of
a set of experiments, from the TensorBoard event files or the
`scalars.jsonl` fallback that train/logging.py's ExperimentWriter writes,
plotted as in the paper (PSNR in the 24-32 dB envelope over epochs).
Host-only: TensorBoard's reader and matplotlib are imported when called.

Usage:
    python -m srgan_st_tpu_torch curves \
        --experiments patchwise-st-vgg st-vgg pixel-baseline \
        --out figures/curves.png
"""

from __future__ import annotations

import argparse
import json
import os


def load_scalars(log_dir: str) -> dict[str, list[tuple[int, float]]]:
    """tag -> [(step, value)] from tensorboard event files or scalars.jsonl."""
    series: dict[str, list[tuple[int, float]]] = {}
    jsonl = os.path.join(log_dir, "scalars.jsonl")
    if os.path.exists(jsonl):
        with open(jsonl) as f:
            for line in f:
                rec = json.loads(line)
                series.setdefault(rec["tag"], []).append((rec["step"], rec["value"]))
        return series
    try:
        from tensorboard.backend.event_processing.event_accumulator import (
            EventAccumulator,
        )
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("neither scalars.jsonl nor tensorboard available") from e
    acc = EventAccumulator(log_dir)
    acc.Reload()
    for tag in acc.Tags().get("scalars", []):
        series[tag] = [(ev.step, ev.value) for ev in acc.Scalars(tag)]
    return series


def plot_curves(experiments: list[str], tags: list[str], out_path: str,
                tb_root: str = "tensorboard") -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, len(tags), figsize=(6 * len(tags), 4.5))
    if len(tags) == 1:
        axes = [axes]
    for ax, tag in zip(axes, tags):
        for exp in experiments:
            series = load_scalars(os.path.join(tb_root, exp)).get(tag)
            if not series:
                continue
            steps, values = zip(*sorted(series))
            ax.plot(steps, values, label=exp)
        ax.set_title(tag)
        ax.set_xlabel("epoch" if tag.startswith("Test") else "batches")
        ax.grid(alpha=0.3)
        ax.legend(fontsize=8)
    if "Test/PSNR" in tags:
        axes[tags.index("Test/PSNR")].set_ylim(24, 32)  # the reference's envelope
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)
    plt.close(fig)
    return out_path


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--experiments", nargs="+", required=True)
    p.add_argument("--tags", nargs="+", default=["Test/PSNR", "Test/SSIM"])
    p.add_argument("--tb_root", default="tensorboard")
    p.add_argument("--out", default="figures/curves.png")
    args = p.parse_args(argv)
    path = plot_curves(args.experiments, args.tags, args.out, args.tb_root)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
