"""Loss-sensitivity study over the port's criteria (the port's counterpart
of examples/loss_study.py, itself the script form of the reference's
loss_study.ipynb).

    python -m srgan_st_tpu_torch.tools.loss_study [--image patch.png]
        [--out figures/] [--strengths 0 0.1 0.25 0.5 0.75 1] [--device cuda]

Each criterion's response (Pixel, BestBuddy, Gram, PatchwiseST, ST) to
controlled perturbations of a fixed ground-truth patch (noise, shift,
rotation, rescale), drawn as loss-vs-strength curves. `loss_table` is the
study's core: the JAX script's loop order (each perturbation, each loss,
each strength) and one `np.random.default_rng(0)` shared by every call, so
the noise draws differ per loss. The perturbations run on the host; the
losses on `device` (CUDA unless the caller asks for the CPU), where
BestBuddy, Gram and PatchwiseST launch the buddy selection K7. PIL and
matplotlib are imported only in `main`.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def perturb_noise(img, strength, rng):
    return np.clip(img + strength * rng.standard_normal(img.shape), 0, 1)


def perturb_shift(img, strength, rng):
    return np.roll(img, int(round(strength * 16)), axis=1)


def perturb_rotate(img, strength, rng):
    # 90-degree steps: a quarter turn at strength 1 (no interpolation)
    k = int(round(strength * 1))
    return np.rot90(img, k=k, axes=(1, 2)) if k else img


def perturb_rescale(img, strength, rng):
    """Matlab-bicubic down by 1 - strength / 2 and back up, cropped."""
    from srgan_st_tpu_torch.ops.resize import resize_bicubic

    factor = 1.0 - 0.5 * strength
    if factor >= 0.999:
        return img
    down = resize_bicubic(torch.from_numpy(np.ascontiguousarray(img, np.float32)), factor)
    up = resize_bicubic(down, img.shape[1] / down.shape[1])
    return up.numpy()[:, : img.shape[1], : img.shape[2]]


PERTURBATIONS = {
    "noise": perturb_noise,
    "shift": perturb_shift,
    "rotation": perturb_rotate,
    "rescale": perturb_rescale,
}

STRENGTHS = (0.0, 0.1, 0.25, 0.5, 0.75, 1.0)


def losses() -> dict:
    """The study's criteria, each (sr, gt) -> a scalar tensor, defaults as
    the training zoo's."""
    from srgan_st_tpu_torch.losses import functions as F

    return {"Pixel": F.pixel_loss, "BestBuddy": F.best_buddy_loss, "Gram": F.gram_loss,
            "PatchwiseST": F.patchwise_st_loss, "ST": F.st_loss}


def synthetic_patch() -> np.ndarray:
    """The JAX script's default 96x96 RGB patch, (1, 96, 96, 3) float32."""
    yy, xx = np.mgrid[0:96, 0:96] / 96.0
    return np.stack([np.sin(8 * xx) * 0.5 + 0.5, yy, ((xx * yy * 31) % 1.0)],
                    -1).astype(np.float32)[None]


def loss_table(gt: np.ndarray, strengths=STRENGTHS, rng=None, device="cuda") -> dict:
    """{perturbation: {loss: [value at each strength]}} for the NHWC float
    patch `gt` in [0, 1]."""
    from srgan_st_tpu_torch.core.device import resolve_device

    dev = resolve_device(device)
    rng = np.random.default_rng(0) if rng is None else rng
    gt_t = torch.from_numpy(np.ascontiguousarray(gt, np.float32)).to(dev)
    table = {}
    with torch.no_grad():
        for pname, pfn in PERTURBATIONS.items():
            table[pname] = {}
            for lname, lfn in losses().items():
                table[pname][lname] = [
                    float(lfn(torch.from_numpy(np.ascontiguousarray(
                        pfn(gt, s, rng).astype(np.float32))).to(dev), gt_t))
                    for s in strengths]
    return table


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description="Loss-sensitivity study of the port's "
                                     "criteria; writes <out>/loss_study.png")
    parser.add_argument("--image", default=None, help="96x96 RGB patch (default: synthetic)")
    parser.add_argument("--out", default="figures")
    parser.add_argument("--strengths", nargs="+", type=float, default=list(STRENGTHS))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    if args.image:
        from PIL import Image

        gt = np.asarray(Image.open(args.image).convert("RGB"), np.float32)[None] / 255.0
        gt = gt[:, :96, :96]
    else:
        gt = synthetic_patch()
    table = loss_table(gt, args.strengths, np.random.default_rng(0), args.device)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, len(table), figsize=(5 * len(table), 4))
    for ax, (pname, rows) in zip(axes, table.items()):
        for lname, vals in rows.items():
            base = max(vals[-1], 1e-12)
            ax.plot(args.strengths, [v / base for v in vals], marker="o", label=lname)
        ax.set_title(f"{pname} response (normalized)")
        ax.set_xlabel("perturbation strength")
        ax.grid(alpha=0.3)
        ax.legend(fontsize=8)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "loss_study.png")
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
