"""Best-buddy patch illustration (port of
srgan_st_tpu/viz/buddy_illustration.py; reference visualization/
visualizations.ipynb cells 4-10).

For a target patch of an image, finds its k nearest patches under the
Best-Buddy score (the multi-scale candidate bank and the combined pairwise
distance of `losses/functions.py` best_buddy_loss, with sr = gt = the
image, as the notebook's `bestbuddy(im, im, k)`), then renders:

  * `{stem}_buddies.png` — the image with the target patch boxed in BLUE
    and its full-scale best buddies boxed in RED;
  * `{stem}_buddy_{rank}.png` — the crop of each buddy, from the bank
    scale it lives at (a buddy from the 1/2- or 1/4-scale bank is noted in
    the returned metadata, not drawn on the full-scale canvas);
  * `{stem}_target.png` — the target crop.

The scores are computed on the device by `ops/pairwise.py`
batch_pairwise_distance (not by the buddy-selection kernel, which gives
the argmin only); the target's row is ranked on the host by a stable
argsort, as in the JAX tool, so both packages break ties the same way.
`buddy_scores` and `illustrate` are the array cores; `buddy_illustration`
decodes the file (PIL, imported when called) and writes the PNGs with
zlib alone.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _draw_box(img: np.ndarray, y: int, x: int, size: int, color) -> None:
    """In-place 2px box around [y:y+size, x:x+size] (clamped to bounds)."""
    h, w = img.shape[:2]
    y0, x0 = max(y - 1, 0), max(x - 1, 0)
    y1, x1 = min(y + size + 1, h), min(x + size + 1, w)
    img[y0:y1, x0:min(x0 + 2, w)] = color
    img[y0:y1, max(x1 - 2, 0):x1] = color
    img[y0:min(y0 + 2, h), x0:x1] = color
    img[max(y1 - 2, 0):y1, x0:x1] = color


@torch.no_grad()
def buddy_bank(img01: np.ndarray, ksize: int = 15, device=None) -> dict:
    """The image's non-overlapping patches and the candidate bank on the
    device (CUDA unless `device` says otherwise): "patches" (1, N, d),
    "bank" (1, M, d), the full-scale patches then those of the 0.5 and 0.25
    bicubic ("torch") downscales trimmed to whole patches; "parts" the
    (scale, grid rows, grid cols) of each bank part, "scaled" {scale: the
    (1, h, w, 3) image the part was cut from}. `img01` must be cropped to a
    multiple of ksize."""
    from srgan_st_tpu_torch.core.device import resolve_device
    from srgan_st_tpu_torch.ops.patches import extract_patches
    from srgan_st_tpu_torch.ops.resize import resize_bicubic

    x = torch.as_tensor(np.asarray(img01, np.float32)[None], device=resolve_device(device))
    p = extract_patches(x, ksize, ksize)
    parts, scaled, bank = [(1.0, x.shape[1] // ksize, x.shape[2] // ksize)], {1.0: x}, [p]
    for s in (0.5, 0.25):
        xs = resize_bicubic(x, s, method="torch")
        hs, ws = xs.shape[1], xs.shape[2]
        bank.append(extract_patches(xs[:, :(hs // ksize) * ksize, :(ws // ksize) * ksize],
                                    ksize, ksize))
        parts.append((s, hs // ksize, ws // ksize))
        scaled[s] = xs
    return {"patches": p, "bank": torch.cat(bank, dim=1), "parts": parts, "scaled": scaled}


@torch.no_grad()
def buddy_scores(bank: dict, alpha: float = 1.0, beta: float = 1.0,
                 dist_norm: str = "l2") -> torch.Tensor:
    """(N, M) scores of every patch against the bank: with sr = gt = the
    image (notebook cell 9) the combined alpha*d(p1, bank) + beta*d(p2,
    bank) is (alpha + beta) * d(p, bank)."""
    from srgan_st_tpu_torch.ops.pairwise import batch_pairwise_distance

    return ((alpha + beta) * batch_pairwise_distance(bank["patches"], bank["bank"],
                                                     dist_norm))[0]


def rank_buddies(score_row: np.ndarray, target: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(the k best bank indices, the row with the self-match at inf): the
    k smallest scores by a stable argsort (ties to the lower index)."""
    row = np.array(score_row, np.float32)
    row[target] = np.inf  # self-match is trivially the 1st buddy
    return np.argsort(row, kind="stable")[:k], row


def _target(target_patch, nh: int, nw: int) -> tuple[int, int, int]:
    if isinstance(target_patch, tuple):
        t_row, t_col = target_patch
        target = t_row * nw + t_col
    else:
        target = int(target_patch)
        t_row, t_col = divmod(target, nw)
    if not (0 <= target < nh * nw):
        raise ValueError(f"target patch {target} outside the {nh}x{nw} grid")
    return target, t_row, t_col


def _u8(a: np.ndarray) -> np.ndarray:
    return (a * 255).round().astype(np.uint8)


def illustrate(img01: np.ndarray, target_patch: int | tuple[int, int], k: int = 6,
               ksize: int = 15, alpha: float = 1.0, beta: float = 1.0,
               dist_norm: str = "l2", device=None) -> dict:
    """The illustration as arrays: the JAX tool's metadata ("target",
    "buddies", "grid", "ksize") and "images", {file suffix: uint8 RGB image}
    in the order the files are written ("target", "buddy_{rank}"...,
    "buddies")."""
    # crop to a multiple of ksize (notebook cell 8 crops to 15*51)
    nh, nw = img01.shape[0] // ksize, img01.shape[1] // ksize
    img = np.asarray(img01, np.float32)[:nh * ksize, :nw * ksize]
    target, t_row, t_col = _target(target_patch, nh, nw)
    bank = buddy_bank(img, ksize, device)
    score = buddy_scores(bank, alpha, beta, dist_norm)
    order, row = rank_buddies(score[target].cpu().numpy(), target, k)

    canvas = img.copy()
    _draw_box(canvas, t_row * ksize, t_col * ksize, ksize, (0.0, 0.0, 1.0))
    images = {"target": _u8(img[t_row * ksize:(t_row + 1) * ksize,
                                t_col * ksize:(t_col + 1) * ksize])}
    sizes = [gh * gw for _, gh, gw in bank["parts"]]
    buddies = []
    for rank, idx in enumerate(order, start=1):
        idx = int(idx)
        part = int(np.searchsorted(np.cumsum(sizes), idx, side="right"))
        scale, _, gw = bank["parts"][part]
        by, bx = divmod(idx - sum(sizes[:part]), gw)
        src = bank["scaled"][scale][0].cpu().numpy()
        images[f"buddy_{rank}"] = _u8(src[by * ksize:(by + 1) * ksize,
                                          bx * ksize:(bx + 1) * ksize])
        if scale == 1.0:
            _draw_box(canvas, by * ksize, bx * ksize, ksize, (1.0, 0.0, 0.0))
        buddies.append({"rank": rank, "bank_index": idx, "scale": scale,
                        "row": int(by), "col": int(bx), "score": float(row[idx])})
    images["buddies"] = _u8(canvas)
    return {"target": {"index": target, "row": t_row, "col": t_col},
            "buddies": buddies, "grid": (nh, nw), "ksize": ksize, "images": images}


def buddy_illustration(
    image_path: str,
    target_patch: int | tuple[int, int],
    k: int = 6,
    ksize: int = 15,
    alpha: float = 1.0,
    beta: float = 1.0,
    dist_norm: str = "l2",
    out_dir: str = "figures",
    device=None,
) -> dict:
    """Render the best-buddy illustration; returns metadata + written paths.

    `target_patch` is either a flat non-overlapping patch index (the
    notebook's convention) or (row, col) patch-grid coordinates. The k
    buddies are the k smallest-score bank entries EXCLUDING the target
    patch itself (whose distance is trivially 0 when sr == gt)."""
    from srgan_st_tpu_torch.data.pipeline import _decode_rgb
    from srgan_st_tpu_torch.viz.save_image_patch import write_rgb_png

    img = _decode_rgb(image_path).astype(np.float32) / 255.0
    meta = illustrate(img, target_patch, k, ksize, alpha, beta, dist_norm, device)
    os.makedirs(out_dir, exist_ok=True)
    stem = os.path.splitext(os.path.basename(image_path))[0]
    written = []
    for suffix, image in meta.pop("images").items():
        written.append(os.path.join(out_dir, f"{stem}_{suffix}.png"))
        write_rgb_png(written[-1], image)
    meta["written"] = written
    return meta


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(
        description="Best-buddy patch illustration: mark a target patch "
        "(blue) and its k best buddies (red) on an image."
    )
    p.add_argument("--image", required=True)
    p.add_argument("--patch", required=True,
                   help="flat patch index, or 'row,col' grid coordinates")
    p.add_argument("--k", type=int, default=6)
    p.add_argument("--ksize", type=int, default=15)
    p.add_argument("--out", default="figures")
    p.add_argument("--device", type=str, default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    patch = (tuple(int(v) for v in args.patch.split(","))
             if "," in args.patch else int(args.patch))
    meta = buddy_illustration(args.image, patch, k=args.k, ksize=args.ksize,
                              out_dir=args.out, device=args.device)
    for b in meta["buddies"]:
        print(f"buddy {b['rank']}: scale {b['scale']} "
              f"grid ({b['row']}, {b['col']}) score {b['score']:.5f}")
    for path in meta["written"]:
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
