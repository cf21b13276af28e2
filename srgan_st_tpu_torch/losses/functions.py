"""Generator criteria as pure functions (port of
srgan_st_tpu/losses/functions.py).

Images are NHWC in [0, 1]. Every criterion accumulates its mean in f32
whatever the compute dtype; with `dtype` both images are first cast to it,
as the JAX package's `_cast_pair` does. The buddy losses select with
kernels/buddy_select.py: `pallas` (the JAX package's spec key) False forces
the plain version, None or True take the hand-written kernel on a CUDA
tensor. `content_loss_vgg` compares VGG19 tap activations
(models/vgg.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from srgan_st_tpu_torch.core.device import compute_dtype
from srgan_st_tpu_torch.kernels.buddy_select import (
    buddy_select_index,
    buddy_select_reference,
    gather_rows,
)
from srgan_st_tpu_torch.ops.color import imagenet_normalize, rgb_to_grayscale
from srgan_st_tpu_torch.ops.patches import extract_patch_grids, extract_patches
from srgan_st_tpu_torch.ops.resize import resize_bicubic
from srgan_st_tpu_torch.ops.structure_tensor import (
    st_distance,
    st_normalize,
    structure_tensor,
    structure_tensor_patches,
)


def _elementwise_criterion(name: str):
    if name == "l1":
        return lambda a, b: (a.float() - b.float()).abs().mean()
    if name in ("l2", "mse"):
        return lambda a, b: ((a.float() - b.float()) ** 2).mean()
    raise NotImplementedError(f"{name} criterion has not been implemented.")


def _cast_pair(sr, gt, dtype):
    """Both images in the loss-side compute dtype (None keeps theirs)."""
    if dtype is None:
        return sr, gt
    dt = compute_dtype(dtype) if isinstance(dtype, str) else dtype
    return sr.to(dt), gt.to(dt)


def pixel_loss(sr: torch.Tensor, gt: torch.Tensor, criterion: str = "mse",
               dtype=None) -> torch.Tensor:
    """Pixel loss (the warmup criterion, reference config.py:88-93)."""
    sr, gt = _cast_pair(sr, gt, dtype)
    return _elementwise_criterion(criterion)(sr, gt)


def adversarial_loss(d_logits: torch.Tensor, target: float) -> torch.Tensor:
    """BCE-with-logits against a constant target label, in the log-sigmoid
    form (reference train.py:135-136)."""
    log_p = F.logsigmoid(d_logits)
    log_not_p = F.logsigmoid(-d_logits)
    return -(target * log_p + (1.0 - target) * log_not_p).mean()


# ---------------------------------------------------------------------------
def _buddy_select(p1, p2, p2_cat, alpha, beta, dist_norm, pallas=None):
    """The bank row minimizing the combined score per sr patch (reference
    loss.py:132-137), gathered without gradient."""
    select = buddy_select_reference if pallas is False else buddy_select_index
    return gather_rows(p2_cat, select(p1, p2, p2_cat, alpha, beta, dist_norm))


def _bank(gt, features):
    """gt's features at full, 1/2 and 1/4 scale (torch-bicubic downscales,
    reference loss.py:123-128), concatenated along the patch axis."""
    return torch.cat([features(gt), features(resize_bicubic(gt, 0.5, method="torch")),
                      features(resize_bicubic(gt, 0.25, method="torch"))], dim=1)


def best_buddy_loss(sr, gt, alpha=1.0, beta=1.0, ksize=3, pad=0, stride=3,
                    dist_norm="l2", criterion="l1", pallas=None, dtype=None):
    """Best-Buddy loss (reference loss.py:78-141, after the BBGAN paper)."""
    sr, gt = _cast_pair(sr, gt, dtype)

    def patches(x):
        return extract_patches(x, ksize, stride, pad)

    p1 = patches(sr)
    sel = _buddy_select(p1, patches(gt), _bank(gt, patches), alpha, beta, dist_norm, pallas)
    return _elementwise_criterion(criterion)(p1, sel)


def _gram_patches(x, ksize):
    """Per-patch channel Gram matrices (reference loss.py:180-201): each
    non-overlapping (C, k, k) patch maps to F F^T / (C k k) with F the
    patch as (C, k*k), output (B, N, C*C). The window sums of the channel
    products are two products with 0/1 pooling matrices (separable over H
    and W), as in the JAX package."""
    b, h, w, c = x.shape
    if h % ksize or w % ksize:
        raise ValueError(f"image size {h}x{w} not divisible by ksize={ksize}")
    prod = (x[..., :, None] * x[..., None, :]).reshape(b, h, w, c * c)
    ar = lambda n: torch.arange(n, device=x.device)  # noqa: E731
    ph = (ar(h)[:, None] // ksize == ar(h // ksize)[None, :]).to(x.dtype)
    pw = (ar(w)[:, None] // ksize == ar(w // ksize)[None, :]).to(x.dtype)
    pooled = torch.einsum("bhwc,hp,wq->bpqc", prod, ph, pw)
    n = (h // ksize) * (w // ksize)
    return pooled.reshape(b, n, c * c) / (c * ksize * ksize)


def gram_loss(sr, gt, alpha=1.0, beta=1.0, ksize=3, dist_norm="l2", criterion="l1",
              pallas=None, dtype=None):
    """Gram-matrix best-buddy loss (reference loss.py:146-225, GramGAN)."""
    sr, gt = _cast_pair(sr, gt, dtype)

    def grams(x):
        return _gram_patches(x, ksize)

    p1 = grams(sr)
    sel = _buddy_select(p1, grams(gt), _bank(gt, grams), alpha, beta, dist_norm, pallas)
    return _elementwise_criterion(criterion)(p1, sel)


def _st_patches(x, sigma, rho, ksize):
    """Per-patch normalized structure tensors (reference loss.py:330-350):
    each (C, k, k) patch grayscaled, its (3, k, k) structure tensor
    det-normalized and flattened to 3*k*k features."""
    grids = extract_patch_grids(x, ksize)  # (B, N, C, k, k)
    b, n, _, k, _ = grids.shape
    gray = rgb_to_grayscale(grids, channel_axis=2)[:, :, 0]
    st = st_normalize(structure_tensor_patches(gray, sigma=sigma, rho=rho))
    return st.reshape(b, n, 3 * k * k)


def patchwise_st_loss(sr, gt, sigma=0.5, rho=2.0, alpha=1.0, beta=1.0, ksize=3,
                      dist_norm="l2", criterion="l1", pallas=None, dtype=None):
    """Patchwise structure-tensor best-buddy loss (reference loss.py:292-375,
    buddy selection in structure-tensor space)."""
    sr, gt = _cast_pair(sr, gt, dtype)

    def sts(x):
        return _st_patches(x, sigma, rho, ksize)

    p1 = sts(sr)
    sel = _buddy_select(p1, sts(gt), _bank(gt, sts), alpha, beta, dist_norm, pallas)
    return _elementwise_criterion(criterion)(p1, sel)


def st_loss(sr, gt, sigma=0.5, rho=2.0, normalize=True, dtype=None):
    """Whole-image structure-tensor loss (reference loss.py:380-413): the
    mean Riemannian distance between the structure tensors of sr and gt."""
    sr, gt = _cast_pair(sr, gt, dtype)
    s_sr = structure_tensor(rgb_to_grayscale(sr).permute(0, 3, 1, 2), sigma=sigma, rho=rho)
    s_gt = structure_tensor(rgb_to_grayscale(gt).permute(0, 3, 1, 2), sigma=sigma, rho=rho)
    return st_distance(s_sr, s_gt, normalize).mean()


def content_loss_discriminator(sr, gt, d_apply, layer_weights, criterion="mse"):
    """Discriminator-feature content loss (reference loss.py:230-287, the
    ESRGAN idea): the weighted criterion between D's tap activations of
    the ImageNet-normalized images (the reference normalizes although D was
    trained on raw [0, 1] images, loss.py:269,279-280). `d_apply` runs the
    content D in its compute dtype, which it casts its input to."""
    crit = _elementwise_criterion(criterion)
    sr_feats = d_apply(imagenet_normalize(sr))
    gt_feats = d_apply(imagenet_normalize(gt))
    loss = 0.0
    for name, weight in layer_weights.items():
        loss = loss + weight * crit(sr_feats[name], gt_feats[name])
    return loss


def content_loss_vgg(sr, gt, vgg_apply=None, layer_weights=None, criterion="mse",
                     remat=False, vgg_pair=None):
    """VGG19 perceptual content loss (reference loss.py:11-74, the GramGAN
    recipe): both images ImageNet-normalized, each tap's activations
    compared by the weighted elementwise criterion.

    `vgg_apply` (the default) runs two forwards differentiated by autograd;
    `remat` recomputes the sr branch's forward in the backward instead of
    saving its activations. `vgg_pair` (models/vgg.py
    make_vgg19_frozen_pair, opt-in through spec["pair"]) runs both in one
    batch-concatenated forward with a hand-written sr-only backward."""
    crit = _elementwise_criterion(criterion)
    if vgg_pair is not None:
        sr_feats, gt_feats = vgg_pair(imagenet_normalize(sr), imagenet_normalize(gt))
    else:
        def sr_branch(z):
            return vgg_apply(imagenet_normalize(z))

        sr_feats = checkpoint(sr_branch, sr, use_reentrant=False) if remat else sr_branch(sr)
        gt_feats = vgg_apply(imagenet_normalize(gt))
    loss = 0.0
    for name, weight in layer_weights.items():
        loss = loss + weight * crit(sr_feats[name], gt_feats[name])
    return loss
