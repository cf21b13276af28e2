"""Generator criteria as pure functions (port of
srgan_st_tpu/losses/functions.py: the pixel and adversarial losses).

Images are NHWC in [0, 1]. The rest of the criterion zoo (VGG and
discriminator content losses, best-buddy, Gram, the structure-tensor
losses) waits for ROADMAP.md Queue A, item 2.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pixel_loss(sr: torch.Tensor, gt: torch.Tensor, criterion: str = "mse",
               dtype=None) -> torch.Tensor:
    """Pixel loss, accumulated in f32 whatever the compute dtype (the warmup
    criterion, reference config.py:88-93). With `dtype` both images are
    first cast to it, as the JAX package's `_cast_pair` does."""
    if dtype is not None:
        from srgan_st_tpu_torch.core.device import compute_dtype

        dt = compute_dtype(dtype) if isinstance(dtype, str) else dtype
        sr, gt = sr.to(dt), gt.to(dt)
    d = sr.float() - gt.float()
    if criterion == "l1":
        return d.abs().mean()
    if criterion in ("l2", "mse"):
        return (d * d).mean()
    raise NotImplementedError(f"{criterion} criterion has not been implemented.")


def adversarial_loss(d_logits: torch.Tensor, target: float) -> torch.Tensor:
    """BCE-with-logits against a constant target label, in the log-sigmoid
    form (reference train.py:135-136)."""
    log_p = F.logsigmoid(d_logits)
    log_not_p = F.logsigmoid(-d_logits)
    return -(target * log_p + (1.0 - target) * log_not_p).mean()
