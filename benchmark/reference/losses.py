"""The generator's criteria (loss.py, train.py:135-136) as plain
functions: MSE pixel loss, the adversarial BCE against a smoothed label,
the patchwise structure-tensor best-buddy loss (loss.py:292-375) and the
discriminator-feature content loss (loss.py:230-287)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.models import discriminator

GRAY = (0.2989, 0.587, 0.114)  # torchvision's Grayscale (ITU-R 601 luma)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def mse(a, b):
    return ((a - b) ** 2).mean()


def bce_logits(logits, target: float):
    return F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, target))


def gaussian_taps(sigma: float, derivative: bool = False) -> torch.Tensor:
    """1-D Gaussian taps of radius max(int(4 sigma + 0.5), 1), normalized,
    or their derivative phi * (-x) / sigma^2 (utils.py:194-208)."""
    radius = max(int(4 * sigma + 0.5), 1)
    x = torch.arange(-radius, radius + 1, dtype=torch.float64)
    s2 = sigma * sigma + 1e-12
    phi = torch.exp(-0.5 * x * x / s2)
    phi = phi / phi.sum()
    return (phi * -x / s2 if derivative else phi).float()


def _filter(x, taps, axis: str):
    """SAME zero-padded 1-D cross-correlation of (n, 1, k, k) along rows
    ("h") or columns ("w")."""
    r = (len(taps) - 1) // 2
    taps = taps.to(x.device, x.dtype)
    if axis == "h":
        return F.conv2d(x, taps.view(1, 1, -1, 1), padding=(r, 0))
    return F.conv2d(x, taps.view(1, 1, 1, -1), padding=(0, r))


def st_features(img, sigma: float, rho: float, k: int):
    """(B, N, 3 k k): each non-overlapping k x k patch (row-major) of the
    grayscaled image as its own image: derivative-of-Gaussian gradients,
    the rho-smoothed structure tensor (Jxx, Jyy, Jxy), divided by
    sqrt(det + 1e-12) (loss.py:330-350)."""
    b, h, w, _ = img.shape
    gray = img[..., 0] * GRAY[0] + img[..., 1] * GRAY[1] + img[..., 2] * GRAY[2]
    nh, nw = h // k, w // k
    p = gray.reshape(b, nh, k, nw, k).permute(0, 1, 3, 2, 4).reshape(b * nh * nw, 1, k, k)
    g, dg, sm = gaussian_taps(sigma), gaussian_taps(sigma, True), gaussian_taps(rho)
    ix = _filter(_filter(p, dg, "h"), g, "w")
    iy = _filter(_filter(p, g, "h"), dg, "w")

    def smooth(z):
        return _filter(_filter(z, sm, "h"), sm, "w")

    jxx, jyy, jxy = smooth(ix * ix), smooth(iy * iy), smooth(ix * iy)
    det = jxx * jyy - jxy * jxy
    st = torch.cat([jxx, jyy, jxy], 1) / torch.sqrt(det + 1e-12)
    return st.reshape(b, nh * nw, 3 * k * k)


def _shrink(img, factor: float):
    """torch's bicubic interpolation (a = -0.75, half-pixel centres, no
    antialiasing), NHWC."""
    _, h, w, _ = img.shape
    out = F.interpolate(img.permute(0, 3, 1, 2), size=(int(h * factor), int(w * factor)),
                        mode="bicubic", align_corners=False)
    return out.permute(0, 2, 3, 1)


def patchwise_st(sr, gt, sigma=0.5, rho=2.0, alpha=1.0, beta=1.0, ksize=3):
    """Mean |p1 - buddy|: for each patch of sr (p1) the bank row -- the
    patches of gt at full, 1/2 and 1/4 scale -- that minimizes
    alpha |p1 - q|^2 + beta |p2 - q|^2 (p2 the gt patch at its place),
    scored in float64, the first on a tie; the choice carries no
    gradient (loss.py:123-141)."""
    def feats(x):
        return st_features(x, sigma, rho, ksize)

    p1, p2 = feats(sr), feats(gt)
    bank = torch.cat([p2, feats(_shrink(gt, 0.5)), feats(_shrink(gt, 0.25))], 1).detach()
    a, c, q = p1.detach().double(), p2.detach().double(), bank.double()
    qq = (q * q).sum(-1)[:, None, :]

    def dist(x):
        return (x * x).sum(-1)[:, :, None] + qq - 2 * torch.bmm(x, q.transpose(1, 2))

    idx = torch.argmin(alpha * dist(a) + beta * dist(c), dim=2)
    buddy = torch.gather(bank, 1, idx[..., None].expand(-1, -1, bank.shape[-1]))
    return (p1 - buddy).abs().mean()


def content_discriminator(sr, gt, d_params, layer_weights: dict, quant=None):
    """Sum over the taps of weight x MSE between the frozen D's (eval
    mode) activations of the ImageNet-normalized sr and gt."""
    mean = torch.tensor(IMAGENET_MEAN, device=sr.device)
    std = torch.tensor(IMAGENET_STD, device=sr.device)
    taps = tuple(layer_weights)
    fs = discriminator(d_params, (sr - mean) / std, False, taps, quant)
    fg = discriminator(d_params, (gt - mean) / std, False, taps, quant)
    return sum(w * mse(fs[t], fg[t]) for t, w in layer_weights.items())
