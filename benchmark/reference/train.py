"""The reference's training steps, plainly: the warmup step (Pixel loss
on G alone), and the GAN step (the generator's criteria with D's
adversarial term, then, on the steps that update it, D on (gt, sr) with
the smoothed real label; train.py:116-164), each followed by Adam
(eps outside the square root; config.py:107,114)."""

from __future__ import annotations

import contextlib
import importlib

import torch

from benchmark.reference import losses
from benchmark.reference.models import discriminator, generator
from benchmark.reference.resize import degrade


@contextlib.contextmanager
def full_float32():
    """Convolutions and matrix products in float32, TF32 off."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Adam:
    def __init__(self, params: dict, lr: float, beta1: float, beta2: float, eps: float):
        self.params, self.lr, self.b1, self.b2, self.eps = params, lr, beta1, beta2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: dict) -> None:
        self.t += 1
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_((1 - self.b1) * g)
            self.v[k].mul_(self.b2).add_((1 - self.b2) * g * g)
            mhat = self.m[k] / (1 - self.b1 ** self.t)
            vhat = self.v[k] / (1 - self.b2 ** self.t)
            self.params[k].sub_(self.lr * mhat / (torch.sqrt(vhat) + self.eps))


def trainable(sd: dict) -> dict:
    """The parameters of a state dict: its float tensors but the BN running
    statistics, as float32 leaves that take gradients."""
    return {k: v.detach().float().clone().requires_grad_()
            for k, v in sd.items()
            if v.is_floating_point() and not k.endswith(("running_mean", "running_var"))}


def buffers(sd: dict) -> dict:
    return {k: v.detach().float().clone() for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def generator_terms(cfg: dict, criteria: dict, g, d, content_d, sr, gt, quant):
    """{name: weight x criterion(sr, gt)} of the configured criteria."""
    terms = {}
    for name, spec in criteria.items():
        kind, w = spec["kind"], spec["weight"]
        if kind == "adversarial":
            value = losses.bce_logits(discriminator(d, sr, True, quant=quant),
                                      1.0 - cfg["label_smoothing"])
        elif kind == "pixel":
            value = (losses.mse(sr, gt) if spec.get("criterion", "mse") in ("mse", "l2")
                     else (sr - gt).abs().mean())
        elif kind == "patchwise_st":
            value = losses.patchwise_st(sr, gt)
        elif kind == "content_disc":
            value = losses.content_discriminator(sr, gt, content_d, cfg["content_disc_taps"],
                                                 quant)
        else:  # a criterion added later: reference/criterion_<kind>.py, loss(...)
            module = importlib.import_module(f"benchmark.reference.criterion_{kind}")
            value = module.loss(cfg, spec, sr, gt, quant)
        terms[name] = w * value
    return terms


def run_steps(cfg: dict, phase: str, g_sd: dict, d_sd: dict | None, batches,
              content_d: dict | None = None, quant=None) -> dict:
    """Steps of `phase` ("warmup" or "gan") from the given states, one a
    batch (uint8 NHWC GT); in "gan" D is updated at the first step, as a
    chunk starting on a D_UPDATE_INTERVAL boundary does. Returns the loss
    of each step ("G" and, at the first, "D"), the first step's gradients
    ("g_grad", "d_grad") and the parameters after the last step."""
    g = buffers(g_sd)
    g_train = trainable(g_sd)
    g.update(g_train)
    ga = cfg["g_adam"]
    g_opt = Adam(g_train, ga["lr"], ga["beta1"], ga["beta2"], ga["eps"])
    if phase == "gan":
        d = buffers(d_sd)
        d_train = trainable(d_sd)
        d.update(d_train)
        da = cfg["d_adam"]
        d_opt = Adam(d_train, da["lr"], da["beta1"], da["beta2"], da["eps"])
        criteria = cfg["criteria"]
        content = None if content_d is None else {k: v.float() for k, v in content_d.items()}
    else:
        d = d_train = content = None
        criteria = cfg["warmup_criteria"]
    out = {"loss": []}
    with full_float32():
        for step, gt_u8 in enumerate(batches):
            gt, lr = degrade(gt_u8, cfg["upscale_factor"])
            sr = generator(g, lr, True, quant)
            terms = generator_terms(cfg, criteria, g, d, content, sr, gt, quant)
            total = sum(terms.values())
            grads = torch.autograd.grad(total, list(g_train.values()))
            grads = dict(zip(g_train, grads))
            g_opt.step(grads)
            losses_now = {"G": float(total.detach())}
            if step == 0:
                out["g_grad"] = grads
            if phase == "gan" and step == 0:
                real = 1.0 - cfg["label_smoothing"]
                pred_gt = discriminator(d, gt, True, quant=quant)
                pred_sr = discriminator(d, sr.detach(), True, quant=quant)
                d_loss = losses.bce_logits(pred_gt, real) + losses.bce_logits(pred_sr, 0.0)
                d_grads = dict(zip(d_train, torch.autograd.grad(d_loss, list(d_train.values()))))
                d_opt.step(d_grads)
                out["d_grad"] = d_grads
                losses_now["D"] = float(d_loss.detach())
            out["loss"].append(losses_now)
            if step == 0:
                out["g_stats_first"] = {k: g[k].clone() for k in buffers(g_sd)}
                if d is not None:
                    out["d_stats_first"] = {k: d[k].clone() for k in buffers(d_sd)}
    out["g_params"] = {k: v.detach() for k, v in g_train.items()}
    out["g_stats"] = {k: g[k] for k in buffers(g_sd)}
    if d_train is not None:
        out["d_params"] = {k: v.detach() for k, v in d_train.items()}
        out["d_stats"] = {k: d[k] for k in buffers(d_sd)}
    return out
