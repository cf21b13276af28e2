"""Training steps (port of srgan_st_tpu/train/steps.py).

The JAX package's steps are pure functions of a train state; here the
state holds the modules and their optimizers, and a step updates them in
place (parameters, BatchNorm running statistics, optimizer moments) and
returns (state, metrics). Metrics are 0-dim tensors, read by the training
loop only when it logs, so a step does not wait for the device.

  * `warmup_step(state, gt_u8)` — /255 + MATLAB bicubic degradation, the
    generator forward in train mode, the weighted criterion sum, Adam.
  * `g_step(state, gt_u8)` — the same with the adversarial term, whose
    discriminator forward runs in train mode and updates D's running
    statistics (as torch does in the reference); gradients go to G only.
  * `d_step(state, gt_u8, sr)` — the every-D_UPDATE_INTERVAL
    discriminator update on (gt, smoothed real) and (sr, fake), two
    sequential train-mode forwards whose statistics chain.

Each step is a device body (`_warmup_body`, `_gan_bodies`: no host sync,
no host state) and a host part (the draws, the step counter). warmup() and
train() run chunks of batches (`make_warmup_chunk_step`,
`make_gan_chunk_step`), the JAX package's jitted `lax.scan` chunks: on
CUDA each step kind is captured once as a CUDA graph (train/graphs.py) and
replayed per batch, the counterpart of JAX's compiled chunk; the D update
and the logged metrics belong to each chunk's batch 0, as in JAX.
`make_warmup_step` and `make_gan_steps` are the same bodies run eagerly
once per call.

Data parallelism (`mesh`, a parallel/mesh.py DataParallel): each process
runs the step on its share of the global batch, and the step averages the
gradients and the criterion values over the processes (one all-reduce),
D's pre-sigmoid means before the sigmoid; BatchNorm averages its moments
itself (models/common.py). The JAX package's explicit `shard_map` step
(`_pmean_if_sharded`, steps.py:170-177), the only form torch has.

Crops and augmentation: tiles larger than GT_IMAGE_SIZE get per-sample
random crops, and DATA.AUGMENT a per-sample flip then rot90^k, on the
device. The draws (`draw_augment`) come from a torch.Generator seeded from
(DATA.SEED + 7, step, rank), the counterpart of `_aug_key`, and are passed
to `_prepare_batch`; they are not jax.random's bits.

The steps mark their regions with `utils/profiling.py` `span`: `train.chunk`
and `train.batch` (its step number as args) in the chunk steps, and in the
bodies `step.prepare`, `loss.<criterion>`, `g.backward`, `step.allreduce`,
`optim.g` / `optim.d` and `d.step` with `d.backward`.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from srgan_st_tpu_torch.losses.functions import adversarial_loss
from srgan_st_tpu_torch.ops.resize import resize_bicubic
from srgan_st_tpu_torch.utils.profiling import span


@dataclass
class GANTrainState:
    g_model: torch.nn.Module
    g_opt: "Adam"
    d_model: torch.nn.Module | None = None
    d_opt: "Adam | None" = None
    step: int = 0


def multistep_lr(base_lr: float, milestones_steps: list[int], gamma: float
                 ) -> Callable[[int], float]:
    """MultiStepLR in update counts: the lr of update k (0-based) is
    base * gamma^(number of milestones <= k), as optax counts."""
    bounds = sorted(milestones_steps)
    return lambda count: base_lr * gamma ** sum(count >= m for m in bounds)


class Adam:
    """optax.adam (or optax.adamw with weight decay) with a step schedule:
    `torch.optim.Adam` / `AdamW` stepped with the lr of each update,
    lr_fn(k) for update k. Both put eps outside the square root, as optax
    does: lr * mhat / (sqrt(vhat) + eps).

    On CUDA the optimizer is capturable (a step can be captured in a CUDA
    graph): the update count lives on the device, and the lr of each update
    is picked there from a table of lr_fn's values on the pieces between
    `bounds` (the counts where lr_fn changes), so a replay takes the lr of
    its own update. The eager CUDA step runs the same code. On the CPU the
    lr is a Python float set before each step."""

    def __init__(self, params, lr_fn: Callable[[int], float], beta1: float,
                 beta2: float, eps: float, weight_decay: float, bounds=(),
                 name: str = "optim"):
        self.params = [p for p in params if p.requires_grad]
        self.lr_fn = lr_fn
        self.name = name  # the span of its step
        self._capturable = bool(self.params) and self.params[0].is_cuda
        cls = torch.optim.AdamW if weight_decay else torch.optim.Adam
        if self._capturable:
            dev = self.params[0].device
            bounds = sorted(bounds)
            self._bounds = torch.tensor(bounds, dtype=torch.int64).to(dev)
            self._lrs = torch.tensor([lr_fn(b) for b in [0, *bounds]],
                                     dtype=torch.float32).to(dev)
            self._lr = self._lrs[:1].clone().reshape(())
            self._count = torch.zeros((), dtype=torch.int64, device=dev)
            self.opt = cls(self.params, lr=self._lr, betas=(beta1, beta2), eps=eps,
                           weight_decay=weight_decay, capturable=True, foreach=True)
        else:
            self._count = 0
            self.opt = cls(self.params, lr=lr_fn(0), betas=(beta1, beta2), eps=eps,
                           weight_decay=weight_decay)

    @property
    def count(self) -> int:
        """Updates applied (a host read of the device count on CUDA)."""
        return int(self._count)

    def step(self, grads) -> None:
        """Apply one update with `grads` (one per parameter, in order)."""
        with span(self.name):
            for p, g in zip(self.params, grads, strict=True):
                p.grad = g
            if self._capturable:
                piece = (self._count >= self._bounds).sum().reshape(1)
                self._lr.copy_(self._lrs.index_select(0, piece).reshape(()))
            else:
                for group in self.opt.param_groups:
                    group["lr"] = self.lr_fn(self._count)
            self.opt.step()
            self.opt.zero_grad(set_to_none=True)
            self._count += 1

    def state_dict(self) -> dict:
        sd = self.opt.state_dict()
        for group in sd["param_groups"]:  # the lr as a float, as on the CPU
            group["lr"] = float(group["lr"])
        return {"opt": sd, "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state["opt"])
        if self._capturable:
            self._count.fill_(int(state["count"]))
            for group in self.opt.param_groups:
                group["lr"], group["capturable"] = self._lr, True
            for st in self.opt.state.values():  # capturable keeps its steps on the device
                st["step"] = st["step"].to(device=self._count.device, dtype=torch.float32)
        else:
            self._count = int(state["count"])
            for group in self.opt.param_groups:
                group["capturable"] = False
            for st in self.opt.state.values():
                st["step"] = st["step"].to(device="cpu", dtype=torch.float32)


def make_optimizer(params, base_lr, beta1, beta2, eps, weight_decay,
                   milestones_steps, gamma, name: str = "optim") -> Adam:
    """Adam with the reference's hyperparameters — eps=1e-4, not torch's
    default (reference config.py:107,114)."""
    return Adam(params, multistep_lr(base_lr, milestones_steps, gamma), beta1, beta2,
                eps, weight_decay, bounds=milestones_steps, name=name)


def make_g_optimizer(config, params, steps_per_epoch: int, milestones: bool = True):
    ms = [m * steps_per_epoch for m in config.SCHEDULER.MILESTONES] if milestones else []
    s = config.SOLVER
    return make_optimizer(params, s.G_BASE_LR, s.G_BETA1, s.G_BETA2, s.G_EPS,
                          s.G_WEIGHT_DECAY, ms, config.SCHEDULER.GAMMA, "optim.g")


def make_d_optimizer(config, params, steps_per_epoch: int):
    """D's Adam + MultiStepLR with the milestones in D-UPDATE counts:
    ceil(steps_per_epoch / D_UPDATE_INTERVAL) D updates happen per epoch
    (steps.py:87-103)."""
    d_updates_per_epoch = -(-steps_per_epoch // config.SOLVER.D_UPDATE_INTERVAL)
    ms = [m * d_updates_per_epoch for m in config.SCHEDULER.MILESTONES]
    s = config.SOLVER
    return make_optimizer(params, s.D_BASE_LR, s.D_BETA1, s.D_BETA2, s.D_EPS,
                          s.D_WEIGHT_DECAY, ms, config.SCHEDULER.GAMMA, "optim.d")


def draw_augment(config, step: int, rank: int, batch: int, tile: tuple[int, int],
                 augment: bool) -> dict:
    """The per-sample random choices of one step on one rank, from a CPU
    torch.Generator seeded from (DATA.SEED + 7, step, rank): crop offsets
    (when the tile is larger than GT_IMAGE_SIZE) and, with `augment`, a
    flip and a rot90 count. Empty when nothing is drawn."""
    s = int(config.DATA.GT_IMAGE_SIZE)
    crop = tuple(tile) != (s, s)
    if not (crop or augment):
        return {}
    seed = np.random.SeedSequence((int(config.DATA.SEED) + 7, int(step), int(rank)))
    gen = torch.Generator().manual_seed(int(seed.generate_state(1)[0]))
    out = {}
    if crop:
        out["offsets"] = (torch.randint(0, tile[0] - s + 1, (batch,), generator=gen),
                          torch.randint(0, tile[1] - s + 1, (batch,), generator=gen))
    if augment:
        out["flip"] = torch.randint(0, 2, (batch,), generator=gen).bool()
        out["rot"] = torch.randint(0, 4, (batch,), generator=gen)
    return out


def _prepare_batch(gt, config, device, offsets=None, flip=None, rot=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 NHWC GT batch -> (gt, lr) float32 on `device`: a per-sample
    GT_IMAGE_SIZE^2 crop at `offsets` (rows, columns) of larger tiles and,
    with `flip` / `rot`, a horizontal flip then rot90^rot per sample, all
    in uint8; then /255 and MATLAB-bicubic x(1/upscale) with its
    quantization (reference dataset.py:23-32; the JAX package's
    _prepare_batch with its draws passed in)."""
    with span("step.prepare"):
        s = int(config.DATA.GT_IMAGE_SIZE)
        gt = torch.as_tensor(gt).to(device)
        if gt.shape[1] != s or gt.shape[2] != s:
            if offsets is None:
                raise ValueError(f"tile size {tuple(gt.shape[1:3])} != GT_IMAGE_SIZE {s} "
                                 "needs crop offsets")
            ar = torch.arange(s, device=device)
            rows = (offsets[0].to(device)[:, None] + ar)[:, :, None]
            cols = (offsets[1].to(device)[:, None] + ar)[:, None, :]
            gt = gt[torch.arange(gt.shape[0], device=device)[:, None, None], rows, cols]
        if flip is not None:
            gt = torch.where(flip.to(device)[:, None, None, None], gt.flip(2), gt)
            r = rot.to(device)[:, None, None, None]
            for k in (1, 2, 3):
                gt = torch.where(r == k, torch.rot90(gt, k, (1, 2)), gt)
        if gt.dtype == torch.uint8:
            # a 0-dim tensor divisor (filled on the device, no copy): CUDA divides
            # by a Python scalar as a multiply by its reciprocal, which differs
            # from x / 255 in the last bit
            gt = gt.float() / torch.full((), 255.0, device=gt.device)
        return gt, resize_bicubic(gt, 1.0 / config.DATA.UPSCALE_FACTOR, method="matlab")


def _draws(config, step: int, gt_u8, rank: int, augment: bool) -> dict:
    """draw_augment for the batch `gt_u8` at `step` on this rank."""
    return draw_augment(config, step, rank, gt_u8.shape[0], tuple(gt_u8.shape[1:3]), augment)


def _pmean_step(mesh, grads, total, values: dict):
    """Gradients, the loss and the criterion values averaged over the ranks
    in one all-reduce (the identity with one process)."""
    with span("step.allreduce") if mesh.active else contextlib.nullcontext():
        avg = mesh.pmean([*grads, total.detach(), *values.values()])
    n = len(grads)
    return avg[:n], avg[n], dict(zip(values, avg[n + 1:]))


def _no_mesh(mesh):
    from srgan_st_tpu_torch.parallel.mesh import DataParallel

    return mesh if mesh is not None else DataParallel()


def _device(state: GANTrainState) -> torch.device:
    return next(state.g_model.parameters()).device


def _criterion_sum(criterions, sr, gt, adversarial=None):
    total, values = 0.0, {}
    for name, (fn, weight) in criterions.items():
        with span(f"loss.{name}"):
            term = (adversarial(sr) if fn is None else fn(sr, gt)) * weight
            values[f"G_{name}"] = term.detach()
            total = total + term
    return total, values


def _warmup_body(config, criterions, mesh):
    """The device work of a warmup step, given the batch and its draws:
    no host sync and no host state, so that it can be captured."""

    def body(state: GANTrainState, gt_u8, draws: dict) -> dict:
        gt, lr = _prepare_batch(gt_u8, config, _device(state), **draws)
        sr = state.g_model(lr, train=True)
        total, values = _criterion_sum(criterions, sr, gt)
        with span("g.backward"):
            grads = torch.autograd.grad(total, state.g_opt.params)
        grads, total, values = _pmean_step(mesh, grads, total, values)
        state.g_opt.step(grads)
        return dict(values, G_Loss=total)

    return body


def _gan_bodies(config, criterions, mesh):
    """(g_body, d_body), the device work of a G and of a D step."""
    real_label = 1.0 - config.EXP.LABEL_SMOOTHING

    def g_body(state: GANTrainState, gt_u8, draws: dict):
        gt, lr = _prepare_batch(gt_u8, config, _device(state), **draws)
        sr = state.g_model(lr, train=True)

        def adversarial(sr_):
            return adversarial_loss(state.d_model(sr_, train=True), real_label)

        total, values = _criterion_sum(criterions, sr, gt, adversarial)
        # gradients of G's parameters only: D's are not computed
        with span("g.backward"):
            grads = torch.autograd.grad(total, state.g_opt.params)
        grads, total, values = _pmean_step(mesh, grads, total, values)
        state.g_opt.step(grads)
        return sr.detach(), dict(values, G_Loss=total)

    def d_body(state: GANTrainState, gt_u8, sr, draws: dict) -> dict:
        with span("d.step"):
            # D sees unaugmented real patches: any crop of a real tile is a real
            # patch (its draws are those of the step after the G step's)
            gt, _ = _prepare_batch(gt_u8, config, _device(state), **draws)
            sr = sr.detach()
            pred_gt = state.d_model(gt, train=True)
            pred_sr = state.d_model(sr, train=True)  # statistics chained after gt's
            d_loss = adversarial_loss(pred_gt, real_label) + adversarial_loss(pred_sr, 0.0)
            with span("d.backward"):
                grads = torch.autograd.grad(d_loss, state.d_opt.params)
            # the pre-sigmoid means averaged before the sigmoid: sigmoid of the
            # global mean (steps.py:291-297)
            with span("step.allreduce") if mesh.active else contextlib.nullcontext():
                *grads, d_loss, mean_gt, mean_sr = mesh.pmean(
                    [*grads, d_loss.detach(), pred_gt.detach().mean(),
                     pred_sr.detach().mean()])
            state.d_opt.step(grads)
            return {"D_Loss": d_loss, "D(GT)_Probability": torch.sigmoid(mean_gt),
                    "D(SR)_Probability": torch.sigmoid(mean_sr)}

    return g_body, d_body


def make_warmup_step(config, criterions, mesh=None):
    """Generator-only pretraining step (reference warmup.py:74-96), eager."""
    mesh = _no_mesh(mesh)
    augment = bool(config.DATA.AUGMENT)
    body = _warmup_body(config, criterions, mesh)

    def warmup_step(state: GANTrainState, gt_u8):
        metrics = body(state, gt_u8, _draws(config, state.step, gt_u8, mesh.rank, augment))
        state.step += 1
        return state, metrics

    return warmup_step


def make_gan_steps(config, criterions, mesh=None):
    """(g_step, d_step) for adversarial training (train.py:116-164), eager."""
    mesh = _no_mesh(mesh)
    augment = bool(config.DATA.AUGMENT)
    g_body, d_body = _gan_bodies(config, criterions, mesh)

    def g_step(state: GANTrainState, gt_u8):
        sr, metrics = g_body(state, gt_u8,
                             _draws(config, state.step, gt_u8, mesh.rank, augment))
        state.step += 1
        return state, sr, metrics

    def d_step(state: GANTrainState, gt_u8, sr):
        return state, d_body(state, gt_u8, sr,
                             _draws(config, state.step, gt_u8, mesh.rank, False))

    return g_step, d_step


# ---------------------------------------------------------------------------
# Chunked steps (the JAX package's make_warmup_chunk_step and
# make_gan_chunk_step, steps.py:310-390). JAX runs a chunk of batches as one
# jitted lax.scan, because a dispatch costs more on the host than the step's
# compute. Here each step kind (warmup, G, G + D) is captured once as a CUDA
# graph (train/graphs.py) and replayed per batch: the host enqueues one
# graph instead of thousands of kernels. The chunk keeps JAX's semantics:
# the D update runs only at the chunk's batch 0 (with that batch's sr), and
# the chunk returns batch 0's metrics, the ones the loops log. With
# `graphs` None (the CPU, or TPU.CUDA_GRAPHS false) the steps run eagerly.

def _run(graphs, kind: str, state, body, *args):
    """body(state, *args) eagerly, or as a replay of its graph."""
    if graphs is None:
        return body(state, *args)
    return graphs.run(kind, state, lambda *a: body(state, *a), *args)


def _kept(graphs, metrics: dict) -> dict:
    """Batch 0's metrics, cloned where they are a graph's static outputs
    (the next replay overwrites them)."""
    return metrics if graphs is None else {k: v.clone() for k, v in metrics.items()}


def make_warmup_chunk_step(config, criterions, mesh=None, graphs=None):
    """chunk_step(state, chunk) -> (state, metrics of batch 0): one warmup
    step per batch of the chunk (a list of batches)."""
    mesh = _no_mesh(mesh)
    augment = bool(config.DATA.AUGMENT)
    body = _warmup_body(config, criterions, mesh)

    def chunk_step(state: GANTrainState, chunk):
        metrics0 = None
        with span("train.chunk"):
            for gt in chunk:
                with span("train.batch", state.step):
                    draws = _draws(config, state.step, gt, mesh.rank, augment)
                    metrics = _run(graphs, "warmup", state, body, gt, draws)
                    state.step += 1
                    if metrics0 is None:
                        metrics0 = _kept(graphs, metrics)
        return state, metrics0

    return chunk_step


def make_gan_chunk_step(config, criterions, mesh=None, graphs=None):
    """chunk_step(state, chunk, do_d_update) -> (state, metrics of batch 0):
    K generator updates and, when do_d_update (the chunk starts on a
    D_UPDATE_INTERVAL boundary), one discriminator update on batch 0 with
    its sr (reference train.py:149-164)."""
    mesh = _no_mesh(mesh)
    augment = bool(config.DATA.AUGMENT)
    g_body, d_body = _gan_bodies(config, criterions, mesh)

    def g_only(state, gt, draws):
        return g_body(state, gt, draws)[1]

    def g_and_d(state, gt, g_draws, d_draws):
        sr, g_metrics = g_body(state, gt, g_draws)
        return {**g_metrics, **d_body(state, gt, sr, d_draws)}

    def chunk_step(state: GANTrainState, chunk, do_d_update: bool = True):
        metrics0 = None
        with span("train.chunk"):
            for i, gt in enumerate(chunk):
                with span("train.batch", state.step):
                    draws = _draws(config, state.step, gt, mesh.rank, augment)
                    if i == 0 and do_d_update:
                        d_draws = _draws(config, state.step + 1, gt, mesh.rank, False)
                        metrics = _run(graphs, "gan", state, g_and_d, gt, draws, d_draws)
                    else:
                        metrics = _run(graphs, "g", state, g_only, gt, draws)
                    state.step += 1
                    if metrics0 is None:
                        metrics0 = _kept(graphs, metrics)
        return state, metrics0

    return chunk_step


def _seeded(config, generator: torch.Generator | None) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(
        int(config.DATA.SEED))


def create_generator_state(config, g_model, steps_per_epoch: int, device,
                           milestones: bool = True,
                           generator: torch.Generator | None = None) -> GANTrainState:
    """Initialize `g_model` from a seeded CPU `torch.Generator` (DATA.SEED
    by default), move it to `device` and give it its Adam."""
    from srgan_st_tpu_torch.models.common import init_weights

    init_weights(g_model, _seeded(config, generator))
    g_model.to(device)
    return GANTrainState(g_model=g_model, g_opt=make_g_optimizer(
        config, g_model.parameters(), steps_per_epoch, milestones))


def create_gan_state(config, g_model, d_model, steps_per_epoch: int, device,
                     generator: torch.Generator | None = None) -> GANTrainState:
    """G then D initialized from one seeded generator, both on `device`."""
    from srgan_st_tpu_torch.models.common import init_weights

    gen = _seeded(config, generator)
    state = create_generator_state(config, g_model, steps_per_epoch, device,
                                   generator=gen)
    init_weights(d_model, gen)
    d_model.to(device)
    state.d_model = d_model
    state.d_opt = make_d_optimizer(config, d_model.parameters(), steps_per_epoch)
    return state

