"""Adversarial (GAN) training loop (port of srgan_st_tpu/train/train.py).

Mirrors reference train.py:16-226: G and D Adam (eps=1e-4) with the
MultiStep LR halving at epoch 10 (D's milestones in D-update counts), one-
sided label smoothing, the criterion-sum generator update every batch, the
discriminator update on batches with batch_num % D_UPDATE_INTERVAL == 0
with that batch's sr, validation at each epoch end, the reference's scalar
names, the warmup warm-start flags, and the g/d last/best/epoch
checkpoints. The epoch runs in chunks of D_UPDATE_INTERVAL batches
(TPU.CHUNK_STEPS), the JAX package's loop: the D update and the log row
only at chunk starts, on CUDA each step a replay of its captured graph
(train/graphs.py, TPU.CUDA_GRAPHS); TPU.NAN_GUARD checks each chunk's
metrics. Runs on CUDA unless `device` says otherwise. With several processes (parallel/distributed.py) each runs on
its own GPU with its share of every batch, and only the coordinator
validates and writes npz files, scalars and `.state.pt` train states while
the others wait at a barrier; with EXP.ORBAX_CHECKPOINTS every process
takes part in the train-state save.
"""

from __future__ import annotations

import os

from srgan_st_tpu_torch.data.pipeline import make_train_source
from srgan_st_tpu_torch.losses.registry import build_criterions
from srgan_st_tpu_torch.models.discriminator import Discriminator
from srgan_st_tpu_torch.models.generator import Generator
from srgan_st_tpu_torch.train.checkpoint import (
    CheckpointPolicy,
    discriminator_state_dict_from_variables,
    generator_state_dict_from_variables,
    load_params_npz,
    save_variables_npz,
    variables_from_discriminator_state_dict,
    variables_from_generator_state_dict,
)
from srgan_st_tpu_torch.train.logging import ExperimentWriter
from srgan_st_tpu_torch.train.graphs import step_graphs
from srgan_st_tpu_torch.train.steps import create_gan_state, make_gan_chunk_step
from srgan_st_tpu_torch.parallel.distributed import is_coordinator
from srgan_st_tpu_torch.train.utils import (
    iter_chunks, make_test_pairs, resolve_chunk_steps, setup_run,
)
from srgan_st_tpu_torch.utils.debugging import nan_guard
from srgan_st_tpu_torch.train.warmup import resume, validate_epoch

_D_KEYS = ("D_Loss", "D(GT)_Probability", "D(SR)_Probability")


def _warm_start(model, path: str, to_variables, from_variables) -> None:
    """Load npz weights with the tolerant merge: keys missing from the file
    or of another shape keep the model's values (reference train.py:90-96)."""
    current = to_variables(model.state_dict())
    model.load_state_dict(from_variables(load_params_npz(path, current)), strict=False)


def train(config, device=None):
    dev, mesh = setup_run(config, device)
    coord = is_coordinator()
    source = make_train_source(config, device=dev)
    steps_per_epoch = len(source)
    criterions = build_criterions(config)
    state = create_gan_state(config, Generator.from_config(config, group=mesh),
                             Discriminator.from_config(config, group=mesh),
                             steps_per_epoch, dev)
    if config.MODEL.G_CONTINUE_FROM_WARMUP:
        _warm_start(state.g_model, config.MODEL.G_WARMUP_WEIGHTS,
                    variables_from_generator_state_dict, generator_state_dict_from_variables)
    if config.MODEL.D_CONTINUE_FROM_WARMUP:
        _warm_start(state.d_model, config.MODEL.D_WARMUP_WEIGHTS,
                    variables_from_discriminator_state_dict,
                    discriminator_state_dict_from_variables)

    writer = ExperimentWriter(config)
    results_dir = f"results/{config.EXP.NAME}"
    policy = CheckpointPolicy(results_dir, config.G_CHECKPOINT_INTERVAL,
                              use_orbax=config.EXP.ORBAX_CHECKPOINTS)
    test_pairs = make_test_pairs(config)
    start_epoch = resume(config, policy, state, steps_per_epoch, mesh)
    mesh.broadcast_module(state.g_model)
    mesh.broadcast_module(state.d_model)

    # chunks of D_UPDATE_INTERVAL batches: the D update and the logged
    # metrics land on each chunk's first batch, the reference's cadence
    # (train.py:149,169)
    chunk_size = resolve_chunk_steps(config, config.SOLVER.D_UPDATE_INTERVAL,
                                     steps_per_epoch)
    chunk_step = make_gan_chunk_step(config, criterions, mesh,
                                     step_graphs(config, dev, mesh))
    guard = nan_guard(chunk_step) if config.TPU.NAN_GUARD else None
    for epoch in range(start_epoch, config.EXP.N_EPOCHS):
        print(f"Beginning train epoch: {epoch+1}")
        batch_num = 0
        d_vals = {}
        for chunk in iter_chunks(source, epoch, chunk_size):
            do_d = batch_num % config.SOLVER.D_UPDATE_INTERVAL == 0
            state, metrics = (guard or chunk_step)(state, chunk, do_d)
            if batch_num % config.LOG_TRAIN_PERIOD == 0:
                if "D_Loss" in metrics:
                    d_vals = {k: metrics[k] for k in _D_KEYS}
                batches_done = batch_num + epoch * steps_per_epoch
                for name, val in {**d_vals, **metrics}.items():
                    writer.add_scalar(f"Train/{name}", val, batches_done)
                print(f"[Epoch {epoch+1}/{config.EXP.N_EPOCHS}] "
                      f"[Batch {batch_num}/{steps_per_epoch}] "
                      f"[D loss: {float(d_vals.get('D_Loss', float('nan')))}] "
                      f"[G loss: {float(metrics['G_Loss'])}]")
            batch_num += len(chunk)
        if guard is not None:
            guard.flush()

        psnr = ssim = float("nan")
        if coord:
            psnr, ssim, g_variables = validate_epoch(config, state, test_pairs, writer,
                                                     epoch, dev)
            d_variables = variables_from_discriminator_state_dict(state.d_model.state_dict())
            save_variables_npz(os.path.join(results_dir, "g_last.npz"), g_variables)
            save_variables_npz(os.path.join(results_dir, "d_last.npz"), d_variables)
        # the npz files are the coordinator's; a collective (DCP) train-state
        # save is every process's, with the coordinator's metrics
        is_best = (policy.save_epoch(state, epoch, psnr, ssim)
                   if coord or policy.collective else False)
        if coord:
            if is_best:
                save_variables_npz(os.path.join(results_dir, "g_best.npz"), g_variables)
                save_variables_npz(os.path.join(results_dir, "d_best.npz"), d_variables)
            if 0 < epoch and epoch % config.G_CHECKPOINT_INTERVAL == 0:
                save_variables_npz(os.path.join(results_dir, f"g_epoch{epoch}.npz"), g_variables)
            if 0 < epoch and epoch % config.D_CHECKPOINT_INTERVAL == 0:
                save_variables_npz(os.path.join(results_dir, f"d_epoch{epoch}.npz"), d_variables)
        mesh.barrier()

    writer.close()
    return state


def cli(argv=None) -> None:
    """``python -m srgan_st_tpu_torch train``: flags for the common knobs,
    ``--set GROUP.FIELD=value`` for everything else, ``--device``."""
    from srgan_st_tpu_torch.core.config import parse_driver_cli

    config, device = parse_driver_cli(
        argv, description="Adversarial (GAN) training phase. Starts from the "
        "warmup checkpoint configured in MODEL.G_WARMUP_WEIGHTS when "
        "MODEL.G_CONTINUE_FROM_WARMUP is set.",
        set_example="--set TPU.COMPUTE_DTYPE=bfloat16 --set EXP.N_EPOCHS=20")
    train(config, device)


if __name__ == "__main__":
    cli()
