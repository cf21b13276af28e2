"""Generator pretraining ("SRResNet" warmup) loop (port of
srgan_st_tpu/train/warmup.py).

Mirrors reference warmup.py:14-148: Adam on G only (no LR schedule), the
WARMUP_CRITERIONS set (default pixel MSE), validation at each epoch end,
the reference's scalar names, and the g_last / g_best / g_epoch{N} npz
checkpoints beside the full train state of `CheckpointPolicy`. The epoch
runs in chunks of LOG_TRAIN_PERIOD batches (TPU.CHUNK_STEPS), the JAX
package's loop: on CUDA each step a replay of its captured graph
(train/graphs.py, TPU.CUDA_GRAPHS), the logged metrics those of each
chunk's batch 0; TPU.NAN_GUARD checks them. Runs on CUDA unless `device`
says otherwise. With several
processes (parallel/distributed.py) each runs on its own GPU with its share
of every batch, and only the coordinator validates and writes npz files,
scalars and `.state.pt` train states while the others wait at a barrier;
with EXP.ORBAX_CHECKPOINTS every process takes part in the train-state
save and restore.
"""

from __future__ import annotations

import os

from srgan_st_tpu_torch.data.pipeline import make_train_source
from srgan_st_tpu_torch.eval.validate import make_generator_apply, validate
from srgan_st_tpu_torch.losses.registry import build_warmup_criterions
from srgan_st_tpu_torch.models.generator import Generator
from srgan_st_tpu_torch.train.checkpoint import (
    CheckpointPolicy,
    save_variables_npz,
    variables_from_generator_state_dict,
)
from srgan_st_tpu_torch.train.logging import ExperimentWriter
from srgan_st_tpu_torch.train.graphs import step_graphs
from srgan_st_tpu_torch.train.steps import create_generator_state, make_warmup_chunk_step
from srgan_st_tpu_torch.parallel.distributed import is_coordinator
from srgan_st_tpu_torch.train.utils import (
    iter_chunks, make_test_pairs, resolve_chunk_steps, setup_run,
)
from srgan_st_tpu_torch.utils.debugging import nan_guard


def resume(config, policy: CheckpointPolicy, state, steps_per_epoch: int,
           mesh=None) -> int:
    """The epoch to start from: from the restored `last` state's step
    when one fits (EXP.AUTO_RESUME, or START_EPOCH > 0), else START_EPOCH.
    Every process restores from the results directory the coordinator
    writes (every process, under EXP.ORBAX_CHECKPOINTS), so the processes
    of a run must share it: ranks that would start at different epochs
    raise."""
    start_epoch = config.EXP.START_EPOCH
    if (start_epoch > 0 or config.EXP.AUTO_RESUME) and policy.restore_latest(state):
        start_epoch = state.step // steps_per_epoch
        if start_epoch != config.EXP.START_EPOCH:
            print(f"resuming at epoch {start_epoch} (from checkpoint step), "
                  f"not START_EPOCH={config.EXP.START_EPOCH}")
    if mesh is not None and mesh.active:
        import torch

        mean = mesh.pmean([torch.tensor([float(start_epoch)],
                                        device=next(state.g_model.parameters()).device)])[0]
        if float(mean) != start_epoch:
            raise RuntimeError(
                f"rank {mesh.rank} would resume at epoch {start_epoch}, the ranks' mean is "
                f"{float(mean)}: the processes must share results/{config.EXP.NAME}")
    return start_epoch


def validate_epoch(config, state, test_pairs, writer, epoch: int, device):
    """PSNR/SSIM of the generator's eval mode on the test pairs; returns
    (psnr, ssim, the JAX-format variables tree)."""
    variables = variables_from_generator_state_dict(state.g_model.state_dict())
    psnr, ssim = validate(make_generator_apply(config, variables, device=device),
                          test_pairs, config)
    if epoch % config.LOG_VALIDATION_PERIOD == 0:
        print(f"[Test: {epoch+1}/{config.EXP.N_EPOCHS}] [PSNR: {psnr}] [SSIM: {ssim}]")
    writer.add_scalar("Test/PSNR", psnr, epoch + 1)
    writer.add_scalar("Test/SSIM", ssim, epoch + 1)
    return psnr, ssim, variables


def warmup(config, device=None):
    dev, mesh = setup_run(config, device)
    coord = is_coordinator()
    source = make_train_source(config, device=dev)
    steps_per_epoch = len(source)
    criterions = build_warmup_criterions(config)
    state = create_generator_state(config, Generator.from_config(config, group=mesh),
                                   steps_per_epoch, dev, milestones=False)

    writer = ExperimentWriter(config)
    results_dir = f"results/{config.EXP.NAME}"
    policy = CheckpointPolicy(results_dir, config.G_CHECKPOINT_INTERVAL,
                              use_orbax=config.EXP.ORBAX_CHECKPOINTS)
    test_pairs = make_test_pairs(config)
    start_epoch = resume(config, policy, state, steps_per_epoch, mesh)
    mesh.broadcast_module(state.g_model)

    # chunks of LOG_TRAIN_PERIOD batches; the metrics are the chunk's first
    # batch's, the one the reference logs (warmup.py:101-110)
    chunk_size = resolve_chunk_steps(config, config.LOG_TRAIN_PERIOD, steps_per_epoch)
    chunk_step = make_warmup_chunk_step(config, criterions, mesh,
                                        step_graphs(config, dev, mesh))
    guard = nan_guard(chunk_step) if config.TPU.NAN_GUARD else None
    batches_done = start_epoch * steps_per_epoch
    for epoch in range(start_epoch, config.EXP.N_EPOCHS):
        print(f"Beginning train epoch: {epoch+1}")
        for chunk in iter_chunks(source, epoch, chunk_size):
            batch_num = batches_done % steps_per_epoch
            # the reference logs batch 0 at batches_done after its
            # increment (warmup.py:75,105)
            log_step = batches_done + 1
            batches_done += len(chunk)
            state, metrics = (guard or chunk_step)(state, chunk)
            if batch_num % config.LOG_TRAIN_PERIOD != 0:
                continue
            for name, val in metrics.items():
                writer.add_scalar(f"Train/{name}", val, log_step)
            print(f"[Epoch {epoch+1}/{config.EXP.N_EPOCHS}] "
                  f"[Batch {batch_num}/{steps_per_epoch}] "
                  f"[G loss: {float(metrics['G_Loss'])}]")
        if guard is not None:
            guard.flush()

        psnr = ssim = float("nan")
        if coord:
            psnr, ssim, g_variables = validate_epoch(config, state, test_pairs, writer,
                                                     epoch, dev)
            save_variables_npz(os.path.join(results_dir, "g_last.npz"), g_variables)
        # the npz files are the coordinator's; a collective (DCP) train-state
        # save is every process's, with the coordinator's metrics
        is_best = (policy.save_epoch(state, epoch, psnr, ssim)
                   if coord or policy.collective else False)
        if coord:
            if is_best:
                save_variables_npz(os.path.join(results_dir, "g_best.npz"), g_variables)
            if 0 < epoch and epoch % config.G_CHECKPOINT_INTERVAL == 0:
                save_variables_npz(os.path.join(results_dir, f"g_epoch{epoch}.npz"),
                                   g_variables)
        mesh.barrier()

    writer.close()
    return state


def cli(argv=None) -> None:
    """``python -m srgan_st_tpu_torch warmup``; same flags as train.cli."""
    from srgan_st_tpu_torch.core.config import parse_driver_cli

    config, device = parse_driver_cli(
        argv, description="PSNR-oriented SRResNet warmup phase (pixel loss only); "
        "produces the generator checkpoint the GAN phase starts from.",
        set_example="--set TPU.COMPUTE_DTYPE=bfloat16 --set DATA.SYNTHETIC=true")
    warmup(config, device)


if __name__ == "__main__":
    cli()
