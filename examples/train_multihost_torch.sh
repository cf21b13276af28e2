#!/usr/bin/env bash
# Multi-process data-parallel training launch of the PyTorch port
# (srgan_st_tpu_torch/parallel/distributed.py).
#
# One process per GPU. The training loops call `initialize_distributed()` at entry,
# which joins the process group from the three SRGAN_ST_* variables (or
# torchrun's RANK / WORLD_SIZE / MASTER_ADDR): NCCL between GPUs, gloo on
# the CPU. Each process runs on its own GPU (LOCAL_RANK, else the process
# id modulo the GPUs) with its contiguous slice of every global batch, and
# only process 0 validates and writes npz files and TensorBoard events;
# with EXP.ORBAX_CHECKPOINTS every process takes part in the train-state
# save. The processes must share the results directory (a resumed run
# restores from it on every rank).
#
# Example: 2 hosts with 8 GPUs each, coordinator on host0 — 16 processes,
# each given its own id:
#
#   host0$ SRGAN_ST_COORDINATOR=host0:8476 SRGAN_ST_NUM_PROCESSES=16 \
#          SRGAN_ST_PROCESS_ID=<0..7> LOCAL_RANK=<0..7> python train_job.py
#   host1$ SRGAN_ST_COORDINATOR=host0:8476 SRGAN_ST_NUM_PROCESSES=16 \
#          SRGAN_ST_PROCESS_ID=<8..15> LOCAL_RANK=<0..7> python train_job.py
#
# or with torchrun on each host:
#
#   torchrun --nnodes=2 --nproc_per_node=8 --rdzv_backend=c10d \
#            --rdzv_endpoint=host0:8476 train_job.py
#
# or on one host, with this script: LOCAL_PROCESSES=8 bash
# examples/train_multihost_torch.sh train_job.py (ranks 0..7 here, the
# coordinator on 127.0.0.1:$COORDINATOR_PORT).
#
# train_job.py is any training script, e.g.:
#
#   from srgan_st_tpu_torch.core.config import Config
#   from srgan_st_tpu_torch.train.train import train
#   config = Config()
#   config.DATA.TRAIN_GT_IMAGES_DIR = "data/train"   # shared filesystem
#   config.DATA.BATCH_SIZE = 16 * <total GPUs>       # global batch
#   config.TPU.LOCAL_BN = True                       # per-rank BN statistics
#   config.TPU.COMPUTE_DTYPE = "bfloat16"            # the bf16 training step
#   config.TPU.TRUNK_MODE = "packed"                 # the K4/K5 trunk kernels
#   train(config)
#
# LOCAL_BN normalizes each rank's share of the batch by its own moments
# (the running statistics still take the global ones), which the kernel
# trunks need with more than one rank; sync-BN, the default, keeps the
# single-device normalization and runs the unfused trunk. The JAX
# package's TPU.SHARD_MAP has no counterpart here: the port rejects it.
#
# Under SLURM (one task per GPU), the variables come from the job:

set -euo pipefail

: "${COORDINATOR_PORT:=8476}"
job="${1:-train_job.py}"

if [ -n "${SLURM_PROCID:-}" ]; then
    head=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n1)
    export SRGAN_ST_COORDINATOR="${head}:${COORDINATOR_PORT}"
    export SRGAN_ST_NUM_PROCESSES="${SLURM_NTASKS}"
    export SRGAN_ST_PROCESS_ID="${SLURM_PROCID}"
    export LOCAL_RANK="${SLURM_LOCALID:-0}"
fi

if [ -n "${LOCAL_PROCESSES:-}" ]; then
    export SRGAN_ST_COORDINATOR="127.0.0.1:${COORDINATOR_PORT}"
    export SRGAN_ST_NUM_PROCESSES="$LOCAL_PROCESSES"
    pids=()
    for ((i = 0; i < LOCAL_PROCESSES; i++)); do
        SRGAN_ST_PROCESS_ID=$i LOCAL_RANK=$i python "$job" &
        pids+=($!)
    done
    status=0
    for pid in "${pids[@]}"; do
        wait "$pid" || status=$?
    done
    exit "$status"
fi

exec python "$job"
