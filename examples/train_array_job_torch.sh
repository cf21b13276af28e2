#!/bin/bash
# Array-job experiment launcher of the PyTorch port: examples/train_array_job.sh
# for `python -m srgan_st_tpu_torch run` (the reference's train.sh, an LSF
# #BSUB array over 5 experiment variants), written scheduler-agnostically:
# anything that sets $job_index works.
#
# SLURM:  sbatch --array=0-4 --gres=gpu:1 examples/train_array_job_torch.sh
#         (job_index is derived from SLURM_ARRAY_TASK_ID below)
# LSF:    bsub -J "TRAIN-SRGAN-ST[1-5]%5" < examples/train_array_job_torch.sh
#         (job_index = LSB_JOBINDEX - 1)
# Plain:  for i in 0 1 2 3 4; do job_index=$i bash examples/train_array_job_torch.sh; done
#
# Each run is an independent experiment on one GPU (the runs never
# communicate, matching the reference). Arguments are passed on to the
# command, e.g. `--set EXP.N_EPOCHS=10` or `--device cpu`.

set -euo pipefail

if [[ -n "${SLURM_ARRAY_TASK_ID:-}" ]]; then
    export job_index="$SLURM_ARRAY_TASK_ID"
elif [[ -n "${LSB_JOBINDEX:-}" ]]; then
    export job_index="$((LSB_JOBINDEX - 1))"
fi
export job_index="${job_index:-0}"

echo "starting job_index=$job_index on $(hostname)"
python -m srgan_st_tpu_torch run "$@"
