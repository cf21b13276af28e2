"""The benchmark of the PyTorch/CUDA port (srgan_st_tpu_torch): run
`python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1`
from the root of a checkout. See harness.py for how its files are found."""
