"""The PyTorch/CUDA port's bench: bench.py's rows, configs, data and
protocol on one GPU, a thin front end of `srgan_st_tpu_torch.tools.bench`.

Usage:
    python3 bench_torch.py                 # one JSON line: the headline row
    python3 bench_torch.py --only NAME     # one row (e2e-packed, infer-4k, ...)
    python3 bench_torch.py --suite         # seven lines and BENCH_SUITE_torch.md
    python3 bench_torch.py ... --device cpu

Runs on the GPU unless `--device cpu`. bench.py stays the JAX package's
bench.
"""

from __future__ import annotations

from srgan_st_tpu_torch.tools.bench import main

if __name__ == "__main__":
    main()
