"""Experiment logging (port of srgan_st_tpu/train/logging.py).

A TensorBoard writer per experiment at `tensorboard/{EXP.NAME}` with the
reference's scalar names (Train/G_Loss, Train/G_{criterion}, Train/D_Loss,
Train/D(GT)_Probability, Train/D(SR)_Probability, Test/PSNR, Test/SSIM)
and the config text under Config/Params. Without tensorboardX the scalars
go to `scalars.jsonl` in the same directory, a line at a time (the JAX
package's file is block-buffered). With several processes only the
coordinator writes.
"""

from __future__ import annotations

import json
import os
import time


class ExperimentWriter:
    def __init__(self, config, log_dir: str | None = None):
        from srgan_st_tpu_torch.parallel.distributed import is_coordinator

        self._tb = self._jsonl = None
        self._enabled = is_coordinator()
        if not self._enabled:
            return
        self.log_dir = log_dir or os.path.join("tensorboard", config.EXP.NAME)
        os.makedirs(self.log_dir, exist_ok=True)
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            # line-buffered: a run killed mid-epoch keeps every row it logged
            self._jsonl = open(os.path.join(self.log_dir, "scalars.jsonl"), "a", buffering=1)
        else:
            self._tb = SummaryWriter(self.log_dir)
            self._tb.add_text("Config/Params", config.get_all_params())

    def add_scalar(self, tag: str, value, step: int) -> None:
        if not self._enabled:
            return
        value = float(value)
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)
        else:
            self._jsonl.write(json.dumps(
                {"ts": time.time(), "tag": tag, "value": value, "step": step}) + "\n")

    def close(self) -> None:
        if not self._enabled:
            return
        if self._tb is not None:
            self._tb.close()
        else:
            self._jsonl.close()
