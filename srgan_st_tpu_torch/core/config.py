"""Config for the PyTorch port.

The port's own copy of the JAX package's code-as-config `Config`
(srgan_st_tpu/core/config.py), cut to the sections and keys the serving
slice reads. Key names and defaults are the same, so a config carries over
unchanged: `TPU.*` names settings (compute dtype, tail mode, conv3 inner
factoring, tiled eval), not hardware.
"""

from __future__ import annotations


class dotdict(dict):
    """dict with attribute access, so config groups read like the reference's."""

    __getattr__ = dict.__getitem__
    __setattr__ = dict.__setitem__
    __delattr__ = dict.__delitem__
    __dir__ = dict.keys
    __repr__ = dict.__repr__


class Config:
    """Experiment configuration. Instances are independent and mutable."""

    def __init__(self) -> None:
        self.EXP = dotdict()
        self.EXP.NAME = "experiment-name"   # experiment name; output dirs are keyed by this

        self.DATA = dotdict()
        self.DATA.TEST_SET = "Set5"
        self.DATA.TEST_GT_IMAGES_DIR = f"data/{self.DATA.TEST_SET}/GTmod12"
        self.DATA.TEST_LR_IMAGES_DIR = f"data/{self.DATA.TEST_SET}/LRbicx4"
        self.DATA.TEST_SR_IMAGES_DIR = "results/_test"
        self.DATA.UPSCALE_FACTOR = 4

        self.MODEL = dotdict()
        self.MODEL.G_IN_CHANNEL = 3
        self.MODEL.G_OUT_CHANNEL = 3
        self.MODEL.G_N_CHANNEL = 64
        self.MODEL.G_N_RCB = 16

        self.TPU = dotdict()
        # "float32" (reference parity) or "bfloat16" (serving)
        self.TPU.COMPUTE_DTYPE = "float32"
        # None = auto (eval runs the unfused trunk); "xpack*" is not ported
        self.TPU.TRUNK_MODE = None
        # None = direct 9x9 stem conv, "s2d" = space-to-depth(4) factored
        self.TPU.STEM_MODE = None
        # inner factoring of the fused reconstruction conv: None / "pallas" /
        # "pallas-tiled" = the hand-written coarse conv kernel, 1 / 2 = the
        # plain torch formulations
        self.TPU.CONV3_INNER = None
        # None = composed eval tail, "fused" = the serving-tail kernel
        self.TPU.TAIL_MODE = None
        # halo-tiled eval inference (eval/tiled.py)
        self.TPU.TILED_EVAL = False
        # geometric x8 self-ensemble: waits for the eval/ensemble.py slice
        self.TPU.SELF_ENSEMBLE = False
