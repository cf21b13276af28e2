"""Config for the PyTorch port.

The port's own copy of the JAX package's code-as-config `Config`
(srgan_st_tpu/core/config.py), cut to the sections and keys the serving and
training slices read, and its `--set GROUP.FIELD=value` CLI overrides. Key
names and defaults are the same, so a config carries over unchanged:
`TPU.*` names settings (compute dtype, trunk and tail modes, conv3 inner
factoring, tiled eval, the data-parallel layout and LOCAL_BN, chunking,
CUDA graphs, the NaN guard, remat), not hardware. `TPU.DONATE` is no key
of the port: its steps update the state in place, which is what donation
buys in JAX. `TPU.SHARD_MAP` is not a key either. `EXP.ORBAX_CHECKPOINTS`
keeps its name and writes `torch.distributed.checkpoint` directories
(train/checkpoint.py), not orbax ones.
"""

from __future__ import annotations

import os


class dotdict(dict):
    """dict with attribute access, so config groups read like the reference's."""

    __getattr__ = dict.__getitem__
    __setattr__ = dict.__setitem__
    __delattr__ = dict.__delitem__
    __dir__ = dict.keys
    __repr__ = dict.__repr__


def get_jobindex(fallback: int = 0) -> int:
    """Job index set by the cluster scheduler (reference main.py:27-30)."""
    num = os.getenv("job_index")
    return int(num) if num else fallback


class Config:
    """Experiment configuration. Instances are independent and mutable."""

    def __init__(self) -> None:
        self.EXP = dotdict()
        self.EXP.NAME = "experiment-name"   # experiment name; output dirs are keyed by this
        self.EXP.START_EPOCH = 0            # resume epoch (0 = fresh start)
        # restore results/<NAME>/last when present, even with START_EPOCH=0
        self.EXP.AUTO_RESUME = True
        # full train states as torch.distributed.checkpoint directories
        # (results/<NAME>/last/ ...), saved and restored collectively by
        # every process, instead of the coordinator's last.state.pt files
        self.EXP.ORBAX_CHECKPOINTS = False
        self.EXP.N_EPOCHS = 40              # number of training epochs
        self.EXP.LABEL_SMOOTHING = 0.1      # one-sided label smoothing: real label = 1 - s

        self.LOG_TRAIN_PERIOD = 100         # batches between train-loss log lines
        self.LOG_VALIDATION_PERIOD = 1      # epochs between validation log lines
        self.D_CHECKPOINT_INTERVAL = 100    # epochs between periodic D snapshots
        self.G_CHECKPOINT_INTERVAL = 100    # epochs between periodic G snapshots

        self.DATA = dotdict()
        self.DATA.TRAIN_GT_IMAGES_DIR = "data/train"
        self.DATA.TEST_SET = "Set5"
        self.DATA.TEST_GT_IMAGES_DIR = f"data/{self.DATA.TEST_SET}/GTmod12"
        self.DATA.TEST_LR_IMAGES_DIR = f"data/{self.DATA.TEST_SET}/LRbicx4"
        self.DATA.TEST_SR_IMAGES_DIR = "results/_test"
        self.DATA.SEED = 0
        self.DATA.UPSCALE_FACTOR = 4
        self.DATA.BATCH_SIZE = 16           # GLOBAL batch size (split over the processes)
        self.DATA.GT_IMAGE_SIZE = 96
        self.DATA.SYNTHETIC = False         # seeded synthetic patches (tests/bench)
        self.DATA.SYNTHETIC_N_BATCHES = 64  # synthetic batches per epoch
        self.DATA.PREFETCH = 2              # batches the source's thread builds ahead
        self.DATA.AUGMENT = False           # 8-way dihedral augmentation (reference has none)
        # tile size of the patches on disk (None -> GT_IMAGE_SIZE); larger
        # tiles (prepare-dataset --output_size 120) get per-sample random
        # GT_IMAGE_SIZE^2 crops on the device
        self.DATA.TILE_SIZE = None
        self.DATA.NUM_WORKERS = 4           # decode worker threads
        # GPU-resident packed dataset: the pack is copied to the device once
        # and batches are gathered there (only int64 indices cross PCIe);
        # "auto" takes it when the pack fits DEVICE_CACHE_BUDGET bytes
        self.DATA.DEVICE_CACHE = "auto"
        self.DATA.DEVICE_CACHE_BUDGET = 4 << 30

        self.MODEL = dotdict()
        self.MODEL.G_CONTINUE_FROM_WARMUP = False
        self.MODEL.G_WARMUP_WEIGHTS = ""
        self.MODEL.D_CONTINUE_FROM_WARMUP = False
        self.MODEL.D_WARMUP_WEIGHTS = ""
        self.MODEL.G_IN_CHANNEL = 3
        self.MODEL.G_OUT_CHANNEL = 3
        self.MODEL.G_N_CHANNEL = 64
        self.MODEL.G_N_RCB = 16
        self.MODEL.G_LOSS = dotdict()
        # VGG19 tap points and weights of ContentVGG (reference config.py:60-64)
        self.MODEL.G_LOSS.VGG19_LAYERS = {
            "features.17": 1 / 8,
            "features.26": 1 / 4,
            "features.35": 1 / 2,
        }
        # discriminator tap points of ContentDiscriminator (reference
        # config.py:66-69)
        self.MODEL.G_LOSS.DISC_FEATURES_LOSS_LAYERS = {
            "features.4": 1 / 4,
            "features.10": 1 / 2,
        }
        # name -> spec dict ({"kind": ..., **kwargs}); every kind but
        # "content_vgg" is built (losses/registry.py)
        self.MODEL.G_LOSS.CRITERIONS = {
            "Adversarial": {"kind": "adversarial"},
        }
        self.MODEL.G_LOSS.CRITERION_WEIGHTS = {
            "Adversarial": 0.001,
            "ContentVGG": 1.0,
            "ContentDiscriminator": 2000.0,
            "Pixel": 1.0,
            "BestBuddy": 50.0,
            "Gram": 500.0,
            "PatchwiseST": 100.0,
            "ST": 1 / 3,
        }
        self.MODEL.G_LOSS.WARMUP_CRITERIONS = {
            "Pixel": {"kind": "pixel", "criterion": "mse"},
        }
        self.MODEL.G_LOSS.WARMUP_WEIGHTS = {"Pixel": 1.0}
        # converted VGG19 IMAGENET1K_V1 weights of ContentVGG (tools/convert_vgg19.py)
        self.MODEL.G_LOSS.VGG19_WEIGHTS = "weights/vgg19_imagenet.npz"
        # D weights (npz) of ContentDiscriminator; "" = a fresh seeded D, as
        # the reference instantiates a fresh random one (loss.py:263)
        self.MODEL.G_LOSS.DISC_FEATURES_WEIGHTS = ""
        self.MODEL.D_IN_CHANNEL = 3
        self.MODEL.D_OUT_CHANNEL = 1
        self.MODEL.D_N_CHANNEL = 64

        self.SOLVER = dotdict()
        self.SOLVER.D_UPDATE_INTERVAL = 100
        self.SOLVER.D_OPTIMIZER = "Adam"
        self.SOLVER.D_BASE_LR = 1e-4
        self.SOLVER.D_BETA1 = 0.9
        self.SOLVER.D_BETA2 = 0.999
        self.SOLVER.D_WEIGHT_DECAY = 0.0
        self.SOLVER.D_EPS = 1e-4
        self.SOLVER.G_OPTIMIZER = "Adam"
        self.SOLVER.G_BASE_LR = 1e-4
        self.SOLVER.G_BETA1 = 0.9
        self.SOLVER.G_BETA2 = 0.999
        self.SOLVER.G_WEIGHT_DECAY = 0.0
        self.SOLVER.G_EPS = 1e-4

        self.SCHEDULER = dotdict()
        self.SCHEDULER.MILESTONES = [10]    # epochs at which LR is multiplied by GAMMA
        self.SCHEDULER.GAMMA = 0.5

        self.TPU = dotdict()
        # the data-parallel layout: only the 1-D ('data',) group over every
        # process (parallel/mesh.py); None -> its size is the process count
        self.TPU.MESH_SHAPE = None
        self.TPU.MESH_AXES = ("data",)
        # per-process BatchNorm normalization with a global-moment EMA
        # (torch DDP's BN semantics) instead of sync-BN; lets the kernel
        # trunks run with more than one process
        self.TPU.LOCAL_BN = False
        # "float32" (reference parity) or "bfloat16"
        self.TPU.COMPUTE_DTYPE = "float32"
        # None = auto (bf16 training: "packed" inside its gate; else the
        # unfused trunk), or
        # "unfused" / "packed" (the K4/K5 kernels) / "hybrid" (plain
        # forward, K5 backward) / "fused" (the K6 forward, train only) /
        # "xpack" ("packed" in training; in eval, kernels/xpack_trunk.py:
        # BN folded into the convs) / "xpack_eval" (eval only)
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
        # geometric x8 self-ensemble (eval/ensemble.py); composes with TILED_EVAL
        self.TPU.SELF_ENSEMBLE = False
        # batches per chunk of the training loops: the D update and the log
        # row happen at chunk starts only. None -> the natural interval
        # (D_UPDATE_INTERVAL for GAN, LOG_TRAIN_PERIOD for warmup); 1 -> per
        # batch. An override that does not divide the interval is cut to a
        # divisor of it (train/utils.py resolve_chunk_steps)
        self.TPU.CHUNK_STEPS = None
        # on CUDA, each step kind (warmup, G, G + D) is captured once as a
        # CUDA graph and replayed per batch (train/graphs.py); False keeps
        # the eager step. gloo collectives cannot be captured: a gloo run on
        # the GPU sets it False
        self.TPU.CUDA_GRAPHS = True
        # a device-side all-finite check of each chunk's metrics, read by
        # the host a chunk later (no sync); prints a warning on NaN/Inf
        self.TPU.NAN_GUARD = False
        # torch.utils.checkpoint around each residual block of the unfused
        # trunk: activations recomputed in the backward (the kernel trunks
        # keep their saved residuals)
        self.TPU.REMAT = False

    def add_g_criterion(self, name: str, spec: dict, weight: float = 1.0) -> None:
        """Add a generator criterion spec (reference config.py:122-131)."""
        self.MODEL.G_LOSS.CRITERIONS[name] = spec
        self.MODEL.G_LOSS.CRITERION_WEIGHTS[name] = weight

    def remove_g_criterion(self, name: str) -> None:
        if name in self.MODEL.G_LOSS.CRITERIONS:
            del self.MODEL.G_LOSS.CRITERIONS[name]
            del self.MODEL.G_LOSS.CRITERION_WEIGHTS[name]

    def get_all_params(self) -> str:
        """Stringify every config group for experiment provenance logging."""
        params = [
            getattr(self, attr)
            for attr in sorted(dir(self))
            if not callable(getattr(self, attr)) and not attr.startswith("__")
        ]
        return str(params)


def _coerce_like(raw: str, current) -> object:
    """Parse a CLI string as the type of the field it replaces."""
    if isinstance(current, bool):  # before int: bool is an int subclass
        lowered = raw.lower()
        if lowered in ("1", "true", "yes", "on"):
            return True
        if lowered in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"expected a boolean, got {raw!r}")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, str):
        return raw
    # None / lists / dicts: accept any python literal ("none" -> None)
    import ast

    if raw.lower() in ("none", "null"):
        return None
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        return raw


def parse_driver_cli(argv, description: str,
                     set_example: str = "--set TPU.COMPUTE_DTYPE=bfloat16"):
    """Shared flag surface of the warmup and train CLIs: common knobs as
    flags, ``--set GROUP.FIELD=value`` for everything else, and
    ``--device`` (default cuda). Returns (config, device)."""
    import argparse

    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("--exp_name", type=str, default=None)
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--batch_size", type=int, default=None)
    parser.add_argument("--train_dir", type=str, default=None,
                        help="training GT images/patches directory")
    parser.add_argument("--set", action="append", default=[],
                        metavar="GROUP.FIELD=VALUE",
                        help="override any config field (repeatable), e.g. "
                        f"{set_example}")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda)")
    args = parser.parse_args(argv)

    config = Config()
    if args.exp_name is not None:
        config.EXP.NAME = args.exp_name
    if args.epochs is not None:
        config.EXP.N_EPOCHS = args.epochs
    if args.batch_size is not None:
        config.DATA.BATCH_SIZE = args.batch_size
    if args.train_dir is not None:
        config.DATA.TRAIN_GT_IMAGES_DIR = args.train_dir
    return apply_overrides(config, args.set), args.device


def _descend(path: str, parts, depth: int, obj, part: str):
    """Resolve one component of a ``--set`` path with friendly errors."""
    prefix = ".".join(parts[:depth]) or "the config root"
    if isinstance(obj, dict):
        if part in obj:
            return obj[part]
        valid = ", ".join(map(str, obj))
        raise SystemExit(
            f"--set {path}: {prefix} has no entry {part!r} (entries: {valid})"
        )
    if not hasattr(obj, "__dict__"):
        raise SystemExit(
            f"--set {path}: {prefix} is a plain {type(obj).__name__} value "
            f"and has no sub-field {part!r}"
        )
    try:
        return getattr(obj, part)
    except AttributeError:
        valid = ", ".join(k for k in vars(obj) if not k.startswith("_"))
        raise SystemExit(
            f"--set {path}: no such config field (siblings: {valid})"
        ) from None


def apply_overrides(config: Config, assignments) -> Config:
    """Apply ``GROUP.FIELD=value`` overrides onto a Config in place. The
    path must name an existing field and the value is parsed as the type
    of the field it replaces. Returns the config."""
    for assignment in assignments or ():
        path, sep, raw = assignment.partition("=")
        if not sep:
            raise SystemExit(f"--set expects PATH=VALUE, got {assignment!r}")
        parts = path.split(".")
        obj = config
        for depth, part in enumerate(parts[:-1]):
            obj = _descend(path, parts, depth, obj, part)
        leaf = parts[-1]
        current = _descend(path, parts, len(parts) - 1, obj, leaf)
        try:
            value = _coerce_like(raw, current)
        except ValueError as e:
            raise SystemExit(f"--set {path}={raw!r}: {e}") from None
        if isinstance(obj, dict):
            obj[leaf] = value
        else:
            setattr(obj, leaf, value)
    return config
