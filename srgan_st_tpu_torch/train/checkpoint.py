"""Checkpoints (port of srgan_st_tpu/train/checkpoint.py).

* npz weight files in the JAX package's format: flat archives keyed by the
  '/'-joined path of the variables tree ({"params", "batch_stats"}), so a
  `g_best.npz` written by the JAX package loads here and the reverse.
* the weight carry-over between those variables trees (HWIO kernels,
  scalar PReLU slopes, BN scale/bias + mean/var, D's (H, W, C) flatten)
  and the port's torch state_dicts (OIHW, (1,) slopes, BatchNorm2d keys,
  (C, H, W) flatten) — the mapping of tools/import_torch_checkpoint.py.
* full train states (models, optimizers, step) saved with `torch.save`
  (`.state.pt`, the default), or as `torch.distributed.checkpoint`
  directories loaded in place (EXP.ORBAX_CHECKPOINTS, collective over the
  processes), and the last / best / epoch{N} policy over them
  (`CheckpointPolicy`). Neither is the JAX package's train-state format
  (`.state.npz` or orbax): train states do not cross between the packages;
  weights cross through the npz files.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any

import numpy as np
import torch


def _flatten(tree: Any, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def save_variables_npz(path: str, variables: Any) -> None:
    """Save a variables tree (params / batch_stats / ...) to npz."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten(variables))


def load_params_npz(path: str, target: Any | None = None) -> dict:
    """Load an npz variables tree. With `target` given, behaves like the
    reference's tolerant loader (utils.py:25-59): keys absent from the
    target or with mismatched shapes are dropped, and the target's values
    are kept for them."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with np.load(path) as data:
        loaded = _unflatten({k: data[k] for k in data.files})
    return loaded if target is None else merge_tolerant(target, loaded)


def merge_tolerant(target: Any, loaded: Any) -> Any:
    """`target` with each leaf replaced by `loaded`'s leaf at the same path
    when that has the same shape (the rule of `load_params_npz`)."""
    if not isinstance(target, dict):
        if isinstance(loaded, dict):
            return target
        return loaded if np.shape(loaded) == np.shape(target) else target
    return {k: (merge_tolerant(v, loaded[k]) if isinstance(loaded, dict) and k in loaded
                else v) for k, v in target.items()}


# ---------------------------------------------------------------------------
# weight carry-over: JAX variables tree <-> torch state_dict

def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def generator_state_dict_from_variables(variables: dict) -> dict[str, torch.Tensor]:
    """JAX generator variables {"params", "batch_stats"} -> the port's
    (and the reference's) generator state_dict."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: dict[str, torch.Tensor] = {}

    def conv(key, tree):
        sd[f"{key}.weight"] = _t(np.asarray(tree["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in tree:
            sd[f"{key}.bias"] = _t(tree["bias"])

    def prelu(key, tree):
        sd[f"{key}.weight"] = _t(np.asarray(tree["alpha"]).reshape(1))

    def bn(key, p, s):
        sd[f"{key}.weight"] = _t(p["scale"])
        sd[f"{key}.bias"] = _t(p["bias"])
        sd[f"{key}.running_mean"] = _t(s["mean"])
        sd[f"{key}.running_var"] = _t(s["var"])
        sd[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)

    conv("conv1.0", params["conv1"])
    prelu("conv1.1", params["prelu1"])
    num_rcb = sum(1 for k in params if re.fullmatch(r"rcb\d+", k))
    for i in range(num_rcb):
        p, s, base = params[f"rcb{i}"], stats[f"rcb{i}"], f"trunk.{i}.rcb"
        conv(f"{base}.0", p["conv1"])
        bn(f"{base}.1", p["bn1"], s["bn1"])
        prelu(f"{base}.2", p["prelu"])
        conv(f"{base}.3", p["conv2"])
        bn(f"{base}.4", p["bn2"], s["bn2"])
    conv("conv2.0", params["conv2"])
    bn("conv2.1", params["bn2"], stats["bn2"])
    i = 0
    while f"up{i}" in params:
        conv(f"upsampling.{i}.upsample_block.0", params[f"up{i}"]["conv"])
        prelu(f"upsampling.{i}.upsample_block.2", params[f"up{i}"]["prelu"])
        i += 1
    conv("conv3", params["conv3"])
    return sd


def variables_from_generator_state_dict(state_dict: dict) -> dict:
    """The port's (or the reference's) generator state_dict -> the JAX
    variables tree {"params", "batch_stats"} of float32 numpy arrays."""
    sd = {k: v.detach().cpu().float().numpy() for k, v in state_dict.items()
          if not k.endswith("num_batches_tracked")}

    def conv(key):
        out = {"kernel": sd[f"{key}.weight"].transpose(2, 3, 1, 0).copy()}
        if f"{key}.bias" in sd:
            out["bias"] = sd[f"{key}.bias"]
        return out

    def prelu(key):
        return {"alpha": sd[f"{key}.weight"].reshape(())}

    def bn(key):
        return ({"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]},
                {"mean": sd[f"{key}.running_mean"], "var": sd[f"{key}.running_var"]})

    params: dict = {"conv1": conv("conv1.0"), "prelu1": prelu("conv1.1")}
    stats: dict = {}
    i = 0
    while f"trunk.{i}.rcb.0.weight" in sd:
        base = f"trunk.{i}.rcb"
        p1, s1 = bn(f"{base}.1")
        p2, s2 = bn(f"{base}.4")
        params[f"rcb{i}"] = {"conv1": conv(f"{base}.0"), "bn1": p1,
                             "prelu": prelu(f"{base}.2"),
                             "conv2": conv(f"{base}.3"), "bn2": p2}
        stats[f"rcb{i}"] = {"bn1": s1, "bn2": s2}
        i += 1
    params["conv2"] = conv("conv2.0")
    params["bn2"], stats["bn2"] = bn("conv2.1")
    i = 0
    while f"upsampling.{i}.upsample_block.0.weight" in sd:
        params[f"up{i}"] = {"conv": conv(f"upsampling.{i}.upsample_block.0"),
                            "prelu": prelu(f"upsampling.{i}.upsample_block.2")}
        i += 1
    params["conv3"] = conv("conv3")
    return {"params": params, "batch_stats": stats}


def discriminator_state_dict_from_variables(variables: dict) -> dict[str, torch.Tensor]:
    """JAX discriminator variables {"params", "batch_stats"} -> the port's
    (and the reference's) discriminator state_dict. fc1's input rows go
    from the JAX (H, W, C) flatten to torch's (C, H, W), as in
    tools/import_torch_checkpoint.py."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    sd: dict[str, torch.Tensor] = {}
    p0 = params["conv0"]
    sd["features.0.weight"] = _t(np.asarray(p0["kernel"]).transpose(3, 2, 0, 1))
    sd["features.0.bias"] = _t(p0["bias"])
    i = 1
    while f"conv{i}" in params:
        sd[f"features.{3 * i - 1}.weight"] = _t(
            np.asarray(params[f"conv{i}"]["kernel"]).transpose(3, 2, 0, 1))
        bn, st = params[f"bn{i}"], stats[f"bn{i}"]
        key = f"features.{3 * i}"
        sd[f"{key}.weight"], sd[f"{key}.bias"] = _t(bn["scale"]), _t(bn["bias"])
        sd[f"{key}.running_mean"], sd[f"{key}.running_var"] = _t(st["mean"]), _t(st["var"])
        sd[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)
        i += 1
    k1 = np.asarray(params["fc1"]["kernel"])  # (H*W*C, 1024), rows (h, w, c)
    c = k1.shape[0] // 36
    sd["classifier.0.weight"] = _t(
        k1.T.reshape(-1, 6, 6, c).transpose(0, 3, 1, 2).reshape(k1.shape[1], -1))
    sd["classifier.0.bias"] = _t(params["fc1"]["bias"])
    sd["classifier.2.weight"] = _t(np.asarray(params["fc2"]["kernel"]).T)
    sd["classifier.2.bias"] = _t(params["fc2"]["bias"])
    return sd


def variables_from_discriminator_state_dict(state_dict: dict) -> dict:
    """The port's (or the reference's) discriminator state_dict -> the JAX
    variables tree {"params", "batch_stats"} of float32 numpy arrays."""
    sd = {k: v.detach().cpu().float().numpy() for k, v in state_dict.items()
          if not k.endswith("num_batches_tracked")}
    params: dict = {"conv0": {"kernel": sd["features.0.weight"].transpose(2, 3, 1, 0).copy(),
                              "bias": sd["features.0.bias"]}}
    stats: dict = {}
    i = 1
    while f"features.{3 * i - 1}.weight" in sd:
        key = f"features.{3 * i}"
        params[f"conv{i}"] = {
            "kernel": sd[f"features.{3 * i - 1}.weight"].transpose(2, 3, 1, 0).copy()}
        params[f"bn{i}"] = {"scale": sd[f"{key}.weight"], "bias": sd[f"{key}.bias"]}
        stats[f"bn{i}"] = {"mean": sd[f"{key}.running_mean"], "var": sd[f"{key}.running_var"]}
        i += 1
    w1 = sd["classifier.0.weight"]  # (1024, C*H*W), columns (c, h, w)
    c = w1.shape[1] // 36
    params["fc1"] = {
        "kernel": w1.reshape(-1, c, 6, 6).transpose(0, 2, 3, 1).reshape(w1.shape[0], -1).T.copy(),
        "bias": sd["classifier.0.bias"]}
    params["fc2"] = {"kernel": sd["classifier.2.weight"].T.copy(),
                     "bias": sd["classifier.2.bias"]}
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# full train states

def save_train_state(path: str, state) -> None:
    """Models (parameters and running statistics), both optimizers (with
    their update counts) and the step, in one `torch.save` file."""
    tree = {"step": state.step, "g_model": state.g_model.state_dict(),
            "g_opt": state.g_opt.state_dict()}
    if state.d_model is not None:
        tree.update(d_model=state.d_model.state_dict(), d_opt=state.d_opt.state_dict())
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(tree, path)


def load_train_state(path: str, state):
    """Restore a `save_train_state` file into `state` in place; raises
    KeyError or ValueError, before changing anything, when it does not fit
    (another phase, other shapes)."""
    dev = next(state.g_model.parameters()).device
    tree = torch.load(path, map_location=dev, weights_only=True)
    has_d = state.d_model is not None
    if has_d != ("d_model" in tree):
        raise KeyError(f"{path}: a {'GAN' if 'd_model' in tree else 'warmup'} "
                       "train state")
    for key in ("g_model", "d_model") if has_d else ("g_model",):
        want = getattr(state, key).state_dict()
        got = tree[key]
        if set(got) != set(want) or any(got[k].shape != want[k].shape for k in want):
            raise ValueError(f"{path}: {key} does not fit the model (keys or shapes)")
    state.g_model.load_state_dict(tree["g_model"])
    state.g_opt.load_state_dict(tree["g_opt"])
    if has_d:
        state.d_model.load_state_dict(tree["d_model"])
        state.d_opt.load_state_dict(tree["d_opt"])
    state.step = int(tree["step"])
    return state


def _trainable(model) -> list[str]:
    return [n for n, p in model.named_parameters() if p.requires_grad]


def _opt_moments(model, opt, keep: set[str] | None = None) -> dict:
    """{parameter name: {"step", "exp_avg", "exp_avg_sq"}}: the optimizer's
    live state tensors, of the parameters that have them. For a load,
    `keep` names the parameters whose moments the checkpoint holds: those
    with no state yet get zeros laid out as torch.optim.Adam's lazy
    initialization lays them out (what its first step would make, with no
    step taken), and the others lose theirs, as Optimizer.load_state_dict
    drops them."""
    out = {}
    for name, p in zip(_trainable(model), opt.params, strict=True):
        if keep is not None and name not in keep:
            opt.opt.state.pop(p, None)
            continue
        st = opt.opt.state.get(p)
        if not st:
            if keep is None:
                continue
            st = opt.opt.state[p]
            st["step"] = torch.zeros((), dtype=torch.float32,
                                     device=p.device if opt._capturable else "cpu")
            st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        out[name] = {k: st[k] for k in ("step", "exp_avg", "exp_avg_sq")}
    return out


def _dcp_tree(state, keep: dict[str, set[str]] | None = None) -> tuple[dict, dict]:
    """The train state as a DCP state dict of live tensors (the models'
    parameters and buffers, the optimizers' moments, step counts and update
    counts), so that a load writes into them in place; and the host-side
    scalars (the train step, and on the CPU each optimizer's update count)
    as tensors to read back after a load. `keep`: {"g" / "d": the
    parameters whose moments a load restores} (`_opt_moments`)."""
    scalars = {"step": torch.tensor(state.step, dtype=torch.int64)}
    tree = {"step": scalars["step"]}
    for key in ("g", "d"):
        model, opt = getattr(state, f"{key}_model"), getattr(state, f"{key}_opt")
        if model is None:
            continue
        count = opt._count
        if not isinstance(count, torch.Tensor):
            count = scalars[f"{key}_count"] = torch.tensor(count, dtype=torch.int64)
        tree[f"{key}_model"] = model.state_dict()
        tree[f"{key}_opt"] = {"count": count, "moments": _opt_moments(
            model, opt, None if keep is None else keep[key])}
    return tree, scalars


def _flat(tree: dict, prefix: str = "") -> dict[str, torch.Tensor]:
    """DCP's flattened keys ('.'-joined paths) -> tensors."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


_MOMENTS = ("step", "exp_avg", "exp_avg_sq")


def _dcp_layout(state) -> tuple[dict[str, tuple], dict[str, dict[str, list[str]]]]:
    """{key: (shape, dtype)} of every value a checkpoint of `state` may
    hold (the moments of every trainable parameter, whether or not its
    optimizer has stepped), and {"g" / "d": {parameter: its moments' keys}}."""
    layout = {k: (tuple(v.shape), v.dtype) for k, v in _flat(_dcp_tree(state)[0]).items()
              if ".moments." not in k}
    moments = {}
    for key in ("g", "d"):
        model = getattr(state, f"{key}_model")
        if model is None:
            continue
        params = dict(model.named_parameters())
        moments[key] = {}
        for name in _trainable(model):
            keys = moments[key][name] = [f"{key}_opt.moments.{name}.{m}" for m in _MOMENTS]
            p = params[name]
            layout.update({keys[0]: ((), torch.float32), keys[1]: (tuple(p.shape), p.dtype),
                           keys[2]: (tuple(p.shape), p.dtype)})
    return layout, moments


def _dcp_call(fn, tree: dict, path: str, collective: bool, **storage) -> None:
    """fn (dcp.save or dcp.load) on `tree` at `path`. DCP's notice that a
    call with no_dist (a single process) assumes one process is expected
    here and filtered."""
    import warnings

    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="torch.distributed is disabled")
        fn(tree, checkpoint_id=path, no_dist=not collective, **storage)


def train_state_arrays(state) -> dict[str, np.ndarray]:
    """Host copies of every value a DCP checkpoint of `state` holds, by
    DCP's flattened key (optimizer moments where they exist): what two
    train states are compared by, bit for bit."""
    return {k: v.detach().cpu().numpy().copy() for k, v in _flat(_dcp_tree(state)[0]).items()}


_TMP, _OLD = ".tmp-", ".old"


def _dcp_barrier(collective: bool) -> None:
    if collective:
        import torch.distributed as dist

        dist.barrier()


def save_train_state_dcp(path: str, state, collective: bool = False) -> None:
    """The train state as a `torch.distributed.checkpoint` directory, as it
    is (an optimizer that has not stepped saves no moments). With
    `collective`, every rank of the process group calls it and DCP splits
    the writes of the (replicated) tensors over the ranks; else one process
    writes it alone, with or without a process group.

    A crash at any instant leaves a whole state at `path` or, between the
    two renames, at `path + ".old"` (`resolve_dcp_dir`): the state is
    written into a fresh sibling `path + ".tmp-<step>"` (one name on every
    rank), and only after `dcp.save` has returned on every rank, so that
    `.metadata` is written, does the coordinator move the old directory
    aside, rename the new one into place and remove the old one. Temporary
    directories a crashed save left are removed first."""
    import shutil

    import torch.distributed.checkpoint as dcp

    coordinator = True
    if collective:
        import torch.distributed as dist

        coordinator = dist.get_rank() == 0
    parent, base = os.path.split(path)
    tmp = f"{path}{_TMP}{state.step}"
    if coordinator:
        os.makedirs(parent or ".", exist_ok=True)
        for name in os.listdir(parent or "."):
            if name.startswith(base + _TMP):
                shutil.rmtree(os.path.join(parent, name))
    _dcp_barrier(collective)
    _dcp_call(dcp.save, _dcp_tree(state)[0], tmp, collective,
              storage_writer=dcp.FileSystemWriter(tmp, overwrite=False))
    _dcp_barrier(collective)
    if coordinator:
        old = path + _OLD
        if os.path.exists(path):
            if os.path.exists(old):  # a whole `last/` is in place: the aside one is stale
                shutil.rmtree(old)
            os.rename(path, old)
        os.rename(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    _dcp_barrier(collective)


def resolve_dcp_dir(path: str) -> str | None:
    """The whole DCP directory a `save_train_state_dcp` to `path` left: `path`
    itself, or the old one it moved aside if a crash fell between its two
    renames; None if neither exists. Temporary directories are never
    taken."""
    for candidate in (path, path + _OLD):
        if os.path.isdir(candidate):
            return candidate
    return None


def load_train_state_dcp(path: str, state, collective: bool = False):
    """Restore a `save_train_state_dcp` directory into `state` in place:
    every parameter, buffer and optimizer moment keeps its storage (a
    captured CUDA graph that updates them stays valid); moments the
    checkpoint holds and the optimizer has not made yet are made first,
    with no step. Raises KeyError or ValueError, before changing anything,
    when it does not fit (another phase, other shapes) or its files cannot
    be read (DCP's CheckpointException: a directory torn by a crash
    mid-save): DCP loads into host staging tensors, copied into the state
    only once the load succeeded."""
    import torch.distributed.checkpoint as dcp

    if not os.path.exists(os.path.join(path, ".metadata")):  # e.g. an orbax directory
        raise KeyError(f"{path}: not a torch.distributed.checkpoint directory")
    saved = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    layout, moments = _dcp_layout(state)
    required = {k for k in layout if ".moments." not in k}
    missing, extra = sorted(required - set(saved)), sorted(set(saved) - set(layout))
    if missing or extra:
        raise KeyError(f"{path}: not this train state (missing {missing[:3]}, "
                       f"unexpected {extra[:3]})")
    keep = {}
    for key, params in moments.items():
        keep[key] = {name for name, keys in params.items() if keys[0] in saved}
        partial = [name for name, keys in params.items()
                   if len({k in saved for k in keys}) > 1]
        if partial:
            raise KeyError(f"{path}: moments of {partial[:3]} are incomplete")
    for key in saved:
        shape, dtype = layout[key]
        got = saved[key]
        if tuple(got.size) != shape or got.properties.dtype != dtype:
            raise ValueError(f"{path}: {key} has shape {tuple(got.size)} "
                             f"{got.properties.dtype}, the state {shape} {dtype}")
    from torch.distributed.checkpoint.api import CheckpointException

    staged = {key: torch.empty(layout[key][0], dtype=layout[key][1]) for key in saved}
    try:
        _dcp_call(dcp.load, staged, path, collective)
    except CheckpointException as e:  # a BaseException, not an Exception
        raise ValueError(f"{path}: its files cannot be read ({e})") from e
    tree, scalars = _dcp_tree(state, keep)
    with torch.no_grad():
        for key, live in _flat(tree).items():
            live.copy_(staged[key])
    state.step = int(scalars["step"])
    for key in ("g", "d"):
        if f"{key}_count" in scalars:
            getattr(state, f"{key}_opt")._count = int(scalars[f"{key}_count"])
    return state


class CheckpointPolicy:
    """last / best / periodic train-state policy (reference
    train.py:207-226): `last` every epoch; `best` when PSNR AND SSIM both
    improve; `epoch{N}` every `interval` epochs for epoch > 0. The best
    metrics persist in `_policy.json`, so a resumed run keeps them.

    Two formats: `{name}.state.pt` files (`torch.save`, written by the
    coordinator alone; the default), or with `use_orbax`
    (EXP.ORBAX_CHECKPOINTS) `{name}/` directories of
    `torch.distributed.checkpoint`, the counterpart of the JAX package's
    orbax directories, whose saves are collective over a process group of
    more than one rank (`collective`)."""

    def __init__(self, results_dir: str, interval: int = 100, use_orbax: bool = False):
        self.results_dir = os.path.abspath(results_dir)
        self.interval = interval
        self.use_orbax = use_orbax
        self.best_psnr = self.best_ssim = 0.0
        os.makedirs(self.results_dir, exist_ok=True)
        self._meta_path = os.path.join(self.results_dir, "_policy.json")
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                meta = json.load(f)
            self.best_psnr = float(meta.get("best_psnr", 0.0))
            self.best_ssim = float(meta.get("best_ssim", 0.0))

    @property
    def collective(self) -> bool:
        """True when every process must call `save_epoch` (and
        `restore_latest`): DCP saves and loads with a process group of more
        than one rank. `.state.pt` files are the coordinator's alone."""
        import torch.distributed as dist

        return self.use_orbax and dist.is_initialized() and dist.get_world_size() > 1

    def _path(self, name: str) -> str:
        return os.path.join(self.results_dir, name if self.use_orbax else f"{name}.state.pt")

    def _save(self, name: str, state) -> None:
        if self.use_orbax:
            save_train_state_dcp(self._path(name), state, self.collective)
        else:
            save_train_state(self._path(name), state)

    def save_epoch(self, state, epoch: int, psnr: float, ssim: float) -> bool:
        """Apply the policy for a finished epoch; returns is_best. When
        `collective`, every rank calls it: only the coordinator validates
        (the others pass NaN), so (psnr, ssim) are broadcast from rank 0
        first and every rank takes the same branch."""
        if self.collective:
            import torch.distributed as dist

            dev = next(state.g_model.parameters()).device
            metrics = torch.tensor([psnr, ssim], dtype=torch.float32, device=dev)
            dist.broadcast(metrics, src=0)
            psnr, ssim = (float(v) for v in metrics.cpu())
        self._save("last", state)
        is_best = self.best_psnr < psnr and self.best_ssim < ssim
        if is_best:
            self._save("best", state)
            self.best_psnr, self.best_ssim = psnr, ssim
            from srgan_st_tpu_torch.parallel.distributed import is_coordinator

            if is_coordinator():
                with open(self._meta_path, "w") as f:
                    json.dump({"best_psnr": psnr, "best_ssim": ssim, "epoch": epoch}, f)
        if 0 < epoch and epoch % self.interval == 0:
            self._save(f"epoch{epoch}", state)
        return is_best

    def restore_latest(self, state) -> bool:
        """Restore `last` (in this policy's format) into `state` if present;
        a DCP `last/` that a crash between a save's two renames left moved
        aside is taken in its place (`resolve_dcp_dir`). One that does not
        fit (e.g. a warmup state found by a GAN run sharing the directory),
        or a DCP directory whose files cannot be read (torn by a crash
        during an in-place save), is skipped with a warning and changes
        nothing. Returns whether a state was restored."""
        path = self._path("last")
        if self.use_orbax:
            path = resolve_dcp_dir(path) or path
        found = os.path.exists(path)
        if self.collective:  # a DCP load is collective: every rank or none
            import torch.distributed as dist

            dev = next(state.g_model.parameters()).device
            seen = torch.tensor([float(found)], device=dev)
            dist.all_reduce(seen)
            if float(seen) not in (0.0, float(dist.get_world_size())):
                raise RuntimeError(f"{path} is seen by {int(float(seen))} of the "
                                   f"{dist.get_world_size()} ranks: the processes must "
                                   "share the results directory")
        if not found:
            return False
        try:
            if self.use_orbax:
                load_train_state_dcp(path, state, self.collective)
            else:
                load_train_state(path, state)
        except (KeyError, ValueError) as e:
            print(f"skipping incompatible 'last' checkpoint in {self.results_dir}: {e}")
            return False
        return True
