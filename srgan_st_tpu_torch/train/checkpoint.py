"""Checkpoints (port of srgan_st_tpu/train/checkpoint.py).

* npz weight files in the JAX package's format: flat archives keyed by the
  '/'-joined path of the variables tree ({"params", "batch_stats"}), so a
  `g_best.npz` written by the JAX package loads here and the reverse.
* the weight carry-over between those variables trees (HWIO kernels,
  scalar PReLU slopes, BN scale/bias + mean/var, D's (H, W, C) flatten)
  and the port's torch state_dicts (OIHW, (1,) slopes, BatchNorm2d keys,
  (C, H, W) flatten) — the mapping of tools/import_torch_checkpoint.py.
* full train states (models, optimizers, step) saved with `torch.save`,
  and the last / best / epoch{N} policy over them (`CheckpointPolicy`).
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
    if target is None:
        return loaded

    def merge(tgt, src):
        if not isinstance(tgt, dict):
            if isinstance(src, dict):
                return tgt
            return src if np.shape(src) == np.shape(tgt) else tgt
        return {
            k: (merge(v, src[k]) if isinstance(src, dict) and k in src else v)
            for k, v in tgt.items()
        }

    return merge(target, loaded)


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


class CheckpointPolicy:
    """last / best / periodic train-state policy (reference
    train.py:207-226): `last` every epoch; `best` when PSNR AND SSIM both
    improve; `epoch{N}` every `interval` epochs for epoch > 0. The best
    metrics persist in `_policy.json`, so a resumed run keeps them."""

    def __init__(self, results_dir: str, interval: int = 100):
        self.results_dir = os.path.abspath(results_dir)
        self.interval = interval
        self.best_psnr = self.best_ssim = 0.0
        os.makedirs(self.results_dir, exist_ok=True)
        self._meta_path = os.path.join(self.results_dir, "_policy.json")
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                meta = json.load(f)
            self.best_psnr = float(meta.get("best_psnr", 0.0))
            self.best_ssim = float(meta.get("best_ssim", 0.0))

    def _path(self, name: str) -> str:
        return os.path.join(self.results_dir, f"{name}.state.pt")

    def save_epoch(self, state, epoch: int, psnr: float, ssim: float) -> bool:
        """Apply the policy for a finished epoch; returns is_best."""
        save_train_state(self._path("last"), state)
        is_best = self.best_psnr < psnr and self.best_ssim < ssim
        if is_best:
            save_train_state(self._path("best"), state)
            self.best_psnr, self.best_ssim = psnr, ssim
            with open(self._meta_path, "w") as f:
                json.dump({"best_psnr": psnr, "best_ssim": ssim, "epoch": epoch}, f)
        if 0 < epoch and epoch % self.interval == 0:
            save_train_state(self._path(f"epoch{epoch}"), state)
        return is_best

    def restore_latest(self, state) -> bool:
        """Restore `last` into `state` if present. One that does not fit
        (e.g. a warmup state found by a GAN run sharing the directory) is
        skipped with a warning. Returns whether a state was restored."""
        path = self._path("last")
        if not os.path.exists(path):
            return False
        try:
            load_train_state(path, state)
        except (KeyError, ValueError) as e:
            print(f"skipping incompatible 'last' checkpoint in {self.results_dir}: {e}")
            return False
        return True
