"""Checkpoint interchange (port of srgan_st_tpu/train/checkpoint.py, npz part).

* npz weight files in the JAX package's format: flat archives keyed by the
  '/'-joined path of the variables tree ({"params", "batch_stats"}), so a
  `g_best.npz` written by the JAX package loads here and the reverse.
* the weight carry-over between that variables tree (HWIO kernels, scalar
  PReLU slopes, BN scale/bias + mean/var) and the port's torch state_dict
  (OIHW, (1,) slopes, BatchNorm2d keys) — the inverse of the reference
  import tool's mapping (tools/import_torch_checkpoint.py).
"""

from __future__ import annotations

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
