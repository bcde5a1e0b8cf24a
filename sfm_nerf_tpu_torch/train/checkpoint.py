"""The ``.npz`` checkpoints of sfm_nerf_tpu/train/checkpoint.py, read and
written in the same key layout, so each package resumes from the other's
files.

One ``model_{step:06d}.ckpt.npz`` (or ``final_model.ckpt.npz``) per save,
written to a temporary name and renamed.  Keys are '//'-joined tree paths:

- ``params//d:<layer>//d:{w,b}``: a parameter, (fan_in, fan_out) / (fan_out,);
- ``opt//s:0//a:count``, ``opt//s:0//a:mu//d:<layer>//d:{w,b}``,
  ``opt//s:0//a:nu//...`` and ``opt//s:1//a:count``: optax's Adam state
  (``ScaleByAdamState`` then ``ScaleByScheduleState``) as the JAX package's
  ``flatten_pytree`` names it; both counts are the number of updates done;
- ``step`` (int64) and ``extra//<name>`` (e.g. ``extra//loss``).

A hierarchical run's pair nests one level more, as the JAX params tree
does: ``params//d:coarse//d:<layer>//d:w``, ``params//d:fine//...``,
``opt//s:0//a:mu//d:coarse//...``.

Resume picks the numerically newest step.  Arrays here are numpy in the JAX
layout; models/convert.py carries them to and from the ``nn.Module`` and
``torch.optim.Adam``.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, Optional, Tuple

import numpy as np

from sfm_nerf_tpu_torch.config import NeRFModelConfig

SEP = "//"


def latest_checkpoint(ckpt_dir: str, prefer_final: bool = False) -> Optional[str]:
    final = os.path.join(ckpt_dir, "final_model.ckpt.npz")
    if prefer_final and os.path.exists(final):
        return final
    candidates = glob.glob(os.path.join(ckpt_dir, "model_*.ckpt.npz"))
    if not candidates:
        return final if os.path.exists(final) else None

    def step_of(p: str) -> int:
        m = re.search(r"model_(\d+)\.ckpt\.npz$", p)
        return int(m.group(1)) if m else -1

    return max(candidates, key=step_of)


def load_params_untyped(path: str) -> Tuple[dict, int]:
    """(params as nested dicts of numpy arrays, step), rebuilt from the
    stored key paths without a template."""
    with np.load(path) as z:
        flat = dict(z)
    return _nest(flat, "params" + SEP), int(flat["step"])


def infer_model_config(params: dict) -> NeRFModelConfig:
    """NeRFModelConfig from a params dict's shapes (active or legacy); of a
    {'coarse', 'fine'} pair, from the fine side (both share one config)."""
    if set(params) == {"coarse", "fine"}:
        params = params["fine"]
    arch = "active" if "feature" in params else "legacy"
    hidden = int(params["fc1"]["b"].shape[0])
    pos_in = int(params["fc1"]["w"].shape[0])
    dir_in = int(params["rgb1"]["w"].shape[0]) - hidden
    pos_encoding = pos_in != 3
    n_pos = (pos_in // 3 - 1) // 2 if pos_encoding else 10
    n_dir = (dir_in // 3 - 1) // 2 if pos_encoding else 4
    n_block1 = sum(1 for k in params if k.startswith("block1_"))
    return NeRFModelConfig(
        n_pos_freq=n_pos, n_dir_freq=n_dir, hidden=hidden,
        pos_encoding=pos_encoding, arch=arch,
        n_block1_layers=n_block1 or 3, has_skip="skip" in params,
    )


def _nest(flat: Dict[str, np.ndarray], prefix: str) -> dict:
    """Nested dicts from the keys under ``prefix`` ('d:' tags stripped)."""
    tree: dict = {}
    for k, v in flat.items():
        if not k.startswith(prefix):
            continue
        node = tree
        parts = [p[2:] for p in k[len(prefix):].split(SEP)]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _flatten(tree: dict, prefix: str) -> Dict[str, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{SEP}d:{k}"
        if isinstance(v, dict):
            flat.update(_flatten(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def save_checkpoint(
    ckpt_dir: str, step: int, params: dict, opt_state: Optional[dict] = None,
    extra: Optional[Dict[str, float]] = None, final: bool = False,
) -> str:
    """Write params (nested dicts of numpy arrays in the JAX layout), the
    Adam state ``{'count': int, 'mu': like params, 'nu': like params}`` and
    the step.  Returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    blobs = _flatten(params, "params")
    if opt_state is not None:
        count = np.asarray(opt_state["count"], np.int32)
        blobs[f"opt{SEP}s:0{SEP}a:count"] = count
        blobs.update(_flatten(opt_state["mu"], f"opt{SEP}s:0{SEP}a:mu"))
        blobs.update(_flatten(opt_state["nu"], f"opt{SEP}s:0{SEP}a:nu"))
        blobs[f"opt{SEP}s:1{SEP}a:count"] = count
    blobs["step"] = np.asarray(step, np.int64)
    for k, v in (extra or {}).items():
        blobs[f"extra{SEP}{k}"] = np.asarray(v)
    name = "final_model.ckpt.npz" if final else f"model_{step:06d}.ckpt.npz"
    path = os.path.join(ckpt_dir, name)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **blobs)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> Tuple[dict, Optional[dict], int]:
    """(params, opt_state or None, step) of a checkpoint written by either
    package; opt_state as save_checkpoint takes it."""
    with np.load(path) as z:
        flat = dict(z)
    step = int(flat["step"])
    params = _nest(flat, "params" + SEP)
    opt_state = None
    adam = f"opt{SEP}s:0{SEP}a:"
    if adam + "count" in flat:
        opt_state = {"count": int(flat[adam + "count"]),
                     "mu": _nest(flat, adam + "mu" + SEP),
                     "nu": _nest(flat, adam + "nu" + SEP)}
    return params, opt_state, step
