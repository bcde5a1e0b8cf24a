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

Shards.  A rank of a run whose parameters are stored sharded (tp > 1) that
is interrupted cannot join a gather, so it writes its own pieces:
``shard_rank{r}_of{world}.npz``, the keys above plus ``layout//...``
(``models/convert.py:shard_layout``: each leaf's split dimension, this
rank's index on it and the split count).  ``load_shards`` puts the pieces
of one interrupt back together when every rank's stamp agrees.
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
    """NeRFModelConfig from a params dict's shapes (active, legacy or mip:
    a feature layer and two layers after the skip); of a {'coarse', 'fine'}
    pair, from the fine side (both share one config)."""
    if set(params) == {"coarse", "fine"}:
        params = params["fine"]
    arch = "active" if "feature" in params else "legacy"
    hidden = int(params["fc1"]["b"].shape[0])
    pos_in = int(params["fc1"]["w"].shape[0])
    dir_in = int(params["rgb1"]["w"].shape[0]) - hidden
    if arch == "active" and "fc2_2" not in params:
        return NeRFModelConfig(n_pos_freq=pos_in // 6, n_dir_freq=(dir_in // 3 - 1) // 2,
                               hidden=hidden, arch="mip")
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


def _blobs(step: int, params: dict, opt_state: Optional[dict],
           extra: Optional[Dict[str, float]]) -> Dict[str, np.ndarray]:
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
    return blobs


def _write(path: str, blobs: Dict[str, np.ndarray]) -> str:
    """Write to a temporary name, then rename: a reader never sees half a
    file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **blobs)
    os.replace(tmp, path)
    return path


def checkpoint_name(step: int, final: bool = False) -> str:
    return "final_model.ckpt.npz" if final else f"model_{step:06d}.ckpt.npz"


def save_checkpoint(
    ckpt_dir: str, step: int, params: dict, opt_state: Optional[dict] = None,
    extra: Optional[Dict[str, float]] = None, final: bool = False,
) -> str:
    """Write params (nested dicts of numpy arrays in the JAX layout), the
    Adam state ``{'count': int, 'mu': like params, 'nu': like params}`` and
    the step.  Returns the path."""
    return _write(os.path.join(ckpt_dir, checkpoint_name(step, final)),
                  _blobs(step, params, opt_state, extra))


def save_shard(ckpt_dir: str, rank: int, world: int, step: int, params: dict,
               opt_state: dict, layout: dict, extra: Optional[Dict[str, float]] = None) -> str:
    """Write this rank's pieces (``how='local'`` trees) and their
    ``layout`` stamped ``step``, replacing the rank's previous shard file."""
    blobs = _blobs(step, params, opt_state, extra)
    blobs.update(_flatten(layout, "layout"))
    return _write(os.path.join(ckpt_dir, f"shard_rank{rank}_of{world}.npz"), blobs)


def _assemble(pieces: list, layouts: list):
    """One whole array from the ranks' pieces of it: the piece of each
    index along the split dimension, in index order."""
    dim, _, count = (int(v) for v in layouts[0])
    if dim < 0:
        return pieces[0]
    by_index = {int(lay[1]): a for a, lay in zip(pieces, layouts)}
    if sorted(by_index) != list(range(count)):
        raise ValueError(f"shards cover indices {sorted(by_index)} of {count}")
    return np.concatenate([by_index[i] for i in range(count)], axis=dim)


def load_shards(ckpt_dir: str):
    """The newest complete set of shard files in ``ckpt_dir`` (every rank
    of one world size), as ``(whole, stamps)``: ``stamps`` each rank's
    step, ``whole`` ``(params, opt_state, step)`` put back together, or
    None when the stamps disagree (never a mix of steps).  None when no
    complete set exists."""
    sets: Dict[int, Dict[int, str]] = {}
    for path in glob.glob(os.path.join(ckpt_dir, "shard_rank*_of*.npz")):
        m = re.search(r"shard_rank(\d+)_of(\d+)\.npz$", path)
        if m:
            sets.setdefault(int(m.group(2)), {})[int(m.group(1))] = path
    complete = []
    for world, files in sets.items():
        if sorted(files) != list(range(world)):
            continue
        flats = []
        for r in range(world):
            with np.load(files[r]) as z:
                flats.append(dict(z))
        complete.append(({r: int(f["step"]) for r, f in enumerate(flats)}, flats))
    if not complete:
        return None
    stamps, flats = max(complete, key=lambda c: max(c[0].values()))
    if len(set(stamps.values())) > 1:
        return None, stamps
    flat = {}
    for k in flats[0]:
        if k.startswith(f"layout{SEP}"):
            continue
        if k.startswith(("params" + SEP, f"opt{SEP}s:0{SEP}a:mu", f"opt{SEP}s:0{SEP}a:nu")):
            leaf = k.split(SEP, 1 if k.startswith("params") else 3)[-1]
            lay_key = f"layout{SEP}{leaf}"
            flat[k] = _assemble([f[k] for f in flats], [f[lay_key] for f in flats])
        else:
            flat[k] = flats[0][k]
    return _unflatten(flat), stamps


def load_checkpoint(path: str) -> Tuple[dict, Optional[dict], int]:
    """(params, opt_state or None, step) of a checkpoint written by either
    package; opt_state as save_checkpoint takes it."""
    with np.load(path) as z:
        return _unflatten(dict(z))


def _unflatten(flat: Dict[str, np.ndarray]) -> Tuple[dict, Optional[dict], int]:
    step = int(flat["step"])
    params = _nest(flat, "params" + SEP)
    opt_state = None
    adam = f"opt{SEP}s:0{SEP}a:"
    if adam + "count" in flat:
        opt_state = {"count": int(flat[adam + "count"]),
                     "mu": _nest(flat, adam + "mu" + SEP),
                     "nu": _nest(flat, adam + "nu" + SEP)}
    return params, opt_state, step
