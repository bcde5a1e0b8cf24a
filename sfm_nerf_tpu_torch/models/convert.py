"""Weights and optimizer state across the two packages.

The JAX package stores each layer as ``{'w': (fan_in, fan_out), 'b':
(fan_out,)}``; ``nn.Linear`` stores (out, in).  This is the one place that
transposes.  optax's Adam state (``mu``, ``nu`` shaped like the params, one
``count``) maps to ``torch.optim.Adam``'s per-parameter ``exp_avg``,
``exp_avg_sq`` and ``step``, transposed like the weights.  A hierarchical
run's ``{'coarse': ..., 'fine': ...}`` tree (params, ``mu`` and ``nu`` alike)
maps to a ``NeRFPair``; every function here takes either.  A model whose
parameters are DTensors (the dp x tp step, parallel/train_step.py) is read
whole (a gather: every rank of its mesh must call) and written shard by
shard (each rank keeps its slice of the same values).

The readers take ``how``: ``'host'`` float32 numpy (the default),
``'device'`` detached tensors on the model's device, the weights as
transposed views (nothing copied, nothing waited for: the asynchronous
checkpointer snapshots them), ``'local'`` float32 numpy of this rank's own
shard of a DTensor (no collective: what an interrupted rank can still
write; ``shard_layout`` says where each piece lies).

Reference ``.pth`` files (``torch.save`` of a state dict, or of
``{'model_state_dict': ..., 'optimizer_state_dict': ..., ...}``) in the
reference's key names, both ways: ``convert_pth`` reads the standard legacy
layout, the skip-less no-PE legacy layout and the active class into the
JAX-layout tree and a ``NeRFModelConfig`` (``params_from_jax`` then builds
the model); ``export_legacy_to_pth`` and ``export_active_to_pth`` write
them.  Files are read with ``weights_only=True``: tensors, numbers and
dicts, nothing else unpickled.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from sfm_nerf_tpu_torch.config import NeRFModelConfig
from sfm_nerf_tpu_torch.models.nerf import NeRF, NeRFPair, layer_shapes

JaxParams = Dict[str, Dict[str, np.ndarray]]     # or {'coarse': ..., 'fine': ...} of these
Model = Union[NeRF, NeRFPair]
SIDES = ("coarse", "fine")


def is_pair_tree(params: dict) -> bool:
    return set(params) == set(SIDES)


def _check_kind(model: Model, tree: dict, what: str) -> None:
    """A flat tree for a NeRF, a {'coarse', 'fine'} tree for a NeRFPair."""
    kind = {True: "a coarse/fine pair (n_importance > 0)",
            False: "one network (n_importance == 0)"}
    if is_pair_tree(tree) != isinstance(model, NeRFPair):
        raise ValueError(f"{what} hold {kind[is_pair_tree(tree)]}, the model is "
                         f"{kind[isinstance(model, NeRFPair)]}")


def _read(t: torch.Tensor, key: str, how: str):
    """``t`` in the JAX layout (a weight transposed) as ``how`` asks:
    'host', 'device' or 'local' (see the module docstring)."""
    if hasattr(t, "device_mesh"):
        if how == "local":
            t = t.to_local()
        else:
            from sfm_nerf_tpu_torch.parallel.train_step import gather_whole

            t = gather_whole([t])[0]
    t = t.detach()
    if how == "device":
        return t.T if key == "w" else t
    a = t.float().cpu().numpy()        # on the CPU a view of the tensor: copy
    return a.T.copy() if key == "w" else a.copy()


def _layers(model: Model, leaf) -> dict:
    """``{layer: {'w': leaf(weight, 'w'), 'b': leaf(bias, 'b')}}``, a
    {'coarse', 'fine'} tree of these for a pair."""
    if isinstance(model, NeRFPair):
        return {side: _layers(getattr(model, side), leaf) for side in SIDES}
    return {name: {"w": leaf(layer.weight, "w"), "b": leaf(layer.bias, "b")}
            for name, layer in model.layers.items()}


def _laid_out_as(p: torch.Tensor, a: np.ndarray) -> torch.Tensor:
    """``a`` as a tensor on ``p``'s device, sharded as ``p`` when ``p`` is a
    DTensor."""
    if hasattr(p, "device_mesh"):
        from torch.distributed.tensor import distribute_tensor

        t = torch.tensor(a, device=p.to_local().device)
        return distribute_tensor(t, p.device_mesh, p.placements, src_data_rank=None)
    return torch.tensor(a, device=p.device)


def load_params_from_jax(model: Model, params: JaxParams) -> Model:
    """Copy the JAX-layout ``params`` into ``model`` in place (an optimizer
    built on its parameters keeps pointing at them)."""
    _check_kind(model, params, "the params")
    if isinstance(model, NeRFPair):
        for side in SIDES:
            load_params_from_jax(getattr(model, side), params[side])
        return model
    expected = layer_shapes(model.cfg)
    if set(params) != set(expected):
        raise KeyError(
            f"params layers {sorted(params)} do not match the "
            f"{model.cfg.arch} arch's {sorted(expected)}")
    with torch.no_grad():
        for name, (fan_in, fan_out) in expected.items():
            w = np.asarray(params[name]["w"], np.float32)
            b = np.asarray(params[name]["b"], np.float32)
            if w.shape != (fan_in, fan_out) or b.shape != (fan_out,):
                raise ValueError(
                    f"{name}: got w{w.shape} b{b.shape}, expected "
                    f"w{(fan_in, fan_out)} b{(fan_out,)}")
            layer = model.layers[name]
            layer.weight.copy_(_laid_out_as(layer.weight, w.T))
            layer.bias.copy_(_laid_out_as(layer.bias, b))
    return model


def params_from_jax(params: JaxParams, mcfg: NeRFModelConfig, device="cpu") -> Model:
    """A float32 NeRF holding the JAX-layout ``params``, or a NeRFPair for
    a {'coarse', 'fine'} tree."""
    cls = NeRFPair if is_pair_tree(params) else NeRF
    return load_params_from_jax(cls(mcfg, device=device), params)


def params_to_jax(model: Model, how: str = "host") -> JaxParams:
    """Inverse of params_from_jax: float32 numpy in the JAX layout (or, by
    ``how``, device tensors or this rank's shards)."""
    return _layers(model, lambda t, key: _read(t, key, how))


def optimizer_state_to_jax(model: Model, optimizer: torch.optim.Adam,
                           how: str = "host") -> dict:
    """``{'count', 'mu', 'nu'}`` in the JAX layout from the Adam state of
    ``model``'s parameters (``how`` as params_to_jax's).  A parameter that
    has taken no step yet counts zeros; ``count`` is the number of updates
    done (Adam keeps it on the CPU: reading it waits for nothing)."""
    def moment(field):
        def leaf(p, key):
            st = optimizer.state.get(p, {})
            return _read(st[field] if field in st else torch.zeros_like(p), key, how)
        return _layers(model, leaf)

    count = max((int(optimizer.state[p]["step"]) for p in model.parameters()
                 if "step" in optimizer.state.get(p, {})), default=0)
    return {"count": count, "mu": moment("exp_avg"), "nu": moment("exp_avg_sq")}


def shard_layout(model: Model) -> dict:
    """Where this rank's ``how='local'`` pieces lie, a tree like the params:
    ``(dim, index, count)`` per leaf, the JAX-layout dimension the tensor is
    split along, this rank's place on that mesh axis and the axis's size;
    ``(-1, 0, 1)`` for a whole tensor.  The Adam moments share their
    parameter's layout."""
    def leaf(t, key):
        shard = [(i, pl.dim) for i, pl in enumerate(getattr(t, "placements", ()))
                 if pl.is_shard()]
        if not shard:
            return (-1, 0, 1)
        i, dim = shard[0]
        return (1 - dim if key == "w" else dim, t.device_mesh.get_local_rank(i),
                t.device_mesh.size(i))
    return _layers(model, leaf)


def optimizer_state_from_jax(model: Model, optimizer: torch.optim.Adam, state: dict) -> None:
    """Load ``{'count', 'mu', 'nu'}`` (JAX layout) into ``optimizer``'s state
    for ``model``'s parameters, in place."""
    _check_kind(model, state["mu"], "the optimizer moments")
    if isinstance(model, NeRFPair):
        for side in SIDES:
            optimizer_state_from_jax(
                getattr(model, side), optimizer,
                {"count": state["count"], "mu": state["mu"][side], "nu": state["nu"][side]})
        return
    for name, layer in model.layers.items():
        for key, p in (("w", layer.weight), ("b", layer.bias)):
            st = optimizer.state[p]
            for field, tree in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
                a = np.asarray(state[tree][name][key], np.float32)
                a = a.T if key == "w" else a
                if a.shape != tuple(p.shape):
                    raise ValueError(f"{tree}/{name}/{key}: got {a.shape}, expected "
                                     f"{tuple(p.shape)}")
                st[field] = _laid_out_as(p, np.ascontiguousarray(a))
            # torch.optim.Adam keeps ``step`` as a float32 tensor on the CPU
            st["step"] = torch.tensor(float(state["count"]), dtype=torch.float32)


# ---------------------------------------------------------------------------
# reference .pth files
# ---------------------------------------------------------------------------


def latest_pth(ckpt_dir: str) -> Optional[str]:
    """``final_model.pth`` in ``ckpt_dir``, else the numerically newest
    ``model_*.pth`` (model_10000 over model_9000), else None."""
    final = os.path.join(ckpt_dir, "final_model.pth")
    if os.path.exists(final):
        return final
    cands = glob.glob(os.path.join(ckpt_dir, "model_*.pth"))
    if not cands:
        return None

    def step_of(p: str) -> int:
        m = re.search(r"model_(\d+)\.pth$", p)
        return int(m.group(1)) if m else -1

    return max(cands, key=step_of)


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A .pth file's state dict as numpy arrays; a training save's
    ``model_state_dict`` is unwrapped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    return {k: v.detach().cpu().numpy() for k, v in obj.items()}


def _wb(sd: Dict[str, np.ndarray], prefix: str) -> dict:
    return {"w": np.ascontiguousarray(sd[prefix + ".weight"].T), "b": sd[prefix + ".bias"]}


def _pe_freqs(pos_in: int, dir_in: int) -> Tuple[bool, int, int]:
    """(pos_encoding, n_pos_freq, n_dir_freq) from the two input widths,
    3 * (2L + 1) with PE; 3 without, and the frequencies keep their
    defaults."""
    if pos_in == 3:
        return False, 10, 4
    return True, (pos_in // 3 - 1) // 2, (dir_in // 3 - 1) // 2


def convert_legacy_state_dict(sd: Dict[str, np.ndarray]) -> Tuple[JaxParams, NeRFModelConfig]:
    """A reference legacy ``Sequential`` state dict -> (JAX-layout tree,
    config).  Standard layout: ``block1`` of n layers, ``skip_layer``,
    ``block2`` of 3 (the last (hidden + 1)-wide).  Skip-less no-PE layout:
    ``block1`` holds everything, its last 3 layers the tail."""
    def layer_indices(block: str):
        return sorted(int(m.group(1)) for m in
                      (re.fullmatch(rf"{block}\.(\d+)\.weight", k) for k in sd) if m)

    has_skip = "skip_layer.0.weight" in sd
    hidden, pos_in = sd["fc1.0.weight"].shape
    pos_encoding, n_pos, n_dir = _pe_freqs(pos_in, sd["rgb_fc.0.weight"].shape[1] - hidden)
    layers = [f"block1.{i}" for i in layer_indices("block1")]
    if has_skip:
        tail = [f"block2.{i}" for i in layer_indices("block2")]
    else:
        layers, tail = layers[:-3], layers[-3:]
    if len(tail) != 3:
        raise ValueError(f"expected 3 tail layers, got {tail}")
    params = {"fc1": _wb(sd, "fc1.0")}
    params.update({f"block1_{i}": _wb(sd, name) for i, name in enumerate(layers)})
    if has_skip:
        params["skip"] = _wb(sd, "skip_layer.0")
    params.update({f"block2_{i}": _wb(sd, name) for i, name in enumerate(tail)})
    if params["block2_2"]["w"].shape[1] != hidden + 1:
        raise ValueError(f"the last tail layer is {params['block2_2']['w'].shape[1]} wide, "
                         f"not hidden + 1 = {hidden + 1}")
    params["density_fc"] = _wb(sd, "density_fc")
    params["rgb1"] = _wb(sd, "rgb_fc.0")
    params["rgb2"] = _wb(sd, "rgb_fc.2")
    return params, NeRFModelConfig(
        n_pos_freq=n_pos, n_dir_freq=n_dir, hidden=int(hidden), pos_encoding=pos_encoding,
        arch="legacy", n_block1_layers=len(layers), has_skip=has_skip)


def convert_active_state_dict(sd: Dict[str, np.ndarray]) -> Tuple[JaxParams, NeRFModelConfig]:
    """A reference active-class (``NeRFmodel``) state dict -> (JAX-layout
    tree, config).  Keys: fc1, fc_layers.{0..3}, skip_layer,
    fc_layers2.{0..2}, density_layer, feature_layer, rgb_layer{1,2}."""
    hidden, pos_in = sd["fc1.weight"].shape
    pos_encoding, n_pos, n_dir = _pe_freqs(pos_in, sd["rgb_layer1.weight"].shape[1] - hidden)
    params = {"fc1": _wb(sd, "fc1")}
    params.update({f"fc_{i}": _wb(sd, f"fc_layers.{i}") for i in range(4)})
    params["skip"] = _wb(sd, "skip_layer")
    params.update({f"fc2_{i}": _wb(sd, f"fc_layers2.{i}") for i in range(3)})
    for name, key in (("density", "density_layer"), ("feature", "feature_layer"),
                      ("rgb1", "rgb_layer1"), ("rgb2", "rgb_layer2")):
        params[name] = _wb(sd, key)
    return params, NeRFModelConfig(n_pos_freq=n_pos, n_dir_freq=n_dir, hidden=int(hidden),
                                   pos_encoding=pos_encoding, arch="active")


def convert_pth(path: str) -> Tuple[JaxParams, NeRFModelConfig]:
    """A .pth file -> (JAX-layout tree of numpy arrays, config), by its
    layout: a plain ``fc1.weight`` is the active class, ``fc1.0.weight``
    the legacy ``Sequential``."""
    sd = load_torch_state_dict(path)
    if "fc1.weight" in sd:
        return convert_active_state_dict(sd)
    return convert_legacy_state_dict(sd)


def _save_state_dict(layers, path: str) -> None:
    """``layers``: (reference prefix, JAX-layout layer) pairs, written as
    float32 ``prefix.weight`` (out, in) and ``prefix.bias``."""
    sd = {}
    for prefix, layer in layers:
        sd[prefix + ".weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(layer["w"], np.float32).T))
        sd[prefix + ".bias"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(layer["b"], np.float32)))
    torch.save(sd, path)


def export_legacy_to_pth(params: JaxParams, cfg: NeRFModelConfig, path: str) -> None:
    """A legacy-arch JAX-layout tree -> a reference-layout .pth state dict:
    the standard layout with a skip layer, else the skip-less layout whose
    ``block1`` carries the tail (the reference's Sequential numbering, a
    Linear at every second index)."""
    n_b1 = cfg.n_block1_layers
    layers = [("fc1.0", params["fc1"])]
    layers += [(f"block1.{2 * i}", params[f"block1_{i}"]) for i in range(n_b1)]
    if cfg.has_skip:
        layers.append(("skip_layer.0", params["skip"]))
        layers += [(f"block2.{2 * i}", params[f"block2_{i}"]) for i in range(3)]
    else:
        layers += [(f"block1.{2 * (n_b1 + i)}", params[f"block2_{i}"]) for i in range(3)]
    layers += [("density_fc", params["density_fc"]), ("rgb_fc.0", params["rgb1"]),
               ("rgb_fc.2", params["rgb2"])]
    _save_state_dict(layers, path)


def export_active_to_pth(params: JaxParams, path: str) -> None:
    """An active-arch JAX-layout tree -> a reference ``NeRFmodel`` state
    dict."""
    layers = [("fc1", params["fc1"])]
    layers += [(f"fc_layers.{i}", params[f"fc_{i}"]) for i in range(4)]
    layers.append(("skip_layer", params["skip"]))
    layers += [(f"fc_layers2.{i}", params[f"fc2_{i}"]) for i in range(3)]
    layers += [("density_layer", params["density"]), ("feature_layer", params["feature"]),
               ("rgb_layer1", params["rgb1"]), ("rgb_layer2", params["rgb2"])]
    _save_state_dict(layers, path)
