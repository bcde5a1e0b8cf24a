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
write; ``shard_layout`` says where each piece lies).  Conversion of
reference ``.pth`` files waits for a slice that needs it: no ``.pth`` file
is in the repository.
"""

from __future__ import annotations

from typing import Dict, Union

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
