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
shard (each rank keeps its slice of the same values).  Conversion of
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


def _host(t: torch.Tensor) -> np.ndarray:
    """float32 numpy of ``t``; a DTensor is gathered whole first."""
    if hasattr(t, "device_mesh"):
        from sfm_nerf_tpu_torch.parallel.train_step import gather_whole

        t = gather_whole([t])[0]
    return t.detach().float().cpu().numpy()


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


def params_to_jax(model: Model) -> JaxParams:
    """Inverse of params_from_jax: float32 numpy in the JAX layout."""
    if isinstance(model, NeRFPair):
        return {side: params_to_jax(getattr(model, side)) for side in SIDES}
    return {
        name: {
            "w": _host(layer.weight).T.copy(),
            "b": _host(layer.bias),
        }
        for name, layer in model.layers.items()
    }


def optimizer_state_to_jax(model: Model, optimizer: torch.optim.Adam) -> dict:
    """``{'count', 'mu', 'nu'}`` in the JAX layout from the Adam state of
    ``model``'s parameters.  A parameter that has taken no step yet counts
    zeros; ``count`` is the number of updates done."""
    if isinstance(model, NeRFPair):
        sides = {side: optimizer_state_to_jax(getattr(model, side), optimizer)
                 for side in SIDES}
        return {"count": max(s["count"] for s in sides.values()),
                "mu": {side: s["mu"] for side, s in sides.items()},
                "nu": {side: s["nu"] for side, s in sides.items()}}
    mu: JaxParams = {}
    nu: JaxParams = {}
    count = 0
    for name, layer in model.layers.items():
        mu[name], nu[name] = {}, {}
        for key, p in (("w", layer.weight), ("b", layer.bias)):
            st = optimizer.state.get(p, {})
            for tree, field in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
                t = st[field] if field in st else torch.zeros_like(p)
                a = _host(t)
                tree[name][key] = a.T.copy() if key == "w" else a
            if "step" in st:
                count = max(count, int(st["step"]))
    return {"count": count, "mu": mu, "nu": nu}


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
