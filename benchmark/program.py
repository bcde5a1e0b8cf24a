"""The system under test, as the benchmark builds it: the port's
configuration objects, its NeRF modules holding the benchmark's weights,
and the names of their parameters in the reference's terms.

Everything of the program is imported inside these functions, so the
harness's other modules load without it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch


def _fields(cls, group: Dict, **given):
    """``cls`` from ``given`` and every key of ``group`` that names one of
    its fields; the group's other keys describe and are not passed."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{**given, **{k: v for k, v in group.items() if k in names}})


def pipeline_config(m: Dict, r: Dict, t: Dict):
    """The port's ``NeRFPipelineConfig`` as its training CLI builds it
    (``cli.nerf``: the fused kernels asked for, the route decided by the
    program) from the configuration's groups: each key of the model,
    render and train group that is a field of the port's model, render or
    train config is passed as it stands."""
    from sfm_nerf_tpu_torch.config import (
        NeRFModelConfig, NeRFPipelineConfig, RenderConfig, TrainConfig,
    )

    return NeRFPipelineConfig(model=_fields(NeRFModelConfig, m),
                              render=_fields(RenderConfig, r, use_fused_kernel=True),
                              train=_fields(TrainConfig, t))


def networks(model) -> List:
    """The port's NeRF modules of ``model``: [net] or [coarse, fine]."""
    return [model.coarse, model.fine] if hasattr(model, "coarse") else [model]


def build_model(cfg, nets, device):
    """The port's NeRF (one net) or NeRFPair (two) holding ``nets``, the
    reference's {layer: (W (in, out), b)} dicts."""
    from sfm_nerf_tpu_torch.models.nerf import NeRF, NeRFPair

    model = (NeRFPair if len(nets) == 2 else NeRF)(cfg.model, device=device)
    with torch.no_grad():
        for net, params in zip(networks(model), nets):
            for name, (w, b) in params.items():
                net.layers[name].weight.copy_(w.t())
                net.layers[name].bias.copy_(b)
    return model


def leaves(model) -> Dict[str, torch.nn.Parameter]:
    """{'<net>.<layer>.w|b': parameter}, the reference's leaf names."""
    out = {}
    for i, net in enumerate(networks(model)):
        for name, layer in net.layers.items():
            out[f"{i}.{name}.w"] = layer.weight
            out[f"{i}.{name}.b"] = layer.bias
    return out
