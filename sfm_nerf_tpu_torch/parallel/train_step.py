"""Sharded NeRF train steps (sfm_nerf_tpu/parallel/train_step.py).

1. ``make_dp_train_step``: data parallelism with explicit collectives.
   Every rank holds the whole model, draws its own ``n_rays_batch / world``
   rays, runs the single-device loss (``make_loss_fn``: the fused kernels on
   the card, their plain versions on the CPU) and backward, and one
   ``all_reduce`` of one flat float32 bucket (the loss, then every grad in
   parameter order) averages them; the same Adam + StepLR then runs on
   every rank.  ``DistributedDataParallel`` is not used: the fused route
   writes its grads from a ``torch.autograd.Function`` that hands back the
   kernel's ready-made grads, and one bucket per step is all DDP would add.

2. ``make_spmd_train_step``: dp x tp.  Parameters are stored as DTensors on
   the ('data', 'model') mesh, each layer sharded over 'model' by
   ``mlp_param_placements`` (Megatron's alternation).  Inside the fused
   envelope a kernel is a one-device program, so the loss is computed data
   parallel over every rank of both axes, as the JAX package's
   ``_make_spmd_fused_step`` does: each step gathers the full weights
   (``gather_whole``: one all-reduce of a zero-padded bucket), every
   rank renders ``n_rays_batch / world`` rays through the kernels, one
   all-reduce averages the grads, and Adam updates each rank's shards.
   Outside it the ``nn.Module`` runs on the DTensors with the rays sharded
   over 'data', and DTensor inserts the collectives (the GSPMD route).

Draws.  A rank draws from a ``torch.Generator`` seeded with
``draw_seed(train.seed, i)``, i its linearised position on the mesh axes
that carry rays (every axis but 'model' for the dp step, every axis for the
fused spmd step, 'data' alone for the module spmd step, where the model
ranks of one data row share its rays).  Rank 0 of a one-rank world draws
what the single-device trainer draws.  ``step.draw_index`` is that i.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, List

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from sfm_nerf_tpu_torch.config import NeRFPipelineConfig
from sfm_nerf_tpu_torch.models.nerf import NeRF, NeRFPair
from sfm_nerf_tpu_torch.parallel.mesh import axes_group, axes_size, linear_index


def draw_seed(seed: int, index: int) -> int:
    """The seed of the generator of the rank at linearised mesh position
    ``index``: ``seed + 1`` (the single-device trainer's) plus
    ``index * 2**32``."""
    return seed + 1 + (index << 32)


def _networks(model) -> List[NeRF]:
    return [model.coarse, model.fine] if isinstance(model, NeRFPair) else [model]


def _through_bucket(tensors: List[torch.Tensor], collective) -> None:
    """Run ``collective`` in place on one flat float32 bucket of
    ``tensors`` (in list order) and write the result back into them."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    collective(flat)
    off = 0
    with torch.no_grad():
        for t in tensors:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


def average_(tensors: List[torch.Tensor], group, world: int) -> None:
    """Replace each tensor by its mean over the ``world`` ranks of
    ``group``: one all-reduce of one bucket."""
    def mean(flat):
        dist.all_reduce(flat, group=group)
        flat /= world

    _through_bucket(tensors, mean)


def broadcast_(tensors: List[torch.Tensor], src: int = 0) -> None:
    """Every rank's tensors become rank ``src``'s: one broadcast of one
    bucket."""
    _through_bucket(tensors, lambda flat: dist.broadcast(flat, src))


def gather_whole(tensors: List[DTensor]) -> List[torch.Tensor]:
    """The whole tensors behind ``tensors`` (DTensors of one mesh, each
    sharded evenly over at most one mesh axis), on every rank: each rank
    writes its shard into a zero whole tensor, and one ``all_reduce(SUM)``
    a sharding axis of a flat bucket assembles them (adding zeros is
    exact).  ``all_reduce`` alone is used: every backend offers it on CUDA
    tensors, while gloo's all-gather of CUDA tensors crashes under torch
    2.11 (the one-card two-rank runs use gloo)."""
    mesh = tensors[0].device_mesh
    whole, buckets = [], {}
    for t in tensors:
        local = t.to_local()
        w = torch.zeros(t.shape, dtype=local.dtype, device=local.device)
        axes = [i for i, pl in enumerate(t.placements) if pl.is_shard()]
        if len(axes) > 1:
            raise ValueError(f"sharded over mesh axes {axes}: one at most")
        if axes:
            i = axes[0]
            d, n = t.placements[i].dim, local.shape[t.placements[i].dim]
            w.narrow(d, mesh.get_local_rank(i) * n, n).copy_(local)
            buckets.setdefault(i, []).append(w)
        else:
            w.copy_(local)
        whole.append(w)
    for i, ws in buckets.items():
        _through_bucket(ws, lambda flat: dist.all_reduce(flat, group=mesh.get_group(i)))
    return whole


def _local_rays(cfg: NeRFPipelineConfig, world: int) -> int:
    if cfg.train.n_rays_batch % world:
        raise ValueError(f"n_rays_batch={cfg.train.n_rays_batch} not divisible by "
                         f"world={world}")
    return cfg.train.n_rays_batch // world


def make_dp_train_step(cfg: NeRFPipelineConfig, optimizer, scheduler,
                       mesh: DeviceMesh, guard=None) -> Callable:
    """Explicit-collective data-parallel step over every mesh axis but
    'model' ('data', or ('dcn', 'data') on a multi-node mesh):
    ``step(model, generator, images, poses, K, draws=None, u=None,
    u_pdf=None) -> loss``, the single-device step's signature; the hooks
    replace this rank's draws (tests).  ``guard`` (the trainer's
    ``UpdateGuard``) is held from the update on, as in every step here."""
    from sfm_nerf_tpu_torch.train.nerf_trainer import UpdateGuard, make_loss_fn

    guard = guard or UpdateGuard()
    axes = [a for a in mesh.mesh_dim_names if a != cfg.parallel.model_axis]
    world = axes_size(mesh, axes)
    loss_fn = make_loss_fn(cfg, n_rays=_local_rays(cfg, world))
    group = axes_group(mesh, axes)

    def train_step(model, generator, images, poses, K, draws=None, u=None, u_pdf=None):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, generator, images, poses, K, draws, u, u_pdf)
        loss.backward()
        loss = loss.detach().reshape(1)
        average_([loss] + [p.grad for p in model.parameters() if p.grad is not None],
                 group, world)
        guard.hold()
        optimizer.step()
        scheduler.step()
        return loss[0]

    train_step.draw_index = linear_index(mesh, axes)
    return train_step


def mlp_param_placements(model, mesh: DeviceMesh, model_axis: str = "model") -> Dict:
    """Megatron's alternating layout, keyed as the JAX package's params
    tree: ``{layer: {'w': placements, 'b': placements}}`` (``{'coarse':
    ..., 'fine': ...}`` of these for a pair, each network alternating on
    its own).  Layers in sorted key order; even ones column-parallel (the
    torch (out, in) weight ``Shard(0)``, the bias ``Shard(0)``), odd ones
    row-parallel (weight ``Shard(1)``, bias replicated); a layer whose
    dimension ``tp`` does not divide stays replicated.  Every other mesh
    axis replicates."""
    if isinstance(model, NeRFPair):
        return {side: mlp_param_placements(getattr(model, side), mesh, model_axis)
                for side in ("coarse", "fine")}
    dim = mesh.mesh_dim_names.index(model_axis)
    tp = mesh.size(dim)

    def on_model(p):
        return [p if i == dim else Replicate() for i in range(mesh.ndim)]

    rep = on_model(Replicate())
    out = {}
    for i, name in enumerate(sorted(model.layers)):
        fan_out, fan_in = model.layers[name].weight.shape
        if i % 2 == 0 and fan_out % tp == 0:
            out[name] = {"w": on_model(Shard(0)), "b": on_model(Shard(0))}
        elif i % 2 == 1 and fan_in % tp == 0:
            out[name] = {"w": on_model(Shard(1)), "b": rep}
        else:
            out[name] = {"w": rep, "b": rep}
    return out


def distribute_params(model, mesh: DeviceMesh, placements: Dict) -> None:
    """Store ``model``'s parameters as DTensors laid out by ``placements``
    (``mlp_param_placements``'s tree), in place.  Every rank must hold the
    same values: each keeps its own slice, nothing is sent."""
    if isinstance(model, NeRFPair):
        for side in ("coarse", "fine"):
            distribute_params(getattr(model, side), mesh, placements[side])
        return
    for name, layer in model.layers.items():
        for key, attr in (("w", "weight"), ("b", "bias")):
            p = getattr(layer, attr)
            setattr(layer, attr, torch.nn.Parameter(distribute_tensor(
                p.detach(), mesh, placements[name][key], src_data_rank=None)))


def make_spmd_train_step(cfg: NeRFPipelineConfig, optimizer, scheduler,
                         mesh: DeviceMesh, model, guard=None) -> Callable:
    """dp x tp step over ``model``, whose parameters ``distribute_params``
    has laid out on ``mesh`` and which ``optimizer`` updates.  Same
    signature as the dp step.  A config that asks for the fused kernels but
    lies outside their envelope warns once and takes the module route."""
    from sfm_nerf_tpu_torch.train.nerf_trainer import UpdateGuard, fused_train_supported

    guard = guard or UpdateGuard()
    if cfg.render.use_fused_kernel and fused_train_supported(cfg):
        return _make_spmd_fused_step(cfg, optimizer, scheduler, mesh, model, guard)
    if cfg.render.use_fused_kernel:
        warnings.warn(
            "spmd step: config requests fused kernels but is outside the fused "
            "envelope (see fused_train_supported) — using the nn.Module path",
            stacklevel=2)
    return _make_spmd_module_step(cfg, optimizer, scheduler, mesh, model, guard)


def _make_spmd_fused_step(cfg, optimizer, scheduler, mesh, model, guard) -> Callable:
    """Parameters stored model-sharded, the loss computed data parallel over
    every mesh axis on a plain module that holds the gathered weights."""
    from sfm_nerf_tpu_torch.train.nerf_trainer import make_loss_fn

    axes = list(mesh.mesh_dim_names)
    world = axes_size(mesh, axes)
    loss_fn = make_loss_fn(cfg, n_rays=_local_rays(cfg, world))
    group = axes_group(mesh, axes)
    params = list(model.parameters())
    dev = params[0].to_local().device
    full = (NeRFPair if isinstance(model, NeRFPair) else NeRF)(cfg.model, device=dev)
    full_params = list(full.parameters())

    def train_step(model, generator, images, poses, K, draws=None, u=None, u_pdf=None):
        optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():
            for f, w in zip(full_params, gather_whole(params)):
                f.copy_(w)
                f.grad = None
        loss = loss_fn(full, generator, images, poses, K, draws, u, u_pdf)
        loss.backward()
        loss = loss.detach().reshape(1)
        grads = [f.grad for f in full_params]
        average_([loss] + [g for g in grads if g is not None], group, world)
        for p, g in zip(params, grads):
            if g is not None:
                p.grad = distribute_tensor(g, mesh, p.placements, src_data_rank=None)
        guard.hold()
        optimizer.step()
        scheduler.step()
        return loss[0]

    train_step.draw_index = linear_index(mesh, axes)
    return train_step


def _make_spmd_module_step(cfg, optimizer, scheduler, mesh, model, guard) -> Callable:
    """The nn.Module on DTensors: each network's inputs (points, directions)
    enter as this data rank's rows of the batch, ``Shard(0)`` on 'data' and
    replicated on 'model', and leave as local tensors; sampling,
    compositing and the MSE stay local, and the loss is the mean over the
    data ranks."""
    from torch.distributed.tensor import distribute_module

    from sfm_nerf_tpu_torch.train.nerf_trainer import make_loss_fn

    data = cfg.parallel.data_axis
    dim = mesh.mesh_dim_names.index(data)
    rows = [Shard(0) if i == dim else Replicate() for i in range(mesh.ndim)]
    dp = mesh.size(dim)
    loss_fn = make_loss_fn(cfg, n_rays=_local_rays(cfg, dp))

    def enter(_mod, inputs, mesh_):
        return tuple(DTensor.from_local(x, mesh_, rows) for x in inputs)

    def leave(_mod, outputs, mesh_):
        return tuple(y.redistribute(mesh_, rows).to_local() for y in outputs)

    for net in _networks(model):
        distribute_module(net, mesh, input_fn=enter, output_fn=leave)

    def train_step(model, generator, images, poses, K, draws=None, u=None, u_pdf=None):
        optimizer.zero_grad(set_to_none=True)
        with implicit_replication():
            local = loss_fn(model, generator, images, poses, K, draws, u, u_pdf)
            loss = DTensor.from_local(local.reshape(1), mesh, rows).mean().full_tensor()
            loss.backward()
        for p in model.parameters():
            if p.grad is not None:
                p.grad = p.grad.redistribute(p.device_mesh, p.placements)
        guard.hold()
        optimizer.step()
        scheduler.step()
        return loss.detach()

    train_step.draw_index = mesh.get_local_rank(data)
    return train_step
