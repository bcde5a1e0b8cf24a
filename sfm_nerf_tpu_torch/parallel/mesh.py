"""Device meshes over ``torch.distributed`` ranks and process-group
start-up (sfm_nerf_tpu/parallel/mesh.py).

One rank is one process and one device.  ``make_mesh`` lays the ranks of
the initialised world out as ('data', 'model'), rank r at (r // tp, r % tp);
``make_multihost_mesh`` as ('dcn', 'data', 'model'), one 'dcn' row per node
of ``LOCAL_WORLD_SIZE`` ranks, so the rays' all-reduce spans the nodes.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from sfm_nerf_tpu_torch import DEFAULT_DEVICE


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_from_env or init_local first")
    return dist.get_world_size()


def make_mesh(dp: int = 0, tp: int = 1, device_type: str = DEFAULT_DEVICE,
              data_axis: str = "data", model_axis: str = "model") -> DeviceMesh:
    """('data', 'model') mesh over ranks [0, dp * tp).  ``dp <= 0`` takes
    every rank that ``tp`` leaves."""
    n = _world()
    if tp < 1 or n % tp:
        raise ValueError(f"tp={tp} must divide world size {n}")
    if dp <= 0:
        dp = n // tp
    if dp * tp > n:
        raise ValueError(f"dp*tp={dp * tp} exceeds world size {n}")
    return DeviceMesh(device_type, torch.arange(dp * tp).reshape(dp, tp),
                      mesh_dim_names=(data_axis, model_axis))


def make_multihost_mesh(dp_per_host: int = 0, tp: int = 1,
                        device_type: str = DEFAULT_DEVICE, data_axis: str = "data",
                        model_axis: str = "model", dcn_axis: str = "dcn") -> DeviceMesh:
    """('dcn', 'data', 'model') mesh: one 'dcn' row per node, a node being
    ``LOCAL_WORLD_SIZE`` consecutive ranks (torchrun's layout; the whole
    world when the variable is unset, so one node gives dcn = 1)."""
    n = _world()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if n % local:
        raise ValueError(f"world size {n} is not whole nodes of {local} ranks")
    if tp < 1 or local % tp:
        raise ValueError(f"tp={tp} must divide the ranks per node {local}")
    if dp_per_host <= 0:
        dp_per_host = local // tp
    if dp_per_host * tp > local:
        raise ValueError(f"dp_per_host*tp={dp_per_host * tp} exceeds the ranks per node {local}")
    nodes = n // local
    ranks = torch.arange(n).reshape(nodes, local)[:, :dp_per_host * tp]
    return DeviceMesh(device_type, ranks.reshape(nodes, dp_per_host, tp),
                      mesh_dim_names=(dcn_axis, data_axis, model_axis))


def axes_group(mesh: DeviceMesh, axes: Sequence[str]):
    """The process group spanning the mesh axes ``axes`` together."""
    axes = tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def axes_size(mesh: DeviceMesh, axes: Sequence[str]) -> int:
    size = 1
    for a in axes:
        size *= mesh.size(mesh.mesh_dim_names.index(a))
    return size


def linear_index(mesh: DeviceMesh, axes: Sequence[str]) -> int:
    """This rank's position on the mesh axes ``axes``, row-major in their
    order (JAX's linearised ``axis_index``)."""
    idx = 0
    for a in axes:
        idx = idx * mesh.size(mesh.mesh_dim_names.index(a)) + mesh.get_local_rank(a)
    return idx


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_from_env(device: str = DEFAULT_DEVICE) -> torch.device:
    """Start the process group a launcher describes (torchrun's ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``) and
    return this rank's device: ``cuda:LOCAL_RANK`` over NCCL, or the CPU
    over gloo.  Without ``WORLD_SIZE`` there is no group to join and the
    device is returned as given.  A group that cannot start raises."""
    if "WORLD_SIZE" not in os.environ:
        return torch.device(device)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(_backend(dev), init_method="env://")
    return dev


def init_local(backend: str, rank: int, world_size: int, port: int,
               device: Optional[torch.device] = None) -> None:
    """Start a process group of ``world_size`` processes on this machine
    (its store at ``tcp://localhost:port``), for tests and the smoke run.
    ``device``: this rank's card, made current first."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world_size)
