"""A full frame's rays split over the data ranks
(sfm_nerf_tpu/parallel/render.py).

The frame's H*W rays are padded to a multiple of the data ranks (padded rays
look along +z from the origin) and cut into contiguous slices; each rank
renders its slice through the route of the single-device renderer
(``make_render_rays``: K1 flat; K5 -> ``sample_pdf`` -> K1 for a pair; the
``nn.Module`` outside the kernels' envelope) and writes it into a zero
frame, and one ``all_reduce(SUM)`` assembles the frame on every rank.
Adding zeros is exact, and ``all_reduce`` is what every backend offers on
CUDA tensors.  Without a generator the samples are the deterministic ones,
so each ray's colour is the single-device renderer's; with one, each rank
draws from a generator folded from it by its position.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from sfm_nerf_tpu_torch.config import NeRFPipelineConfig
from sfm_nerf_tpu_torch.ops.rays import image_rays
from sfm_nerf_tpu_torch.parallel.train_step import draw_seed


def make_sharded_render_image(cfg: NeRFPipelineConfig, mesh: DeviceMesh):
    """Renderer ``(model, K, pose, H, W, generator=None) -> (H, W, 3)``, the
    signature of ``make_render_image``; every rank of ``mesh`` calls it with
    the same arguments and gets the whole frame.  The model is whole on
    every rank (plain tensors)."""
    from sfm_nerf_tpu_torch.train.nerf_trainer import make_render_rays

    axis = cfg.parallel.data_axis
    group = mesh.get_group(axis)
    dp = mesh.size(mesh.mesh_dim_names.index(axis))
    r = mesh.get_local_rank(axis)
    render_rays_of = make_render_rays(cfg)

    @torch.no_grad()
    def render_image(model, K, pose: torch.Tensor, height: int, width: int,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        o, d = image_rays(K, pose, height, width)
        n = height * width
        per = -(-n // dp)
        pad = per * dp - n
        if pad:
            o = torch.cat([o, o.new_zeros(pad, 3)])
            d = torch.cat([d, d.new_tensor([0.0, 0.0, 1.0]).expand(pad, 3)])
        local = None
        if generator is not None:
            seed = int(torch.randint(0, 2**62, (), generator=generator,
                                     device=generator.device))
            local = torch.Generator(device=o.device).manual_seed(draw_seed(seed, r))
        rows = slice(r * per, (r + 1) * per)
        frame = o.new_zeros(per * dp, 3)
        frame[rows] = render_rays_of(model, o[rows], d[rows], local)
        dist.all_reduce(frame, group=group)
        return frame[:n].reshape(height, width, 3)

    return render_image
