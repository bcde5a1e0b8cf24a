"""The yardstick's arithmetic: the chip's peaks, the NeRF MLP's operations
and the least bytes of each kernel call, from the network's shapes alone.

A frozen copy of ``chip_smoke.py``'s bound arithmetic (``PEAK_BF16``,
``PEAK_BYTES``, the three-forwards rule of a training step).  The network's
own counts (``macs_per_point``, ``macs_per_ray``) and shapes come from the
plain reference of its configuration (``arch``, the module that the
configuration's ``reference`` key names).  Nothing here imports the
program, so a change there cannot move it.

Operations are multiply-adds times two.  A forward of the network over
``rays`` x ``samples`` points is ``macs_per_point`` per point plus
``macs_per_ray`` per ray.  A training step's least work is three forwards
per network pass (the forward, ``d_h W^T`` and ``act^T d_h``); whatever a
kernel recomputes is not counted.  Bytes count each input read once and
each output written once.
"""

from __future__ import annotations

from typing import Tuple

PEAK_BF16 = 989e12      # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet)
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s


def param_count(arch, m) -> int:
    return sum(fi * fo + fo for fi, fo in arch.layer_shapes(m).values())


def forward_flops(arch, m, rays: int, samples: int) -> float:
    """Operations of one forward of the network over rays x samples."""
    return 2.0 * (arch.macs_per_point(m) * rays * samples + arch.macs_per_ray(m) * rays)


def train_flops(arch, m, rays: int, samples: int) -> float:
    """Least operations of one training pass of one network: three forwards."""
    return 3.0 * forward_flops(arch, m, rays, samples)


def _param_bytes(arch, m) -> Tuple[int, int]:
    """(bf16 weight bytes + float32 bias bytes read, float32 grad bytes
    written) of one network."""
    shapes = arch.layer_shapes(m).values()
    n_w = sum(fi * fo for fi, fo in shapes)
    n_b = sum(fo for _, fo in shapes)
    return 2 * n_w + 4 * n_b, 4 * (n_w + n_b)


def render_bytes(arch, m, rays: int, samples: int) -> int:
    """Rays, depths and packed weights in; rgb out."""
    w_in, _ = _param_bytes(arch, m)
    return rays * 24 + rays * samples * 4 + w_in + rays * 12


def train_bytes(arch, m, rays: int, samples: int, weights_out: bool = False) -> int:
    """Rays, depths, targets and packed weights in; rgb, every grad (and
    the weights) out."""
    w_in, g_out = _param_bytes(arch, m)
    out = rays * 12 + g_out + (rays * samples * 4 if weights_out else 0)
    return rays * 24 + rays * samples * 4 + rays * 12 + w_in + out


def least_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / PEAK_BF16, nbytes / PEAK_BYTES)
