"""ipe_points.mip: the points a mip-NeRF step encodes in the cone kernels
(the program's own ``ipe_points`` counter, rays x intervals per call,
over the traced slice, per ``train.step``); nothing where no cone kernel
ran (the nn.Module route)."""

SPANS = []
NAME = "ipe_points"


def read(view):
    from sfm_nerf_tpu_torch.utils import profiling

    summary = getattr(profiling, "summary", None)    # a program without its own spans
    if summary is None:
        return None
    rec = summary()
    steps = rec["spans"].get("train.step", {}).get("roots", 0)
    if not steps or not rec["counters"].get(NAME):
        return None
    return rec["counters"][NAME] / steps
