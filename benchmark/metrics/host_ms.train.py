"""host_ms.train: host milliseconds a training step spends in the
program's own ``train.step`` span (host clock, over the traced slice, so
the profiler's own host cost is in it: a yardstick between commits, not
the untraced host time)."""

SPANS = []
NAME = "train.step"


def read(view):
    from sfm_nerf_tpu_torch.utils import profiling

    summary = getattr(profiling, "summary", None)    # a program without its own spans
    if summary is None:
        return None
    rec = summary()
    steps = rec["spans"].get("train.step", {}).get("roots", 0)
    if not steps:
        return None
    return rec["spans"][NAME]["host_ms"] / steps
