"""resample_ms.mip: device milliseconds a mip-NeRF step queued inside the
program's own ``train.resample`` span (the blurred resampler between the
coarse and the fine level), over the traced slice, per ``train.step``."""

SPANS = []
NAME = "train.resample"


def read(view):
    from sfm_nerf_tpu_torch.utils import profiling

    summary = getattr(profiling, "summary", None)    # a program without its own spans
    if summary is None:
        return None
    rec = summary()
    steps = rec["spans"].get("train.step", {}).get("roots", 0)
    if not steps or NAME not in rec["spans"]:
        return None
    return rec["spans"][NAME]["device_ms"] / steps
