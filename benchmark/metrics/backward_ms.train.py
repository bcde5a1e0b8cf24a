"""backward_ms.train: device milliseconds a training step queued inside
``loss.backward()`` (the program's own ``train.backward`` span over the
traced slice, per ``train.step`` it recorded)."""

SPANS = []
NAME = "train.backward"


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
