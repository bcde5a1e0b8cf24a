"""stash_ms.train: device milliseconds a training step in the split
step's forward sweeps (the render kernel compiled with STASH), K2's and
K4's calls together: the program's own ``k2.stash`` span over the traced
slice, per ``train.step`` it recorded."""

SPANS = []
NAME = "k2.stash"


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
