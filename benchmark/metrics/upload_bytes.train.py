"""upload_bytes.train: bytes a training step copies from host arrays to
the device at the program's explicit upload sites (the program's own
``upload_bytes`` counter over the traced slice, per ``train.step`` it
recorded)."""

SPANS = []
NAME = "upload_bytes"


def read(view):
    from sfm_nerf_tpu_torch.utils import profiling

    summary = getattr(profiling, "summary", None)    # a program without its own spans
    if summary is None:
        return None
    rec = summary()
    steps = rec["spans"].get("train.step", {}).get("roots", 0)
    if not steps:
        return None
    return rec["counters"].get(NAME, 0) / steps
