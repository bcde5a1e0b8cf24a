"""gemm_bytes.train: bytes the split step's weight GEMM (grad_gemm.cu) fetches
from the two stashes a training step, a block multicast to both blocks of a
cluster once (the program's own ``gemm_bytes`` counter over the traced
slice, per ``train.step`` it recorded).  A program without the counter reads
nothing."""

SPANS = []
NAME = "gemm_bytes"


def read(view):
    from sfm_nerf_tpu_torch.utils import profiling

    summary = getattr(profiling, "summary", None)    # a program without its own spans
    if summary is None:
        return None
    rec = summary()
    steps = rec["spans"].get("train.step", {}).get("roots", 0)
    if not steps or NAME not in rec["counters"]:
        return None
    return rec["counters"][NAME] / steps
