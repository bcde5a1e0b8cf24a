"""Sizes at which a whole run of a cell fits a test on the CPU: the same
code paths, small tensors (the program's CUDA kernels run their plain
versions on CPU tensors)."""

import copy
import time

from benchmark import harness

TRAIN = {"model": {"hidden": 32}, "render": {"n_sample": 16},
         "train": {"n_rays_batch": 64, "log_every": 5},
         "data": {"n_images": 3, "height": 16, "width": 16}, "traffic": {"trace_units": 3}}
HIER = copy.deepcopy(TRAIN)
HIER["render"]["n_importance"] = 8
VIEW = {"render": {"n_sample": 16},
        "traffic": {"camera": {"height": 16, "width": 16, "camera_angle_x": 0.6911112070083618},
                    "trace_units": 3}}
CELLS = {"flat-train": TRAIN, "flat-train-wrapper": TRAIN, "hier-train": HIER,
         "flat-render": VIEW}
SEED = 2**31 + 11


def overrides(cell: str):
    return copy.deepcopy(CELLS[cell])


def run(cell: str, trace: bool = False, seconds: float = 0.3, root: str = harness.ROOT,
        seed: int = SEED):
    """One CPU run of ``cell`` at the small sizes: (result, stderr lines)."""
    return harness.run(cell, seed, seconds, trace, time.perf_counter(), root=root,
                       device="cpu", overrides=overrides(cell))


def loop(cell: str, seed: int = SEED):
    """The cell's loop at the small sizes, set up on the CPU."""
    spec = harness.resolve(cell)
    for g, over in overrides(cell).items():
        (spec["traffic"] if g == "traffic" else spec["groups"][g]).update(over)
    lp = harness.make_loop(spec, seed, "cpu")
    lp.setup()
    return spec, lp
