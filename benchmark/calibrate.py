"""The readings that the limits of ``correct`` are set from, for one cell:
the program against the reference on each seed, and each control in the
program's place.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--out FILE]

Training cells: per seed, set-up as a run makes it (its three check
steps), then the reference; then, in the program's place, the reference
at the limits file's ``control`` precision and the reference with half of
each batch left out.  The view cell: every pose of its traffic rendered
by the program, by the reference, and by the control (the seed only
orders the poses, so the poses stand for the seeds).  One JSON line per
seed or view; the last line sums up: the largest program reading and the
smallest control and fault readings of each number.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import compare, harness  # noqa: E402


def train_readings(spec, seeds, device):
    control = spec["limits"]["control"]
    for seed in seeds:
        loop = harness.make_loop(spec, seed, device)
        loop.setup()
        loop.release()
        ref = loop.reference_readings("f32")
        row = {"seed": seed, "program": compare.train_numbers(loop.readings, ref)}
        for what in (control, "half"):
            row[what] = compare.train_numbers(loop.reference_readings(what), ref)
        yield row


def view_readings(spec, seed, device, views=None):
    import torch

    control = spec["limits"]["control"]
    loop = harness.make_loop(spec, seed, device)
    loop.setup()
    for v in range(len(loop.poses)) if views is None else views:
        frame = loop.render(loop.model, loop.K, loop.poses[v], loop.height, loop.width).cpu()
        ref = loop.reference_frame(v)
        row = {"view": v, "program": compare.frame_numbers([(frame, ref)]),
               control: compare.frame_numbers([(loop.reference_frame(v, control), ref)])}
        del ref
        if device == "cuda":
            torch.cuda.empty_cache()
        yield row


def summary(rows):
    out = {}
    for row in rows:
        for what, numbers in row.items():
            if not isinstance(numbers, dict):
                continue
            pick = max if what == "program" else min
            agg = out.setdefault(what, {})
            for k, v in numbers.items():
                agg[k] = pick(agg[k], v) if k in agg else v
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 benchmark/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--out", default=None, help="also append the lines to this file")
    args = p.parse_args(argv)
    spec = harness.resolve(args.workload)
    device = harness.require_cuda(spec["cell"]["chips"])
    seeds = [int(s) for s in args.seeds.split(",")]
    gen = (train_readings(spec, seeds, device) if spec["traffic"]["loop"] == "train"
           else view_readings(spec, seeds[0], device))
    rows = []
    for row in gen:
        rows.append(row)
        line = json.dumps({"workload": args.workload, **row})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    line = json.dumps({"workload": args.workload, "summary": summary(rows)})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
