#!/usr/bin/env python3
"""Where the Phase 1 path's time goes on the card.

    python3 sfm_probe.py

Writes chip_smoke.py's 12-camera SfM dataset under build/sfm_probe/
(git-ignored), runs ``cli.sfm`` on it once to warm up, then once under
``torch.profiler`` (CUDA activity only) and reports, per pipeline stage
and for the whole run: the wall time, the number of kernels the card ran,
their summed time and so the card's busy share (kernels run one at a time
on the one stream the path uses), and the five kernels that took the most
time.  Prints the card's name and power limit, then one JSON line.  Needs
a CUDA card.
"""

import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "build", "sfm_probe")


def main():
    sys.path.insert(0, REPO)
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import SFM_CAMS, SFM_POINTS, SFM_WINDOW, write_sfm_dataset
    from sfm_nerf_tpu_torch.cli import sfm as cli
    from sfm_nerf_tpu_torch.sfm import pipeline

    if not torch.cuda.is_available():
        print("sfm_probe: no CUDA device visible", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    shutil.rmtree(OUT, ignore_errors=True)
    data = os.path.join(OUT, "data")
    write_sfm_dataset(data, SFM_CAMS, SFM_POINTS, SFM_WINDOW)
    argv = ["--data_path", data, "--num_images", str(SFM_CAMS), "--merge_tracks",
            "--output_dir", os.path.join(OUT, "out")]
    cli.main(argv)                                     # warm-up

    # stage boundaries on the host clock, as sfm_stats.json records them
    marks = []
    run = pipeline.SfMPipeline.run

    def timed_run(self):
        t0 = time.time()
        res = run(self)
        edges, t = [], t0
        for name, secs in res["stats"]["stage_seconds"].items():
            edges.append((name, t, t + secs))
            t += secs
        marks.extend(edges)
        return res

    pipeline.SfMPipeline.run = timed_run
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t_start = time.time()
        cli.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t_start
    pipeline.SfMPipeline.run = run

    # kernel events on the card's clock; the profiler's timestamps are
    # microseconds from its own start, which lines up with t_start to the
    # warm-up's precision: the stage split below is approximate, the totals
    # are not
    events = [e for e in prof.events() if e.device_type.name == "CUDA"]
    t0_us = min(e.time_range.start for e in events)
    base = marks[0][1]
    stages = {name: {"wall_s": round(t1 - ta, 3), "kernels": 0, "kernel_s": 0.0}
              for name, ta, t1 in marks}
    for e in events:
        t = base + (e.time_range.start - t0_us) / 1e6
        for name, ta, t1 in marks:
            if ta <= t < t1:
                stages[name]["kernels"] += 1
                stages[name]["kernel_s"] += e.time_range.elapsed_us() / 1e6
                break
    for v in stages.values():
        v["kernel_s"] = round(v["kernel_s"], 3)
        v["busy_share"] = round(v["kernel_s"] / max(v["wall_s"], 1e-9), 3)
    kernel_s = sum(e.time_range.elapsed_us() for e in events) / 1e6
    by_name = {}
    for e in events:
        k = by_name.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += e.time_range.elapsed_us() / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]
    print(json.dumps({
        "probe": "sfm", "cams": SFM_CAMS, "points": SFM_POINTS, "wall_s": round(wall, 2),
        "kernels": len(events), "kernel_s": round(kernel_s, 3),
        "busy_share": round(kernel_s / wall, 3),
        "mean_kernel_us": round(kernel_s / max(len(events), 1) * 1e6, 2),
        "stages": stages,
        "top_kernels": [{"name": n[:80], "count": c, "s": round(t, 3)} for n, (c, t) in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
