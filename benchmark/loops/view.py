"""The view loop, as test and gif mode run it: one client renders full
views one after another through ``make_render_image`` with un-jittered
depths, each ending with its frame on the host (``.cpu()``).

The network is the configuration's (its plain reference, ``arch``, from
the file its ``reference`` key names); its weights and the camera poses
come from the traffic's files; the order in which the poses are cycled is drawn from the seed.
After the window, ``check_views`` of the frames served, drawn from the
seed, are held against the reference's frames.
"""

from __future__ import annotations

import os
import statistics
from typing import Dict, List

import numpy as np
import torch

from benchmark import compare, counts, inputs, program
from benchmark.reference import nerf as reference

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Loop:
    unit = "view"

    def __init__(self, spec: Dict, seed: int, device):
        self.m, self.r, self.t = (spec["groups"][k] for k in ("model", "render", "train"))
        self.arch, self.traffic = spec["arch"], spec["traffic"]
        self.seed, self.device = seed, torch.device(device)
        self.height, self.width = (self.traffic["camera"][k] for k in ("height", "width"))

    def setup(self) -> None:
        from sfm_nerf_tpu_torch.train.nerf_trainer import make_render_image

        dev = self.device
        self.net = inputs.read_weights(os.path.join(ROOT, self.traffic["weights"]),
                                       self.arch.layer_shapes(self.m), dev)
        cfg = program.pipeline_config(self.m, self.r, self.t)
        self.model = program.build_model(cfg, [self.net], dev).eval()
        self.render = make_render_image(cfg)
        self.K = inputs.camera_matrix(self.traffic["camera"], dev)
        self.poses = torch.tensor(self.traffic["poses"], dtype=torch.float32, device=dev)
        rng = np.random.default_rng(inputs.sub_seed(self.seed, "order"))
        self.order = rng.permutation(len(self.poses))
        self.served: List = []
        for _ in range(self.traffic["warmup_views"]):
            self._view()
        self.served = []

    def _view(self) -> None:
        v = int(self.order[len(self.served) % len(self.order)])
        frame = self.render(self.model, self.K, self.poses[v], self.height, self.width)
        self.served.append((v, frame.cpu()))

    def run_unit(self) -> None:
        self._view()

    def unit_flops(self) -> float:
        return counts.forward_flops(self.arch, self.m, self.height * self.width,
                                    self.r["n_sample"])

    def end_to_end(self, units: int, seconds: float, unit_s: List[float]) -> Dict[str, float]:
        return {"view_ms": seconds / units * 1e3,
                "view_ms_p90": statistics.quantiles(unit_s, n=10)[-1] * 1e3}

    def release(self) -> None:
        del self.model, self.render
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self) -> List[int]:
        """Which served frames the check holds, drawn from the seed."""
        rng = np.random.default_rng(inputs.sub_seed(self.seed, "check"))
        k = min(self.traffic["check_views"], len(self.served))
        return sorted(rng.choice(len(self.served), k, replace=False).tolist())

    def reference_frame(self, v: int, precision: str = "f32") -> torch.Tensor:
        return reference.render_frame(self.arch, self.net, self.m, self.r, self.K, self.poses[v],
                                      self.height, self.width, precision)

    def check(self) -> Dict[str, float]:
        pairs = [(self.served[i][1], self.reference_frame(self.served[i][0]))
                 for i in self.sample()]
        return compare.frame_numbers(pairs)
