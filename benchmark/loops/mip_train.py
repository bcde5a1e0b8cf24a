"""The training loop of mip-NeRF, as ``NeRFTrainer._fit_loop`` runs it: one
``make_train_step`` call a step on a fresh seeded batch, the SIGINT guard
released after it, the loss read on the host every ``log_every`` steps, no
checkpoint and no validation.

The network and the method are the configuration's reference
(``reference/mipnerf.py``, loaded as ``arch``): cones, two levels through
one network, the blurred resampler, the log-linear learning rate.  Set-up
refuses a program that has no mip arch or no log-linear schedule (the
configuration's fields would be dropped and the plain NeRF route run
instead), builds the one step
object the window drives (one NeRF, Adam, its schedule), makes the images,
poses and weights from the seed, and drives the step through its first
three steps, keeping what the check compares: each step's loss, the first
gradient as Adam holds it after one step, and every parameter's change
over the three.  Then ``warmup_steps`` more.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from benchmark import compare, counts, inputs, program
from benchmark.reference import nerf as nerf_reference

CHECK_STEPS = 3
# the schedule's fields: a program without them cannot run the cell
NEEDS = ("lr_schedule", "lrate_final", "lr_anneal_steps")


def require_cone_casting() -> None:
    """Raises where the program's models have no mip arch (the arch that
    casts cones) or its TrainConfig lacks a field of NEEDS."""
    from sfm_nerf_tpu_torch import config
    from sfm_nerf_tpu_torch.models import nerf

    try:
        nerf.layer_shapes(config.NeRFModelConfig(arch="mip"))
    except ValueError as e:
        raise RuntimeError(f"the program has no cone casting (mip-NeRF): {e}") from None
    missing = [f for f in NEEDS
               if f not in {x.name for x in dataclasses.fields(config.TrainConfig)}]
    if missing:
        raise RuntimeError("the program has no cone casting (mip-NeRF): its TrainConfig lacks "
                           + ", ".join(missing))


class Loop:
    unit = "step"

    def __init__(self, spec: Dict, seed: int, device):
        require_cone_casting()
        self.m, self.r, self.t, self.d = (spec["groups"][k]
                                          for k in ("model", "render", "train", "data"))
        self.arch, self.traffic = spec["arch"], spec["traffic"]
        self.seed, self.device = seed, torch.device(device)

    def setup(self) -> None:
        from sfm_nerf_tpu_torch.train.nerf_trainer import (
            UpdateGuard, make_optimizer, make_train_step,
        )

        dev, seed = self.device, self.seed
        self.images = inputs.training_images(self.d, seed, dev)
        self.poses = inputs.sphere_poses(self.d["n_images"], self.d["radius"], seed, dev)
        self.K = inputs.camera_matrix(self.d, dev)
        self.nets0 = nerf_reference.init_params(self.arch, self.m, 1,
                                                inputs.generator(seed, "weights", dev), dev)
        cfg = program.pipeline_config(self.m, self.r, self.t)
        self.model = program.build_model(cfg, self.nets0, dev)
        self.opt, self.sched = make_optimizer(cfg, self.model)
        self.guard = UpdateGuard()
        self.step = make_train_step(cfg, self.opt, self.sched, self.guard)
        self.gen = inputs.generator(seed, "draws", dev)
        self.it = 0
        leaves = program.leaves(self.model)
        start = {k: p.detach().clone() for k, p in leaves.items()}
        losses, first = [], None
        for _ in range(CHECK_STEPS):
            losses.append(self._step())
            if first is None:
                first = {k: self._first_grad(p) for k, p in leaves.items()}
        delta = {k: p.detach() - start[k] for k, p in leaves.items()}
        for _ in range(self.traffic["warmup_steps"]):
            self.run_unit()
        self.readings = ([float(x) for x in losses], first, delta)

    def _first_grad(self, p) -> torch.Tensor:
        """The gradient Adam took in its first step, from its first moment
        (zero where it holds none)."""
        st = self.opt.state.get(p, {})
        if "exp_avg" not in st:
            return torch.zeros_like(p)
        return st["exp_avg"] / (1.0 - nerf_reference.BETAS[0])

    def _step(self) -> torch.Tensor:
        loss = self.step(self.model, self.gen, self.images, self.poses, self.K)
        self.guard.release()
        if self.it % self.t["log_every"] == 0:
            float(loss)
        self.it += 1
        return loss

    def run_unit(self) -> None:
        self._step()

    def unit_flops(self) -> float:
        """Two levels, each three forwards of every ray x interval."""
        return 2 * counts.train_flops(self.arch, self.m, self.t["n_rays_batch"],
                                      self.r["n_sample"])

    def end_to_end(self, units: int, seconds: float, unit_s: List[float]) -> Dict[str, float]:
        return {"train_rays_per_s": units * self.t["n_rays_batch"] / seconds}

    def release(self) -> None:
        """Frees the program's state; the inputs and the readings stay."""
        del self.model, self.opt, self.sched, self.step, self.gen
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference_readings(self, precision: str = "f32"):
        return self.arch.train_steps(
            self.nets0, self.m, self.r, self.t, self.images, self.poses, self.K,
            inputs.sub_seed(self.seed, "draws"), CHECK_STEPS, precision)

    def check(self) -> Dict[str, float]:
        return compare.train_numbers(self.readings, self.reference_readings())
