"""One rank of the port's multi-process tests (tests/test_torch_parallel.py).

    python tests/torch_parallel_worker.py CASE RANK WORLD PORT OUT_DIR

CASE is a ``torch.save``'d dict the test wrote: ``task`` names the function
below, the rest is its data (numpy arrays, config fields).  The rank starts
a gloo group of WORLD processes on localhost:PORT, runs the task on the
CPU and writes what it returns to ``OUT_DIR/rank{RANK}.pt``.  It imports
torch and the port only: the JAX side is computed in the test process.
"""

import dataclasses
import os
import sys
import warnings

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from sfm_nerf_tpu_torch.config import (  # noqa: E402
    NeRFModelConfig, NeRFPipelineConfig, ParallelConfig, RenderConfig, TrainConfig,
)
from sfm_nerf_tpu_torch.models.convert import params_from_jax, params_to_jax  # noqa: E402
from sfm_nerf_tpu_torch.models.nerf import NeRF  # noqa: E402
from sfm_nerf_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from sfm_nerf_tpu_torch.parallel import train_step as pstep  # noqa: E402
from sfm_nerf_tpu_torch.parallel.render import make_sharded_render_image  # noqa: E402
from sfm_nerf_tpu_torch.train.nerf_trainer import (  # noqa: E402
    NeRFTrainer, make_loss_fn, make_optimizer, make_render_image,
)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _cfg(c, **render):
    return NeRFPipelineConfig(
        model=NeRFModelConfig(**c["model"]),
        render=RenderConfig(**{**c["render"], **render}),
        train=TrainConfig(**c["train"]),
        parallel=ParallelConfig(**c.get("parallel", {})))


def _hooks(d):
    """A rank's draws as the loss's hooks."""
    return dict(draws=tuple(_t(a) for a in d["draws"]), u=_t(d["u"]), u_pdf=_t(d.get("u_pdf")))


def _replay(cfg, params, scene, rank_draws):
    """One process, whole weights: the mean of every rank's loss on its own
    draws, one Adam step.  The sharded steps must equal it."""
    model = params_from_jax(params, cfg.model)
    opt, sched = make_optimizer(cfg, model)
    loss_fn = make_loss_fn(cfg, n_rays=cfg.train.n_rays_batch // len(rank_draws))
    loss = torch.stack([loss_fn(model, None, *scene, **_hooks(d)) for d in rank_draws]).mean()
    loss.backward()
    opt.step()
    sched.step()
    return float(loss.detach()), params_to_jax(model)


def _dp_step(cfg, params, scene, mesh, hooks):
    model = params_from_jax(params, cfg.model)
    opt, sched = make_optimizer(cfg, model)
    step = pstep.make_dp_train_step(cfg, opt, sched, mesh)
    loss = step(model, None, *scene, **hooks)
    return float(loss), params_to_jax(model), step.draw_index


def nerf(c, rank, world):
    """The dp step (module, fused flat, fused pair), the multi-node mesh, the
    dp x tp step and its out-of-envelope route, and the sharded frame."""
    scene = tuple(_t(c[k]) for k in ("images", "poses", "K"))
    out = {}
    flat = pmesh.make_mesh(dp=world, tp=1, device_type="cpu")
    for name, kind, render in (("dp_module", "flat", dict(use_fused_kernel=False)),
                               ("dp_fused", "flat", dict(use_fused_kernel=True)),
                               ("dp_pair", "pair", dict(use_fused_kernel=True,
                                                        n_importance=c["n_importance"]))):
        cfg = _cfg(c, **render)
        draws = c["draws"][name]
        loss, params, idx = _dp_step(cfg, c["params"][kind], scene, flat, _hooks(draws[rank]))
        out[name] = {"loss": loss, "params": params, "draw_index": idx}
        if rank == 0:
            out[name]["replay"] = _replay(cfg, c["params"][kind], scene, draws)

    # ('dcn', 'data', 'model') with LOCAL_WORLD_SIZE ranks a node, the draws
    # of dp_fused by linearised position
    cfg = _cfg(c, use_fused_kernel=True)
    multi = pmesh.make_multihost_mesh(dp_per_host=0, tp=1, device_type="cpu")
    loss, params, idx = _dp_step(cfg, c["params"]["flat"], scene, multi,
                                 _hooks(c["draws"]["dp_fused"][rank]))
    out["multihost"] = {"loss": loss, "params": params, "draw_index": idx,
                        "shape": dict(zip(multi.mesh_dim_names, multi.shape))}

    # dp x tp: parameters stored sharded over 'model'
    grid = pmesh.make_mesh(dp=world // 2, tp=2, device_type="cpu")
    for name, render, model_kw in (("spmd", dict(use_fused_kernel=True), {}),
                                   ("spmd_module", dict(use_fused_kernel=True),
                                    dict(hidden=c["odd_hidden"]))):
        cc = {**c, "model": {**c["model"], **model_kw}}
        cfg = _cfg(cc, **render)
        kind = "flat" if not model_kw else "odd"
        model = params_from_jax(c["params"][kind], cfg.model)
        placements = pstep.mlp_param_placements(model, grid)
        pstep.distribute_params(model, grid, placements)
        opt, sched = make_optimizer(cfg, model)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            step = pstep.make_spmd_train_step(cfg, opt, sched, grid, model)
        draws = c["draws"][name]
        loss = step(model, None, *scene, **_hooks(draws[step.draw_index]))
        out[name] = {"loss": float(loss), "params": params_to_jax(model),
                     "draw_index": step.draw_index,
                     "warned": [str(w.message) for w in caught],
                     "placements": {k: {kk: [repr(p) for p in v] for kk, v in d.items()}
                                    for k, d in placements.items()},
                     "shapes": {k: (tuple(layer.weight.to_local().shape), tuple(layer.weight.shape))
                                for k, layer in model.layers.items()}}
        if rank == 0:
            out[name]["replay"] = _replay(cfg, c["params"][kind], scene, draws)
    pair = params_from_jax(c["params"]["pair"], _cfg(c).model)
    out["placements_pair"] = {
        side: {k: {kk: [repr(p) for p in v] for kk, v in d.items()} for k, d in tree.items()}
        for side, tree in pstep.mlp_param_placements(pair, grid).items()}

    # the sharded frame against the single-device frame, every route
    K, pose = scene[2], _t(c["frame_pose"])
    h, w = c["frame_hw"]
    for name, kind, render in (("render_fused", "flat", dict(use_fused_kernel=True)),
                               ("render_pair", "pair", dict(use_fused_kernel=True,
                                                            n_importance=c["n_importance"])),
                               ("render_module", "flat", dict(use_fused_kernel=False))):
        cfg = _cfg(c, perturb=False, **render)
        model = params_from_jax(c["params"][kind], cfg.model).eval()
        img = make_sharded_render_image(cfg, flat)(model, K, pose, h, w)
        out[name] = {"image": img.numpy()}
        if rank == 0:
            out[name]["single"] = make_render_image(cfg)(model, K, pose, h, w).numpy()
    # perturbed: every rank draws from its own fold of the generator
    cfg = _cfg(c, use_fused_kernel=True)
    model = params_from_jax(c["params"]["flat"], cfg.model).eval()
    gen = torch.Generator().manual_seed(5)
    out["render_keyed"] = {"image": make_sharded_render_image(cfg, flat)(
        model, K, pose, h, w, gen).numpy()}
    return out


def trainer(c, rank, world):
    """A fit of the port's trainer over every rank: the dp step, rank 0's
    checkpoints and validation."""
    cfg = NeRFPipelineConfig(
        model=NeRFModelConfig(**c["model"]), render=RenderConfig(**c["render"]),
        train=TrainConfig(**c["train"]), checkpoint_path=c["checkpoint_path"],
        load_checkpoint=False)
    tr = NeRFTrainer(cfg, c["images"], c["poses"], c["K"], device="cpu")
    stats = tr.fit(max_iters=c["max_iters"], progress=False)
    out = {"params": params_to_jax(tr.model), "stats": stats, "loss_log": tr.loss_log,
           "val_log": tr.val_log, "mesh": dict(zip(tr.mesh.mesh_dim_names, tr.mesh.shape)),
           "draw_index": tr.train_step.draw_index}
    # tp = 2: parameters stored sharded; checkpoints and validation gather
    # them; a second trainer resumes into the shards
    tp = dataclasses.replace(cfg, parallel=ParallelConfig(tp=2),
                             checkpoint_path=c["checkpoint_path_tp"])
    fits = []
    for max_iters, resume in ((c["tp_iters"][0], False), (c["tp_iters"][1], True)):
        tr = NeRFTrainer(dataclasses.replace(tp, load_checkpoint=resume),
                         c["images"], c["poses"], c["K"], device="cpu")
        st = tr.fit(max_iters=max_iters, progress=False)
        fits.append({"start_iter": tr.start_iter, "steps": st["steps"],
                     "params": params_to_jax(tr.model), "sharded": tr.sharded,
                     "mesh": dict(zip(tr.mesh.mesh_dim_names, tr.mesh.shape)),
                     "val_log": tr.val_log})
    out["tp"] = fits
    out["tp_interrupt"] = _interrupted_tp(c, tp, rank)
    return out


def _interrupted_tp(c, tp, rank):
    """dp1 x tp2 with SIGINT sent to this rank inside its optimizer's
    update of step ``interrupt_at`` (both ranks, as torchrun sends it to
    every rank): each rank writes its shards stamped with that step; a new
    trainer resumes from them, writing a whole checkpoint.  Rank 0 also
    replays the run in one process: whole weights, the mean of both ranks'
    losses on their own draw streams, one Adam step at a time."""
    import signal

    from sfm_nerf_tpu_torch.parallel.train_step import draw_seed

    cfg = dataclasses.replace(tp, checkpoint_path=c["checkpoint_path_int"],
                              load_checkpoint=False)
    n = c["interrupt_at"]
    tr = NeRFTrainer(cfg, c["images"], c["poses"], c["K"], device="cpu")

    def hook(opt, args, kwargs):
        if int(next(iter(opt.state.values()))["step"]) == n:
            os.kill(os.getpid(), signal.SIGINT)

    tr.optimizer.register_step_post_hook(hook)
    try:
        tr.fit(max_iters=n + 5, progress=False)
        interrupted = False
    except KeyboardInterrupt:
        interrupted = True
    dist.barrier()
    shard_files = sorted(os.listdir(cfg.checkpoint_path))
    again = NeRFTrainer(dataclasses.replace(cfg, load_checkpoint=True),
                        c["images"], c["poses"], c["K"], device="cpu")
    resumed = again.try_resume()
    out = {"interrupted": interrupted, "files_after_interrupt": shard_files,
           "ckpt_dir": cfg.checkpoint_path,
           "resumed": resumed, "start_iter": again.start_iter,
           "params": params_to_jax(again.model),
           "files_after_resume": sorted(os.listdir(cfg.checkpoint_path))}
    if rank == 0:
        scene = tuple(_t(c[k]) for k in ("images", "poses", "K"))
        model = NeRF(cfg.model, device="cpu", seed=cfg.train.seed)    # the trainer's init
        opt, sched = make_optimizer(cfg, model)
        loss_fn = make_loss_fn(cfg, n_rays=cfg.train.n_rays_batch // 2)
        gens = [torch.Generator().manual_seed(draw_seed(cfg.train.seed, i)) for i in range(2)]
        for _ in range(n):
            opt.zero_grad(set_to_none=True)
            torch.stack([loss_fn(model, g, *scene) for g in gens]).mean().backward()
            opt.step()
            sched.step()
        out["replay"] = params_to_jax(model)
    return out


def main():
    case_file, rank, world, port, out_dir = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    c = torch.load(case_file, weights_only=False)
    pmesh.init_local("gloo", rank, world, int(port))
    try:
        result = {"nerf": nerf, "trainer": trainer}[c["task"]](c, rank, world)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main()
