"""NeRF training and full-frame renderers, the counterpart of
sfm_nerf_tpu/train/nerf_trainer.py.

Training: one step is ray sampling on the device, stratified depths, the
loss with its grads, and ``torch.optim.Adam`` under a staircase ``StepLR``
(optax's ``exponential_decay(staircase=True)``).  The loss, decided from
the config alone (``fused_train_supported``):

- ``use_fused_kernel`` and ``fused_merged_step`` -> ``fused_mse_loss``: one
  call of the split step gives the loss's rgb and every grad;
- ``use_fused_kernel`` without ``fused_merged_step`` -> ``fused_render_train``
  under an MSE written in torch: the render kernel's forward (rgb and tb),
  then the split step under autograd's cotangent;
- ``--no_fused`` (and every config outside the kernels' envelope) -> the
  ``nn.Module`` under autograd: float32, or with ``compute_dtype=
  'bfloat16'`` the JAX trainer's cast (``models/nerf.py:bf16_compute``:
  bf16 weight matrices from the float32 masters, float32 biases, the
  products summed in float32; on a card ``Bf16Linear``'s tensor-core
  products).

With ``n_importance > 0`` the model is a coarse/fine ``NeRFPair`` under one
Adam and the loss is the coarse MSE plus the fine MSE.  On the merged route
a step is two launches: ``fused_mse_loss_weights`` on the coarse depths
(loss, grads and the weight histogram), ``sample_pdf`` and ``merge_sorted``
in torch, ``fused_mse_loss`` on the sorted union.  Off it (two-kernel step,
legacy compositor, ``--no_fused``) the pair trains through
``render_rays_hierarchical`` under autograd, float32 or bf16 as above.

On CPU tensors the fused wrappers run their plain versions.  The host loop
reads the loss only every ``log_every`` steps; checkpoints (.npz, the JAX
package's key layout; ``ckpt_backend='orbax'`` writes the same files from a
background thread, train/async_ckpt.py) and validation renders follow their
own cadences, and a KeyboardInterrupt saves a checkpoint stamped with the
last finished step.  While ``fit`` runs, SIGINT is held from a step's first
parameter write until the loop has recorded the step as done
(``UpdateGuard``), so the stamp always names the update the parameters
hold, as the JAX trainer's one-statement rebind of params and opt_state
does.  With the parameters sharded (tp > 1) an interrupted rank cannot join
a gather: each rank writes its own shards with the stamp, and ``try_resume``
puts them back together when every rank's stamp agrees, writes them as a
whole checkpoint and continues from it; stamps that disagree fall back to
the newest whole checkpoint.

Several ranks (a process group is initialised: torchrun, or an in-process
start): the step is parallel/train_step.py's, routed from
``ParallelConfig`` as the JAX trainer routes it: ``tp > 1`` the dp x tp
step, else the data-parallel step over every rank (at one rank it equals
the single-device step bit for bit).  Every rank starts from the same
seeded init (rank 0's is broadcast), resumes from the same checkpoint and
draws from its own generator (``draw_seed``); rank 0 alone logs, validates
and writes checkpoints while the others wait at a barrier.  Checkpoints
hold whole tensors, so either package and one device resume them.

With no npz checkpoint and no shard set under ``checkpoint_path``,
``try_resume`` fine-tunes from a reference ``.pth`` there
(``final_model.pth``, else the numerically newest ``model_*.pth``): its
weights, converted by models/convert.py, at step 0 under a fresh Adam and
StepLR.

Not ported: ``steps_per_call`` (a ``lax.scan`` that amortises XLA dispatch:
the torch loop enqueues each step's launches without waiting for the
device, so there is no per-step round trip to amortise).

Renderers.  Route, decided from the config alone:

- ``use_fused_kernel`` on -> the fused render (kernels/fused_render.py),
  which launches the CUDA kernel for CUDA tensors and runs its plain
  version for CPU tensors; weights are packed in bf16 as the JAX package
  serves them, once per renderer and model (a renderer serves fixed
  weights: make a new one after changing them);
- ``--no_fused``, the legacy compositor with a white background (whose
  weights do not telescope, so the kernel refuses it), and a network outside
  the kernels' envelope (``fused_network_supported``) -> the float32
  ``nn.Module`` path in ray chunks.

A hierarchical frame on the fused route is two launches: the coarse pass
through ``fused_render_rays_weights``, ``sample_pdf`` and ``merge_sorted``
in torch, then the fine pass over the union through
``fused_render_rays_weights`` when the maps are wanted and through
``fused_render_rays`` (the same rgb, no weights written) when not.

Nothing catches a kernel error and carries on down the other path.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from sfm_nerf_tpu_torch.config import NeRFPipelineConfig
from sfm_nerf_tpu_torch.kernels.fused_render import (
    MAX_FREQ, fused_render_rays, fused_render_rays_weights, pack_nerf_params,
)
from sfm_nerf_tpu_torch.kernels.fused_train import (
    fused_mse_loss, fused_mse_loss_weights, fused_render_train,
)
from sfm_nerf_tpu_torch.models.convert import (
    convert_pth, latest_pth, load_params_from_jax, optimizer_state_from_jax,
    optimizer_state_to_jax, params_from_jax, params_to_jax, shard_layout,
)
from sfm_nerf_tpu_torch.models.nerf import NeRF, NeRFPair, bf16_compute, layer_shapes
from sfm_nerf_tpu_torch.ops.rays import image_rays, sample_ray_batch
from sfm_nerf_tpu_torch.ops.render import (
    merge_sorted, render_rays, render_rays_chunked, render_rays_chunked_aux,
    render_rays_hierarchical, render_rays_hierarchical_chunked,
    render_rays_hierarchical_chunked_aux, sample_pdf, stratified_samples, weight_maps,
)
from sfm_nerf_tpu_torch.train import checkpoint as ckpt_lib
from sfm_nerf_tpu_torch.utils.metrics import mse as host_mse


class UpdateGuard:
    """Holds SIGINT across a step's parameter update.  ``install`` (the
    trainer's ``fit``) takes over SIGINT from Python's own handler; a step
    calls ``hold`` just before its first parameter write, and the loop calls
    ``release`` once it has recorded the step as done, which raises the
    KeyboardInterrupt that arrived in between.  Outside a hold, or where the
    guard is not installed, SIGINT acts as it did."""

    def __init__(self):
        self._holding = self._pending = False
        self._prev = None

    def install(self) -> None:
        self._holding = self._pending = False
        # only the main thread may set handlers; a SIGINT ignored or taken
        # over by the caller stays theirs
        if (threading.current_thread() is threading.main_thread()
                and signal.getsignal(signal.SIGINT) is signal.default_int_handler):
            self._prev = signal.signal(signal.SIGINT, self._on_sigint)

    def uninstall(self) -> None:
        if self._prev is not None:
            signal.signal(signal.SIGINT, self._prev)
            self._prev = None
        self._holding = False

    def _on_sigint(self, signum, frame) -> None:
        if self._holding:
            self._pending = True
        else:
            signal.default_int_handler(signum, frame)

    def hold(self) -> None:
        self._holding = True

    def release(self) -> None:
        self._holding = False
        if self._pending:
            self._pending = False
            raise KeyboardInterrupt


def fused_network_supported(mcfg) -> bool:
    """The network clauses of the fused kernels' envelope, shared by the
    render route (``use_fused_route``) and the training route
    (``fused_train_supported``): hidden a multiple of 16 up to 256, and
    with PE on at most MAX_FREQ frequencies per encoding."""
    return (mcfg.hidden % 16 == 0 and mcfg.hidden <= 256
            and (not mcfg.pos_encoding
                 or (mcfg.n_pos_freq <= MAX_FREQ and mcfg.n_dir_freq <= MAX_FREQ)))


def use_fused_route(cfg: NeRFPipelineConfig) -> bool:
    """Whether full frames render through the fused kernels, flat or
    hierarchical alike.  A config outside the kernels' network envelope
    (``fused_network_supported``) renders through the nn.Module path, as the
    JAX package's ``_fused_render_env_ok`` sends it to XLA; inside it a
    kernel error still raises."""
    rcfg = cfg.render
    return (rcfg.use_fused_kernel and fused_network_supported(cfg.model)
            and not (rcfg.white_background and rcfg.variant != "train"))


def _packer(cfg: NeRFPipelineConfig):
    """model -> its bf16 packing, packed at the first call for that model
    and reused after."""
    held = {}

    def packed(model: NeRF):
        if held.get("model") is not model:
            held.update(model=model, packed=pack_nerf_params(model, cfg.model, torch.bfloat16))
        return held["packed"]

    return packed


def _fused_hierarchical_render(packed_c, packed_f, o, d, rcfg, generator, want_weights):
    """Coarse fused pass (its weights) -> sample_pdf + merge_sorted -> fine
    fused pass over the union, with _hierarchical_body's sampling (interior
    bin weights, stratified importance draws, sorted union).  Returns
    (rgb_fine (N, 3), weights_fine (N, S+I) or None, z_all (N, S+I))."""
    z_c = stratified_samples(o.shape[0], rcfg, generator, o.device)
    _, w_c = fused_render_rays_weights(packed_c, o, d, z_c, rcfg)
    mids = 0.5 * (z_c[..., 1:] + z_c[..., :-1])
    z_fine = sample_pdf(mids, w_c[..., 1:-1], rcfg.n_importance, generator)
    del w_c, mids
    z_all = merge_sorted(z_c, z_fine)
    if want_weights:
        rgb_f, w_f = fused_render_rays_weights(packed_f, o, d, z_all, rcfg)
    else:
        rgb_f, w_f = fused_render_rays(packed_f, o, d, z_all, rcfg), None
    return rgb_f, w_f, z_all


def _check_model(cfg: NeRFPipelineConfig, model) -> bool:
    """True for a hierarchical config; the model must be of its kind."""
    hier = cfg.render.n_importance > 0
    if hier != isinstance(model, NeRFPair):
        raise ValueError(
            f"n_importance = {cfg.render.n_importance} renders "
            f"{'a coarse/fine NeRFPair' if hier else 'one NeRF'}, got {type(model).__name__}")
    return hier


def make_render_rays(cfg: NeRFPipelineConfig):
    """Ray renderer ``(model, o, d, generator=None) -> rgb (N, 3)`` through
    the route of ``make_render_image``; parallel/render.py runs it on each
    rank's slice of a frame."""
    rcfg = cfg.render
    fused = use_fused_route(cfg)
    packed, packed_c = _packer(cfg), _packer(cfg)

    @torch.no_grad()
    def render_rays_of(model, o: torch.Tensor, d: torch.Tensor,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        hier = _check_model(cfg, model)
        if fused and hier:
            return _fused_hierarchical_render(
                packed_c(model.coarse), packed(model.fine), o, d, rcfg, generator, False)[0]
        if fused:
            z = stratified_samples(o.shape[0], rcfg, generator, o.device)
            return fused_render_rays(packed(model), o, d, z, rcfg)
        if hier:
            return render_rays_hierarchical_chunked(
                model.coarse, model.fine, o, d, rcfg, rcfg.n_importance, generator)
        return render_rays_chunked(model, o, d, rcfg, generator)

    return render_rays_of


def make_render_image(cfg: NeRFPipelineConfig):
    """Renderer ``(model, K, pose, H, W, generator=None) -> (H, W, 3)`` on
    ``pose``'s device.  Without a generator the samples are the
    deterministic bin midpoints.  With ``render.n_importance > 0`` the
    model is a NeRFPair and the fine image is returned."""
    render_rays_of = make_render_rays(cfg)

    def render_image(model, K, pose: torch.Tensor, height: int, width: int,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
        o, d = image_rays(K, pose, height, width)
        return render_rays_of(model, o, d, generator).reshape(height, width, 3)

    return render_image


def make_render_image_aux(cfg: NeRFPipelineConfig):
    """Renderer ``(model, K, pose, H, W, generator=None)`` -> (rgb (H,W,3),
    depth (H,W), disp (H,W), acc (H,W)); the fused route feeds the
    kernel's weights output to weight_maps (hierarchical: the fine pass's
    weights over the sorted union)."""
    rcfg = cfg.render
    fused = use_fused_route(cfg)
    packed, packed_c = _packer(cfg), _packer(cfg)

    @torch.no_grad()
    def render_image_aux(model, K, pose: torch.Tensor, height: int, width: int,
                         generator: Optional[torch.Generator] = None):
        hier = _check_model(cfg, model)
        o, d = image_rays(K, pose, height, width)
        if fused:
            if hier:
                rgb, w, z = _fused_hierarchical_render(
                    packed_c(model.coarse), packed(model.fine), o, d, rcfg, generator, True)
            else:
                z = stratified_samples(height * width, rcfg, generator, o.device)
                rgb, w = fused_render_rays_weights(packed(model), o, d, z, rcfg)
            acc = torch.sum(w, dim=-1)
            depth, disp = weight_maps(w, z, acc)
        elif hier:
            rgb, depth, disp, acc = render_rays_hierarchical_chunked_aux(
                model.coarse, model.fine, o, d, rcfg, rcfg.n_importance, generator)
        else:
            rgb, depth, disp, acc = render_rays_chunked_aux(
                model, o, d, rcfg, generator)
        hw = (height, width)
        return (rgb.reshape(height, width, 3), depth.reshape(hw),
                disp.reshape(hw), acc.reshape(hw))

    return render_image_aux


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def make_schedule(cfg: NeRFPipelineConfig) -> Callable[[int], float]:
    """step -> learning rate: ``lrate * decay ** (step // decay_steps)``,
    optax's staircase exponential decay and torch's StepLR."""
    t = cfg.train
    return lambda step: t.lrate * t.lrate_decay ** (step // t.lrate_decay_steps)


def make_optimizer(cfg: NeRFPipelineConfig, model):
    """(Adam, StepLR) over ``model``'s parameters (both networks of a
    NeRFPair); call ``scheduler.step()``
    after every ``optimizer.step()``.  Adam's betas (0.9, 0.999) and eps
    1e-8 are optax.adam's."""
    t = cfg.train
    opt = torch.optim.Adam(model.parameters(), lr=t.lrate, betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.StepLR(
        opt, step_size=t.lrate_decay_steps, gamma=t.lrate_decay)
    return opt, sched


def fused_train_supported(cfg: NeRFPipelineConfig) -> bool:
    """Whether the fused training kernels cover this config; outside it
    make_loss_fn takes the nn.Module autograd path.  Envelope: active or
    legacy arch (the no-PE ablation included), the 'train' compositor
    (white background too), hidden a multiple of 16 up to 256, at most 16
    encoding frequencies; hierarchical sampling on the merged step only
    (the coarse step kernel is the one that emits the weight histogram).

    Clauses of the JAX gate that the CUDA kernel does not need, dropped:
    the chunk count cap and the pad-ratio bound (the kernel loops over any
    number of 128-sample chunks and masks a ragged last one), the 128-lane
    chunk alignment, fast_sin's frequency range (the kernel calls the
    accurate sinf), and the accelerator-backend clause (CPU tensors run the
    kernel's plain version)."""
    mcfg, rcfg = cfg.model, cfg.render
    return (
        rcfg.use_fused_kernel
        and mcfg.arch in ("active", "legacy")
        and (rcfg.n_importance == 0 or rcfg.fused_merged_step)
        and rcfg.variant == "train"
        and fused_network_supported(mcfg)
    )


def _mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def make_loss_fn(cfg: NeRFPipelineConfig, n_rays: Optional[int] = None):
    """The per-batch loss ``loss_fn(model, generator, images, poses, K,
    draws=None, u=None, u_pdf=None)``: ray sampling on the device -> render
    -> MSE, a scalar whose ``backward()`` fills the parameters' grads.
    ``draws`` (img_idx, px, py), ``u`` (n_rays, n_sample) and ``u_pdf``
    (n_rays, n_importance) replace the generator's pixel, depth and
    importance draws, made in that order (tests feed both packages the same
    numbers).

    With ``render.n_importance > 0`` the model is a NeRFPair and the loss is
    the sum of the coarse and the fine pass's MSEs over the hierarchical
    sampler; the coarse weights reach ``sample_pdf`` detached on every
    route."""
    mcfg, rcfg = cfg.model, cfg.render
    n_rays = n_rays if n_rays is not None else cfg.train.n_rays_batch
    n_imp = rcfg.n_importance
    fused = fused_train_supported(cfg)
    # the nn.Module route: float32, or the JAX trainer's bf16 compute cast
    net = bf16_compute if cfg.train.compute_dtype == "bfloat16" else (lambda m: m)

    def loss_fn(model, generator, images, poses, K, draws=None, u=None, u_pdf=None):
        _check_model(cfg, model)
        o, d, target = sample_ray_batch(images, poses, K, n_rays, generator, draws)
        if not fused and n_imp > 0:
            rgb_f, rgb_c = render_rays_hierarchical(
                net(model.coarse), net(model.fine), o, d, rcfg, n_imp, generator, u, u_pdf)
            return _mse(rgb_f, target) + _mse(rgb_c, target)
        z = stratified_samples(n_rays, rcfg, generator, o.device, u)
        if not fused:
            return _mse(render_rays(net(model), o, d, rcfg, z_vals=z), target)
        # the CUDA kernels take bf16-packed weights; the plain version on the
        # CPU packs in float32 unless compute_dtype asks for bf16
        bf16 = o.device.type == "cuda" or cfg.train.compute_dtype == "bfloat16"
        pdt = torch.bfloat16 if bf16 else torch.float32
        if n_imp > 0:
            # the coarse step kernel emits the weight histogram; importance
            # sampling and the sort run in torch between the two launches
            loss_c, weights = fused_mse_loss_weights(
                pack_nerf_params(model.coarse, mcfg, pdt), o, d, z, target, rcfg)
            mids = 0.5 * (z[..., 1:] + z[..., :-1])
            z_fine = sample_pdf(mids, weights[..., 1:-1], n_imp, generator, u_pdf)
            z_all = merge_sorted(z, z_fine)
            loss_f = fused_mse_loss(
                pack_nerf_params(model.fine, mcfg, pdt), o, d, z_all, target, rcfg)
            return loss_f + loss_c
        packed = pack_nerf_params(model, mcfg, pdt)
        if rcfg.fused_merged_step:
            return fused_mse_loss(packed, o, d, z, target, rcfg)
        return _mse(fused_render_train(packed, o, d, z, rcfg), target)

    return loss_fn


def make_train_step(cfg: NeRFPipelineConfig, optimizer, scheduler,
                    guard: Optional[UpdateGuard] = None) -> Callable:
    """``step(model, generator, images, poses, K) -> loss`` (a detached
    scalar tensor on the device; nothing here waits for the device).
    ``guard`` (the trainer's) is held from the update on."""
    loss_fn = make_loss_fn(cfg)
    guard = guard or UpdateGuard()

    def train_step(model, generator, images, poses, K) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(model, generator, images, poses, K)
        loss.backward()
        guard.hold()
        optimizer.step()
        scheduler.step()
        return loss.detach()

    return train_step


class NeRFTrainer:
    """Host-side orchestration: resume, loop, logging, checkpoints."""

    def __init__(
        self,
        cfg: NeRFPipelineConfig,
        images: np.ndarray,
        poses: np.ndarray,
        camera_matrix: np.ndarray,
        device="cuda",
        train_step: Optional[Callable] = None,
        writer: Any = None,
    ):
        if cfg.train.ckpt_backend not in ("npz", "orbax"):
            raise ValueError(f"ckpt_backend {cfg.train.ckpt_backend!r}: npz or orbax")
        self.cfg = cfg
        self.device = torch.device(device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self.images = torch.as_tensor(np.asarray(images), **f32)
        self.poses = torch.as_tensor(np.asarray(poses), **f32)
        self.K = torch.as_tensor(np.asarray(camera_matrix), **f32)
        # hierarchical sampling trains a coarse/fine pair under one Adam
        net = NeRFPair if cfg.render.n_importance > 0 else NeRF
        self.model = net(cfg.model, device=self.device, seed=cfg.train.seed)
        self.world = dist.get_world_size() if dist.is_initialized() else 1
        self.rank0 = not dist.is_initialized() or dist.get_rank() == 0
        self.mesh, self.sharded = self._parallel_layout(cfg) if train_step is None \
            else (None, False)
        self.optimizer, self.scheduler = make_optimizer(cfg, self.model)
        self._schedule = make_schedule(cfg)
        self._guard = UpdateGuard()
        self.train_step = train_step or self._make_step(cfg)
        self._async = None
        if cfg.train.ckpt_backend == "orbax" and self.rank0:
            from sfm_nerf_tpu_torch.train.async_ckpt import AsyncCheckpointer

            self._async = AsyncCheckpointer(cfg.checkpoint_path)
        self.start_iter = 0
        self.writer = writer
        self.loss_log: List[Tuple[int, float]] = []   # (iteration, loss) at log_every
        self.val_log: List[Tuple[int, int, float]] = []   # (iteration, view, mse)

    def _parallel_layout(self, cfg: NeRFPipelineConfig):
        """(mesh, parameters stored sharded): None and False on one device;
        with a process group, the mesh of ``ParallelConfig`` over every
        rank, rank 0's init broadcast, and under tp > 1 the parameters laid
        out as DTensors."""
        par = cfg.parallel
        if not dist.is_initialized():
            if par.dp > 1 or par.tp > 1:
                raise ValueError(
                    f"dp={par.dp}, tp={par.tp} need a process group of that many ranks: "
                    f"launch with torchrun --nproc_per_node {max(par.dp, 1) * par.tp}")
            return None, False
        from sfm_nerf_tpu_torch.parallel import mesh as pmesh
        from sfm_nerf_tpu_torch.parallel import train_step as pstep

        mesh = pmesh.make_mesh(par.dp, par.tp, self.device.type,
                               par.data_axis, par.model_axis)
        if mesh.size() != self.world:
            raise ValueError(f"dp*tp={mesh.size()} ranks of {self.world}: every rank must "
                             "be in the mesh")
        pstep.broadcast_(list(self.model.parameters()))
        if par.tp > 1:
            pstep.distribute_params(self.model, mesh, pstep.mlp_param_placements(
                self.model, mesh, par.model_axis))
        return mesh, par.tp > 1

    def _make_step(self, cfg: NeRFPipelineConfig) -> Callable:
        if self.mesh is None:
            return make_train_step(cfg, self.optimizer, self.scheduler, self._guard)
        from sfm_nerf_tpu_torch.parallel import train_step as pstep

        if self.sharded:
            step = pstep.make_spmd_train_step(cfg, self.optimizer, self.scheduler,
                                              self.mesh, self.model, self._guard)
        else:
            step = pstep.make_dp_train_step(cfg, self.optimizer, self.scheduler, self.mesh,
                                            self._guard)
        if self.rank0:
            print(f"{'dp x tp' if self.sharded else 'data-parallel'} over "
                  f"{dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))} ranks")
        return step

    def _barrier(self) -> None:
        if self.world > 1:
            dist.barrier()

    # -- checkpointing -----------------------------------------------------
    def try_resume(self) -> bool:
        """Load the newest checkpoint: an interrupted sharded run's shards
        when they are newer than every whole checkpoint and agree (then
        written whole first), else the newest whole file; with neither, a
        reference .pth to fine-tune (``_try_resume_pth``)."""
        ck = self.cfg.checkpoint_path
        path = ckpt_lib.latest_checkpoint(ck)
        state = ckpt_lib.load_checkpoint(path) if path is not None else None
        shards = ckpt_lib.load_shards(ck) if os.path.isdir(ck) else None
        if shards is not None and max(shards[1].values()) > (state[2] if state else -1):
            whole, stamps = shards
            if whole is None:
                print(f"shard stamps disagree {stamps}: resuming from "
                      f"{path or 'scratch'} instead")
            else:
                state, path = whole, os.path.join(ck, ckpt_lib.checkpoint_name(whole[2]))
                if self.rank0:
                    ckpt_lib.save_checkpoint(ck, whole[2], whole[0], whole[1])
                self._barrier()
        if state is None:
            return shards is None and self._try_resume_pth()
        params, opt_state, step = state
        try:
            load_params_from_jax(self.model, params)
        except ValueError as e:
            # a flat checkpoint under a hierarchical run, or the reverse
            raise ValueError(f"cannot resume from {path}: {e}") from e
        if opt_state is not None:
            optimizer_state_from_jax(self.model, self.optimizer, opt_state)
        # the schedule follows the number of updates done
        done = opt_state["count"] if opt_state is not None else step + 1
        self.scheduler.last_epoch = done
        for group in self.optimizer.param_groups:
            group["lr"] = self._schedule(done)
        self.start_iter = step + 1
        return True

    def _try_resume_pth(self) -> bool:
        """Fine-tune from a reference .pth in ``checkpoint_path`` (none: False):
        its converted weights at step 0 under a fresh Adam and StepLR (a
        state dict carries no iteration).  A file whose layers do not match
        the configured network raises; a coarse/fine pair cannot take a
        one-network file, and trains from scratch with a note."""
        pth = latest_pth(self.cfg.checkpoint_path)
        if pth is None:
            return False
        params, mcfg = convert_pth(pth)
        if isinstance(self.model, NeRFPair):
            print(f"note: ignoring {pth} — it holds one network but --n_importance > 0 "
                  "trains a coarse/fine pair; starting from scratch")
            return False
        expected = layer_shapes(self.cfg.model)
        if set(params) != set(expected) or any(
                params[n]["w"].shape != (fi, fo) or params[n]["b"].shape != (fo,)
                for n, (fi, fo) in expected.items()):
            raise ValueError(
                f"{pth} serializes a different architecture than the configured model "
                f"({mcfg}); pass the matching --arch/--n_pos_freq/--hidden_size flags to "
                "fine-tune it")
        load_params_from_jax(self.model, params)
        self.optimizer.state.clear()
        self.scheduler.last_epoch = 0
        for group in self.optimizer.param_groups:
            group["lr"] = self._schedule(0)
        self.start_iter = 0
        if self.rank0:
            print(f"Fine-tuning from converted {pth}")
        return True

    def save(self, step: int, loss, final: bool = False) -> Optional[str]:
        """Write a checkpoint of whole tensors from rank 0 (the path; None
        on the other ranks).  ``loss``: a number or a scalar tensor.  With
        several ranks every rank must call: the sharded parameters are
        gathered, and all wait for the file."""
        path = self._write(step, loss, final)
        self._barrier()
        return path

    def _write(self, step: int, loss, final: bool = False) -> Optional[str]:
        """Rank 0's checkpoint write; sharded parameters are gathered first
        (a collective).  The orbax backend hands a snapshot to the
        background writer and returns; its final save is stamped ``step``,
        not ``final_model``, as the JAX backend's, and is waited for."""
        how = "device" if self.cfg.train.ckpt_backend == "orbax" else "host"
        params = params_to_jax(self.model, how=how)
        opt_state = optimizer_state_to_jax(self.model, self.optimizer, how=how)
        if not self.rank0:
            return None
        if self._async is None:
            return ckpt_lib.save_checkpoint(self.cfg.checkpoint_path, step, params, opt_state,
                                            extra={"loss": float(loss)}, final=final)
        path = self._async.save(step, params, opt_state, extra={"loss": loss})
        if final:
            self._async.wait()
        return path

    def _save_interrupted(self) -> None:
        """The interrupt's checkpoint, with no collective: the other ranks
        may be anywhere.  Sharded parameters: every rank writes its own
        shards.  Else rank 0 writes whole tensors and waits for the file."""
        step, loss = self._done_through, float(self._loss)
        if self.sharded:
            print(f"KeyboardInterrupt: saving rank {dist.get_rank()}'s shards before exit")
            ckpt_lib.save_shard(
                self.cfg.checkpoint_path, dist.get_rank(), self.world, step,
                params_to_jax(self.model, how="local"),
                optimizer_state_to_jax(self.model, self.optimizer, how="local"),
                shard_layout(self.model), extra={"loss": loss})
        elif self.rank0:
            print("KeyboardInterrupt: saving checkpoint before exit")
            self._write(step, loss, final=False)
            if self._async is not None:
                self._async.wait()

    # -- main loop ---------------------------------------------------------
    def fit(self, max_iters: Optional[int] = None,
            val_indices: Optional[np.ndarray] = None, progress: bool = True) -> dict:
        cfg = self.cfg
        max_iters = max_iters if max_iters is not None else cfg.train.max_iters
        if cfg.load_checkpoint:
            self.try_resume()
        if val_indices is None:
            rng = np.random.default_rng(cfg.train.seed)
            n_val = min(cfg.train.n_val_images, len(self.images))
            val_indices = rng.choice(len(self.images), n_val, replace=False)
        from sfm_nerf_tpu_torch.parallel.train_step import draw_seed

        # each rank its own stream; one device (index 0) draws from seed + 1
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(draw_seed(
            cfg.train.seed, getattr(self.train_step, "draw_index", 0)))
        self._loss = torch.zeros((), device=self.device)
        self._steps_done = 0
        self._marks: list = []     # (iteration, CUDA event or host time) at log_every
        # the last iteration whose update the parameters hold: what an
        # interrupt checkpoint must stamp (resume = step + 1)
        self._done_through = self.start_iter - 1
        t_start = time.time()
        iterator = range(self.start_iter, max_iters)
        if progress:
            try:
                from tqdm import tqdm
                iterator = tqdm(iterator)
            except ImportError:
                pass
        self._guard.install()
        try:
            self._fit_loop(iterator, cfg, val_indices, progress)
        except KeyboardInterrupt:
            # interrupt -> checkpoint -> exit.  The guard held it until the
            # step in flight was recorded, so the stamp names the update the
            # parameters hold
            if self._done_through < 0:
                print("KeyboardInterrupt before any completed step; nothing to checkpoint")
            else:
                self._save_interrupted()
            raise
        finally:
            self._guard.uninstall()
        final_loss = float(self._loss)      # waits for the device
        if self._steps_done > 0:
            self.save(max_iters - 1, final_loss, final=True)
        if self._async is not None:
            self._async.wait()
        elapsed = time.time() - t_start
        rays = self._steps_done * cfg.train.n_rays_batch
        return {"final_loss": final_loss, "steps": self._steps_done,
                "elapsed_s": elapsed, "rays_per_sec": rays / max(elapsed, 1e-9),
                "ms_per_step": self._ms_per_step()}

    def _ms_per_step(self) -> Optional[float]:
        """Milliseconds per step between the second and the last log point
        (the first interval holds the warm-up), checkpoint saves and
        validation renders in between included: CUDA events on a card, the
        host clock on the CPU.  None with fewer than three log points."""
        if len(self._marks) < 3:
            return None
        (it0, m0), (it1, m1) = self._marks[1], self._marks[-1]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            return float(m0.elapsed_time(m1)) / (it1 - it0)
        return (m1 - m0) * 1e3 / (it1 - it0)

    def _fit_loop(self, iterator, cfg, val_indices, progress) -> None:
        t = cfg.train
        for it in iterator:
            loss = self.train_step(self.model, self._generator, self.images, self.poses, self.K)
            self._loss = loss
            self._steps_done += 1
            self._done_through = it
            self._guard.release()      # raises a SIGINT held since the update
            # the loss reaches the host only here: a read per step would
            # stall the stream
            if t.log_every and it % t.log_every == 0 and self.rank0:
                loss_f = float(loss)
                self.loss_log.append((it, loss_f))
                if self.device.type == "cuda":
                    mark = torch.cuda.Event(enable_timing=True)
                    mark.record()
                else:
                    mark = time.perf_counter()
                self._marks.append((it, mark))
                if progress and hasattr(iterator, "set_description"):
                    iterator.set_description(f"Loss: {loss_f:.6f}")
                if self.writer is not None:
                    self.writer.add_scalar("Loss/train", loss_f, it)
                    self.writer.add_scalar("Learning Rate", self._schedule(it), it)
                    self.writer.add_scalar(
                        "Loss/train_avg",
                        float(np.mean([v for _, v in self.loss_log[-10:]])), it)
            if t.save_ckpt_iter and it % t.save_ckpt_iter == 0 and it > 0:
                self.save(it, loss)
            if t.val_every and it % t.val_every == 0 and it > 0:
                self._validate(it, val_indices)

    def _validate(self, it: int, val_indices) -> None:
        """Rank 0 renders the validation views; the other ranks wait (and
        first help gather sharded parameters)."""
        model = self.model
        if self.sharded:
            model = params_from_jax(params_to_jax(self.model), self.cfg.model, self.device)
        if self.rank0:
            self._validate_views(model, it, val_indices)
        self._barrier()

    def _validate_views(self, model, it: int, val_indices) -> None:
        height, width = int(self.images.shape[1]), int(self.images.shape[2])
        # a renderer packs the weights it first sees: a new one per validation
        render_image = make_render_image(self.cfg)
        model.eval()
        for i, idx in enumerate(val_indices):
            pred = render_image(model, self.K, self.poses[int(idx)], height, width)
            gt = self.images[int(idx)]
            val_mse = host_mse(pred, gt)
            self.val_log.append((it, int(idx), val_mse))
            if self.writer is not None:
                self.writer.add_scalar(f"Loss/val_{i}", val_mse, it)
                side = torch.cat([gt, pred], dim=1).permute(2, 0, 1).clamp(0, 1)
                self.writer.add_image(f"Val_Image_{i}", side.cpu().numpy(), it)
        model.train()
