"""Typed configuration for the NeRF side of the port.

A copy of the JAX package's dataclasses (sfm_nerf_tpu/config.py) with the
same field names and defaults, minus the TPU tile knobs (fused_ray_tile,
fused_sample_chunk, fused_tiles_per_program, fused_vmem_mb,
fused_interpret): the CUDA kernel picks its own blocking.
``ParallelConfig`` keeps the JAX fields.  ``SfMConfig`` is the JAX
package's Phase 1 configuration minus ``bucket_floor``, which only served
XLA compile reuse.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class NeRFModelConfig:
    """Architecture of the NeRF MLP.

    ``arch='active'``: fc1 + 4 hidden layers, skip-concat of the position
    encoding, 3 more layers, softplus density head, feature layer, 2-layer
    rgb head.  ``arch='legacy'``: fc1, ``n_block1_layers`` hidden layers, an
    optional skip layer, block2 ending in a (hidden+1)-wide ReLU layer whose
    channel 0 is the density, and the same rgb head.  ``arch='mip'``
    (mip-NeRF, Barron et al. 2021): fc1 over the integrated positional
    encoding of a conical frustum's Gaussian (``n_pos_freq`` octaves, no
    identity), 4 hidden layers, the skip layer, 2 more, softplus density
    head, a linear bottleneck (``feature``) and the rgb head over
    [bottleneck ++ PE(viewdir)], its sigmoid widened to ``1.002 s - 0.001``.
    It renders through cone casting (see ``RenderConfig``).
    """

    n_pos_freq: int = 10
    n_dir_freq: int = 4
    hidden: int = 256
    pos_encoding: bool = True
    arch: str = "active"
    n_block1_layers: int = 3
    has_skip: bool = True
    # initial bias of the density head (0.0 keeps the plain Linear init)
    density_bias_init: float = 0.0

    @property
    def pos_dim(self) -> int:
        if self.arch == "mip":
            return 6 * self.n_pos_freq
        return 3 * (2 * self.n_pos_freq + 1) if self.pos_encoding else 3

    @property
    def dir_dim(self) -> int:
        return 3 * (2 * self.n_dir_freq + 1) if self.pos_encoding else 3


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Sampling and volume rendering.

    ``variant='train'``: midpoint-jittered linspace bins, 1e-3 tail
    distance, exclusive transmittance.  ``variant='legacy'`` (the gif
    renderer): per-bin jitter, 1.0 tail distance, inclusive transmittance.

    A model of arch 'mip' (mip-NeRF) casts cones: each pixel casts a cone,
    ``n_sample`` intervals between ``n_sample + 1`` edges a level, two
    levels through one network: the coarse edges jittered as mip-NeRF
    jitters them, the fine edges drawn from the coarse weights after a
    2-tap max blur and a 0.01 floor; compositing over the interval
    lengths, exclusive transmittance.
    """

    n_sample: int = 256
    n_importance: int = 0
    near: float = 2.0
    far: float = 6.0
    perturb: bool = True
    lindisp: bool = False
    chunk_size: int = 32768
    variant: str = "train"
    white_background: bool = False
    # full-frame renders through the fused render kernel
    use_fused_kernel: bool = False
    fused_merged_step: bool = True


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """``lr_schedule='step'``: ``lrate * lrate_decay ** (step //
    lrate_decay_steps)``.  ``'loglinear'`` (mip-NeRF): log-linear from
    ``lrate`` to ``lrate_final`` over ``lr_anneal_steps``, then flat."""

    lrate: float = 5e-4
    lrate_decay: float = 0.1
    lrate_decay_steps: int = 50000
    lr_schedule: str = "step"
    lrate_final: float = 5e-6
    lr_anneal_steps: int = 1000000
    n_rays_batch: int = 8192
    max_iters: int = 200001
    save_ckpt_iter: int = 1000
    log_every: int = 100
    val_every: int = 1000
    n_val_images: int = 5
    seed: int = 0
    steps_per_call: int = 1
    ckpt_backend: str = "npz"
    compute_dtype: str = "float32"
    debug_nans: bool = False


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh layout of training over ``torch.distributed`` ranks
    (parallel/).  ``dp`` ranks carry rays (0: every rank the model axis
    leaves); ``tp`` ranks split each MLP layer's hidden channels."""

    data_axis: str = "data"       # rays sharded here; grads averaged over it
    model_axis: str = "model"     # MLP hidden channels sharded here (tp)
    dp: int = 0
    tp: int = 1


@dataclasses.dataclass(frozen=True)
class NeRFPipelineConfig:
    model: NeRFModelConfig = NeRFModelConfig()
    render: RenderConfig = RenderConfig()
    train: TrainConfig = TrainConfig()
    parallel: ParallelConfig = ParallelConfig()
    data_path: str = "./Phase2/nerf_synthetic/lego/"
    mode: str = "train"
    logs_path: str = "./logs/"
    log_id: str = ""
    exp_name: str = "lego_experiment"
    checkpoint_path: str = "./Phase2/checkpoints_new_2/"
    load_checkpoint: bool = True
    images_path: str = "./image/"


@dataclasses.dataclass(frozen=True)
class SfMConfig:
    """Phase 1 pipeline knobs: the JAX package's field names and defaults.

    The port computes in float64 on every device, so ``pnp_f64_rescue='auto'``
    resolves to off and ``'on'`` re-runs a failed camera's PnP RANSAC on
    numpy draws of its own seed (ops/pnp.py:pnp_ransac_f64_host).
    ``ransac_confidence > 0`` stops F- and PnP RANSAC on their confidence
    bound; every ``ransac_adaptive_device`` value runs the one host-driven loop.
    ``global_rotation_init`` / ``global_init`` re-initialize the registered
    cameras by rotation (and translation) averaging before the global BA,
    ``essential_method='5pt'`` takes the two-view E from the 5-point RANSAC.
    ``ransac_devices`` and ``ba_devices`` shard F-RANSAC's hypotheses and
    the global BA's points over that many devices (parallel/ransac.py,
    parallel/ba.py): distinct visible GPUs on ``cuda``, the CPU repeated on
    ``cpu``.  Sharded RANSAC draws exactly the single-device samples when
    the device count divides the chunk count ceil(ransac_iters / 1024); else
    the count rounds up to a device multiple.
    """

    data_path: str = "Phase1/Data"
    num_images: int = 5
    # F-RANSAC: hypotheses per pair, Sampson threshold in normalized coords
    ransac_iters: int = 50000
    ransac_threshold: float = 5e-4
    normalize: bool = True
    # hypothesis ranking for F- and PnP RANSAC: 'msac' (truncated-loss sum)
    # or 'count' (raw inlier count)
    ransac_scoring: str = "msac"
    ransac_devices: int = 1
    ransac_confidence: float = 0.0
    ransac_adaptive_device: "bool | None" = None
    # every pair's F-RANSAC in batched launches (False: one pair at a time)
    ransac_batch_pairs: bool = True
    # PnP RANSAC: hypotheses per camera, squared-px threshold
    pnp_iters: int = 10000
    pnp_threshold: float = 10.0
    pnp_f64_rescue: str = "auto"
    # two-view pose recovery
    essential_cleanup: bool = True     # project E's singular values to (1,1,0)
    center_convention: str = "hz"      # 'hz' | 'reference'
    essential_method: str = "from_f"
    e5_ransac_iters: int = 1000
    e5_threshold_px: float = 1.0
    two_view_refine_pose: bool = True  # joint pose+points BA after two views
    tri_refine_iters: int = 20         # LM steps per triangulated point
    # incremental triangulations enter the map only when they reproject
    # within this many px in both source views (0 = off)
    tri_reproj_gate_px: float = 10.0
    # extra passes over images whose PnP failed (0 = a single visit each)
    registration_retries: int = 2
    pnp_refine_iters: int = 50         # LM steps per pose refinement
    ba_max_iters: int = 50             # LM steps per bundle adjustment round
    ba_rounds: int = 2                 # BA / outlier-prune alternations
    ba_prune_px: float = 3.0
    ba_loss: str = "linear"            # 'linear' | 'huber'
    ba_huber_delta: float = 3.0
    # a light global BA after every ba_interval registrations (0 = off)
    ba_interval: int = 0
    ba_interval_iters: int = 10
    ba_devices: int = 1
    # comma-set of {f, fx, fy, pp, cx, cy, k1, k2} freed in the global BA
    ba_refine_intrinsics: str = ""
    global_rotation_init: bool = False
    global_init: bool = False
    global_init_batch_pairs: int = 256
    init_pair: str = "fixed"           # 'fixed' (1, 2) | 'auto'
    view_order: str = "index"          # 'index' | 'greedy'
    min_parallax_deg: float = 1.0
    # merge re-detected features across matching files into one track
    merge_tracks: bool = False
    merge_tol: float = 0.5
    seed: int = 0
    output_dir: str = "."
    show: bool = False

    def __post_init__(self):
        if self.ransac_confidence > 0.0 and self.ransac_devices > 1:
            raise ValueError(
                "adaptive RANSAC (ransac_confidence > 0) and hypothesis "
                "sharding (ransac_devices > 1) are mutually exclusive — "
                "drop --ransac_devices or --ransac_confidence"
            )
        if self.ba_refine_intrinsics:
            from sfm_nerf_tpu_torch.ops.ba import intrinsics_free_mask

            intrinsics_free_mask(self.ba_refine_intrinsics)
