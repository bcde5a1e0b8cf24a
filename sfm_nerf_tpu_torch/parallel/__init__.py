"""Multi-device execution on ``torch.distributed``, the counterpart of
sfm_nerf_tpu/parallel/.

- ``mesh``: the (data, model) device mesh over the initialised ranks, its
  multi-node (dcn, data, model) form, and process-group start-up (from
  torchrun's environment, or in-process with an explicit backend and port);
- ``train_step``: the data-parallel NeRF step (rays split over ranks, one
  all-reduce of the grads and the loss per step) and the dp x tp step
  (parameters stored as DTensors sharded over the model axis);
- ``render``: a full frame's rays split over the data ranks;
- ``ransac`` and ``ba``: hypothesis-sharded F-RANSAC and point-sharded bundle
  adjustment, in one process over a list of devices, as the JAX package
  shards SfM over local devices.

The fused kernels run per rank as they run on one device; nothing here
launches a kernel of its own.
"""

from sfm_nerf_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
