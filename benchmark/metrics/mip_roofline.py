"""mip_roofline: the least time of the trainer's cone kernel calls,
``fused_mse_loss_cones`` (K2) and ``fused_mse_loss_cones_weights`` (K4)
(the larger of three forwards' operations at the bf16 peak and the cone
step's bytes at the HBM peak, reference/mipnerf.py's counts, at each
call's own rays x intervals) over the device time of the work those calls
queued, in %."""

from benchmark import counts

MODULE = "sfm_nerf_tpu_torch.train.nerf_trainer"
NAMES = ("fused_mse_loss_cones", "fused_mse_loss_cones_weights")
SPANS = [(MODULE, n) for n in NAMES]


def read(view):
    calls = [(n, c) for n in NAMES for c in view.calls.get(n, [])]
    device_s = sum(c.device_s for _, c in calls)
    if not calls or device_s <= 0:
        return None
    least = 0.0
    for name, c in calls:
        n, edges = c.shapes[3]      # (origins, directions, cones, edges, target)
        s = edges - 1
        least += counts.least_s(
            counts.train_flops(view.arch, view.model, n, s),
            view.arch.cone_train_bytes(view.model, n, s, weights_out=name.endswith("weights")))
    return 100.0 * least / device_s
