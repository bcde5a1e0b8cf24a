"""k4_roofline: the least time of the trainer's ``fused_mse_loss_weights`` calls
(the larger of three forwards' operations at the bf16 peak and their
bytes at the HBM peak, at each call's own rays x samples) over the device
time of the work those calls queued, in %."""

from benchmark import counts

NAME = "fused_mse_loss_weights"
SPANS = [("sfm_nerf_tpu_torch.train.nerf_trainer", NAME)]


def read(view):
    calls = view.calls.get(NAME, [])
    device_s = sum(c.device_s for c in calls)
    if not calls or device_s <= 0:
        return None
    least = 0.0
    for c in calls:
        n, s = c.shapes[2]      # (origins, directions, z_vals, target)
        least += counts.least_s(counts.train_flops(view.arch, view.model, n, s),
                                counts.train_bytes(view.arch, view.model, n, s,
                                                   weights_out=True))
    return 100.0 * least / device_s
