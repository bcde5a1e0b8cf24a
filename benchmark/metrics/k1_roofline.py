"""k1_roofline: the least time of the renderer's ``fused_render_rays``
calls (the larger of one forward's operations at the bf16 peak and its
bytes at the HBM peak, at each call's own rays x samples) over the device
time of the work those calls queued, in %."""

from benchmark import counts

NAME = "fused_render_rays"
SPANS = [("sfm_nerf_tpu_torch.train.nerf_trainer", NAME)]


def read(view):
    calls = view.calls.get(NAME, [])
    device_s = sum(c.device_s for c in calls)
    if not calls or device_s <= 0:
        return None
    least = 0.0
    for c in calls:
        n, s = c.shapes[2]      # (origins, directions, z_vals)
        least += counts.least_s(counts.forward_flops(view.arch, view.model, n, s),
                                counts.render_bytes(view.arch, view.model, n, s))
    return 100.0 * least / device_s
