"""sampling_ms.train: device milliseconds a step of the work queued by the
trainer's calls of the ray and depth samplers (``sample_ray_batch``,
``stratified_samples``, and on the hierarchical step ``sample_pdf`` and
``merge_sorted``)."""

MODULE = "sfm_nerf_tpu_torch.train.nerf_trainer"
NAMES = ("sample_ray_batch", "stratified_samples", "sample_pdf", "merge_sorted")
SPANS = [(MODULE, n) for n in NAMES]


def read(view):
    calls = [c for n in NAMES for c in view.calls.get(n, [])]
    if not calls or view.units == 0:
        return None
    return 1e3 * sum(c.device_s for c in calls) / view.units
