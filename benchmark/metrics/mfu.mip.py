"""mfu.mip: the mip-NeRF steps' least operations (three forwards of every
ray x interval at each of the two levels, counts.py over the
configuration's reference/mipnerf.py) over the device's own span of the
traced slice (the start of its first kernel or copy to the end of its
last, from the trace), against the card's dense bf16 peak, in %."""

from benchmark import counts

SPANS = []


def read(view):
    if view.units == 0 or view.span_s <= 0:
        return None
    return 100.0 * view.units * view.unit_flops / view.span_s / counts.PEAK_BF16
