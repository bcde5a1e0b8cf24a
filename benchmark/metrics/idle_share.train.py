"""idle_share.train: the share of the traced slice in which the device
ran no kernel and no copy, in %."""

SPANS = []


def read(view):
    if view.window_s <= 0 or view.busy_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)
