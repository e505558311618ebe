"""device_idle_share: the share of the traced window in which nothing
ran on the card (kernels, copies and memsets from the profiler)."""


def read(info):
    t = info.trace
    if t is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
