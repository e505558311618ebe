"""scan_roofline.whatif: the least time the card could take for the
window's scans (`benchkit.yardstick`: f64 operations bound it, not
bytes), over the summed time of every kernel the requests launched."""


def read(info):
    t = info.trace
    if t is None or not t.kernels or info.work is None or not info.work.rows:
        return None
    return 100.0 * info.work.bound_s / t.kernel_s
