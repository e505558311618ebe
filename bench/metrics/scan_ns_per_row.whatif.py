"""scan_ns_per_row.whatif: the summed kernel time of the window over its
op rows (ops of each request's DAG times its profiles)."""


def read(info):
    t = info.trace
    if t is None or not t.kernels or info.work is None or not info.work.rows:
        return None
    return t.kernel_s * 1e9 / info.work.rows
