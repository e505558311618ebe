"""faulted_compile_us_per_op.faultjobs: host compile's time a micro-op on
faulted DAGs, from the program's ``compile_dag`` spans with meta
``faulted`` 1 (their ``ops`` in the meta). Each span is clipped to the
window and its ops counted in proportion to the part inside, as
``compile_us_per_op.newjobs`` counts them. None where no span carries
the flag."""


def read(info):
    secs = ops = 0.0
    for s in info.program_spans:
        if s.name != "compile_dag" or s.dur <= 0.0:
            continue
        meta = dict(s.meta)
        if meta.get("faulted") != 1:
            continue
        inside = min(s.start + s.dur, info.window_s) - max(s.start, 0.0)
        if inside > 0.0:
            secs += inside
            ops += meta["ops"] * inside / s.dur
    if ops <= 0.0:
        return None
    return 1e6 * secs / ops
