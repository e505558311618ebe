"""compile_us_per_op.newjobs: host compile's time a micro-op, from the
program's ``compile_dag`` spans (one a cold `compile_workflow` in
core/sweep/compilecache.py, its ``ops`` in the meta). Each span is
clipped to the window and its ops counted in proportion to the part
inside, so a compile cut by the window's edge counts at its own rate."""


def read(info):
    secs = ops = 0.0
    for s in info.program_spans:
        if s.name != "compile_dag" or s.dur <= 0.0:
            continue
        inside = min(s.start + s.dur, info.window_s) - max(s.start, 0.0)
        if inside > 0.0:
            secs += inside
            ops += dict(s.meta)["ops"] * inside / s.dur
    if ops <= 0.0:
        return None
    return 1e6 * secs / ops
