"""faulted_compile_share.faultjobs: the share of the window spent in the
program's ``compile_dag`` spans of faulted DAGs (meta ``faulted`` 1: a
`compile_workflow` under a fault scenario, placement with its failover
picks included), each clipped to the window. None where no span carries
the flag."""


def read(info):
    spans = [s for s in info.program_spans
             if s.name == "compile_dag" and "faulted" in dict(s.meta)]
    if not spans:
        return None
    secs = sum(max(0.0, min(s.start + s.dur, info.window_s) - max(s.start, 0.0))
               for s in spans if dict(s.meta)["faulted"] == 1)
    return 100.0 * secs / info.window_s
