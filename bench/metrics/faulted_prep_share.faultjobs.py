"""faulted_prep_share.faultjobs: the share of the window spent in the
program's ``prep[...]`` spans of faulted buckets (meta ``faulted`` 1: the
engine's host prep of a bucket that runs with fault arrays: scan order,
padding, the op and fault arrays' copy to the card), each clipped to the
window. None where no span carries the flag."""


def read(info):
    spans = [s for s in info.program_spans
             if s.name.startswith("prep[") and "faulted" in dict(s.meta)]
    if not spans:
        return None
    secs = sum(max(0.0, min(s.start + s.dur, info.window_s) - max(s.start, 0.0))
               for s in spans if dict(s.meta)["faulted"] == 1)
    return 100.0 * secs / info.window_s
