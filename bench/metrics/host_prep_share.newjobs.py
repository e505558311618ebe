"""host_prep_share.newjobs: the share of the window spent in the
program's ``prep[...]`` spans (the engine's host prep: scan order,
padding, the arrays' copy to the card)."""
from bench.benchkit.stats import phase_sums


def read(info):
    if not info.program_spans:
        return None
    s = phase_sums(info.program_spans, 0.0, info.window_s)
    return 100.0 * s["host_prep_s"] / info.window_s
