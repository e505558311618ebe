"""compile_share.newjobs: the share of the window spent in the program's
``compile_grid`` spans (workflow to micro-op DAG, placement included:
core/compile.py and core/placement.py via core/sweep/compilecache.py)."""
from bench.benchkit.stats import phase_sums


def read(info):
    if not info.program_spans:
        return None
    s = phase_sums(info.program_spans, 0.0, info.window_s)
    return 100.0 * s["compile_s"] / info.window_s
