"""predictions_per_s: makespans answered in the window (one per
candidate, or per deployment and profile), over the window's seconds."""
from bench.benchkit.stats import rate


def read(info):
    return rate(sum(r.predictions for r in info.records if r.ok),
                info.window_s)
