"""answer_p50_s: the median time from a request's submission (or call)
to its answer, over every answered request of the window."""
from bench.benchkit.stats import percentile


def read(info):
    lat = [r.latency_s for r in info.records if r.ok]
    return percentile(lat, 50) if lat else None
