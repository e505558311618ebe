"""answer_p95_s: the 95th percentile of the same set as answer_p50_s."""
from bench.benchkit.stats import percentile


def read(info):
    lat = [r.latency_s for r in info.records if r.ok]
    return percentile(lat, 95) if lat else None
