"""Sweep-as-a-service: a long-lived async advisor on top of
`Predictor`/`SweepSession` (docs/serving.md).

    request       — `AdvisorRequest`/`AdvisorResponse`, query identity
                    (workflow + grid fingerprints), `service_digest`
    coalescer     — admission tickets, batch collection, coalescing of
                    structurally-equal questions into one sweep
    results_cache — whole-answer LRU keyed by (wf fp, grid fp), tagged
                    and invalidated by service digest
    server        — `AdvisorServer`: one warm session, an admission
                    queue with submit-anchored deadlines, bit-identical
                    answers

The server runs its sweeps on its session's device (``"cuda"`` unless
the caller asks for the CPU), so every answer goes through the
sweep-scan kernel on a card; `chip_smoke.py`'s ``advisor_path`` phase
drives it there.
"""
from .coalescer import Ticket, collect_batch, group_tickets
from .request import (AdvisorRequest, AdvisorResponse, DeadlineExceeded,
                      QueryKey, ServerClosed, grid_fingerprint,
                      service_digest)
from .results_cache import ResultsCache, ResultsCacheStats
from .server import AdvisorServer, ServeStats

__all__ = [
    "Ticket", "collect_batch", "group_tickets",
    "AdvisorRequest", "AdvisorResponse", "DeadlineExceeded", "QueryKey",
    "ServerClosed", "grid_fingerprint", "service_digest",
    "ResultsCache", "ResultsCacheStats",
    "AdvisorServer", "ServeStats",
]
