"""Results cache: whole-answer memoization above the sweep stack
(docs/serving.md).

The sweep layers already make repeat questions cheap (warm DAGs, warm
executables); this layer makes them *free*: an answer is keyed by
``(workflow fp, grid fp)`` and tagged with the `request.service_digest`
it was computed under, so a repeat query performs zero compiles and
zero simulator calls — it returns the stored evaluation list by
reference (read-only contract, like cache-served `MicroOps`).

Invalidation follows the `SysIdReport`/`CompileCache` digest pattern:
the digest is checked on lookup, and a mismatch (re-identified service
times, compiler change) drops the stale entry and reports a miss —
stale answers are never served, and nobody has to remember to flush.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..core.sweep.search import Evaluation
from .request import QueryKey


@dataclass
class ResultsCacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    invalidations: int = 0        # entries dropped on digest mismatch
                                  # (each also counts as a miss)

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)


class ResultsCache:
    """LRU of `explore` answers keyed by ``(wf_fp, grid_fp)``, each
    entry tagged with the service digest it was computed under."""

    def __init__(self, max_entries: int = 256):
        self.max_entries = max_entries
        self._entries: "OrderedDict[QueryKey, Tuple[str, List[Evaluation]]]" \
            = OrderedDict()
        self.stats = ResultsCacheStats()
        self._mu = threading.Lock()

    def get(self, key: QueryKey, digest: str) -> Optional[List[Evaluation]]:
        """The stored answer, or None. ``digest`` is the *current*
        service digest: an entry tagged with any other digest is stale —
        dropped and counted, never served."""
        with self._mu:
            entry = self._entries.get(key)
            if entry is None:
                self.stats.misses += 1
                return None
            stored, evals = entry
            if stored != digest:
                del self._entries[key]
                self.stats.invalidations += 1
                self.stats.misses += 1
                return None
            self.stats.hits += 1
            self._entries.move_to_end(key)
            return evals

    def put(self, key: QueryKey, digest: str,
            evals: List[Evaluation]) -> None:
        with self._mu:
            self._entries[key] = (digest, evals)
            self._entries.move_to_end(key)
            if len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.stats.evictions += 1

    def __len__(self) -> int:
        with self._mu:
            return len(self._entries)

    def clear(self) -> None:
        with self._mu:
            self._entries.clear()
