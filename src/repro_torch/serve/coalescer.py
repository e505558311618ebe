"""Admission queue plumbing: tickets, batch collection, and coalescing
(docs/serving.md).

The server's dispatcher drains the admission queue in small batches —
the first waiting request opens a short collection window, and every
request that arrives inside it joins the batch. `group_tickets` then
buckets the batch by `AdvisorRequest.query_key()`: requests asking the
structurally-same question (equal workflow fingerprint, equal grid
fingerprint) coalesce into ONE sweep whose answer fans back out to
every member. Makespans are per-(DAG, service-times) and independent of
how requests were batched, so a coalesced answer is bit-identical to
the answer each member would have computed alone (the serving analogue
of the backend differential: makespans never depend on batching).

Deadlines ride each ticket: the clock starts at *submit* (the
reference's fixed ``item_timeout_s`` semantics), so time spent
waiting in the queue counts against the budget and an expired ticket
fails at dispatch instead of occupying a sweep slot.
"""
from __future__ import annotations

import asyncio
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import List, Optional

from .request import AdvisorRequest, QueryKey


@dataclass
class Ticket:
    """One admitted request: the future its client awaits, plus the
    submit instant its deadline is measured from (on `time.perf_counter`,
    the tracer's clock, so a traced queue wait and `waited` agree)."""

    request: AdvisorRequest
    future: "asyncio.Future"
    submit: float = field(default_factory=time.perf_counter)
    timeout_s: Optional[float] = None   # resolved (request or server default)
    rid: int = 0                        # the server's admission count

    def waited(self, now: Optional[float] = None) -> float:
        return (time.perf_counter() if now is None else now) - self.submit

    def expired(self, now: Optional[float] = None) -> bool:
        """Deadline check, measured from submit — never from when the
        dispatcher happened to reach the ticket."""
        return (self.timeout_s is not None
                and self.waited(now) >= self.timeout_s)


async def collect_batch(queue: "asyncio.Queue[Ticket]", *,
                        window_s: float, max_batch: int) -> List[Ticket]:
    """Block for the first ticket, then keep collecting until the
    window closes, the batch fills, or the queue momentarily drains.
    ``window_s=0`` degrades to opportunistic draining (whatever is
    already enqueued), which still coalesces a burst of concurrent
    clients that queued while the previous batch was being served."""
    batch = [await queue.get()]
    deadline = time.monotonic() + window_s
    while len(batch) < max_batch:
        left = deadline - time.monotonic()
        if left <= 0:
            while len(batch) < max_batch and not queue.empty():
                batch.append(queue.get_nowait())
            break
        try:
            batch.append(await asyncio.wait_for(queue.get(), timeout=left))
        except asyncio.TimeoutError:
            break
    return batch


def group_tickets(batch: List[Ticket]
                  ) -> "OrderedDict[QueryKey, List[Ticket]]":
    """Coalesce a batch by structural question identity (first-seen
    order preserved, so dispatch is deterministic for a given batch)."""
    groups: "OrderedDict[QueryKey, List[Ticket]]" = OrderedDict()
    for t in batch:
        groups.setdefault(t.request.query_key(), []).append(t)
    return groups
