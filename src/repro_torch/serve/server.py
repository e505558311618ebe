"""`AdvisorServer`: the long-lived advisor service (docs/serving.md).

The paper's end goal is answering "which storage configuration is best
for my workflow?" fast enough to be interactive; at fleet scale that is
many concurrent queries against *warm* state, not one offline sweep.
The server owns exactly one `SweepSession` — a persistent warm engine
(bucket-callable + host-prep LRUs, device batches), the structure-keyed
`CompileCache` (optionally disk-backed, so restarts warm-start) — and
serves every client from it:

    admission   — `submit` enqueues a `coalescer.Ticket`; the deadline
                  clock starts here (the fixed ``item_timeout_s``
                  semantics: queue wait counts against the budget)
    dispatch    — one dispatcher task drains the queue in batches
                  (`coalescer.collect_batch`), expires overdue tickets
                  cleanly (`DeadlineExceeded`), and coalesces
                  structurally-equal questions (`group_tickets`)
    answer      — per distinct question: the results cache first
                  (zero compiles, zero simulator calls on a hit); the
                  batch's other distinct questions are swept together,
                  ONE engine call (`explore_batch`) for all that share a
                  ``locality_aware``, so rows of one shape bucket run in
                  one launch whichever tenant asked them — in a worker
                  thread under `SweepSession.lock` so sweeps serialize
                  against any other session user. Each answer fans out
                  to every coalesced sibling. If the shared call raises,
                  its questions are swept one at a time, so a bad
                  question fails only its own tickets

Bit-identity contract: every response is element-wise identical to a
direct per-request `explore()` on a fresh session (tests/test_torch_serve.py
and chip_smoke.py's ``advisor_path`` phase counter-assert this, plus
coalesced compiles < requests and zero compiles on results-cache hits).

Where it runs: a server-built session lives on ``device`` (default
``"cuda"``, raising when no card is present; ``device="cpu"`` runs the
plain PyTorch path); a borrowed ``session=`` keeps its own device.

Tracing: the session's tracer records, for each admitted request (its
id is the admission count), ``serve.request`` from submit to answer,
``serve.wait`` from submit until the sweep thread holds the session lock
(or the results cache answers), and ``serve.sweep`` around each engine
call, whose spans all carry its first ticket's id (docs/observability.md).
``serve.sweep``'s meta: ``questions``, the distinct questions swept in
that call (``ServeStats.sweeps / engine_sweeps`` is their mean), and
``candidates`` and ``group`` (the tickets answered), summed over them.

`set_service_times` swaps the model seed (a re-identified system) in
one step: the service digest changes, so every cached answer computed
under the old seed invalidates lazily on its next lookup — the
`SysIdReport`/`CompileCache` pattern, with no flush to forget.
"""
from __future__ import annotations

import asyncio
import dataclasses
from dataclasses import dataclass
from collections import OrderedDict
from typing import Dict, List, Optional, Union

from ..env import DeviceLike
from ..core.predictor import Predictor
from ..core.sweep.search import Evaluation, Question, explore_batch
from ..core.sweep.session import SweepSession
from ..core.sysid import SysIdReport
from ..core.types import ServiceTimes
from .coalescer import Ticket, collect_batch, group_tickets
from .request import (AdvisorRequest, AdvisorResponse, DeadlineExceeded,
                      ServerClosed, service_digest)
from .results_cache import ResultsCache

# default batch-collection window: long enough that a burst of
# concurrent clients coalesces, short enough to be invisible next to a
# cold sweep (which is O(100ms) even fully warm)
BATCH_WINDOW_S = 0.002


@dataclass
class ServeStats:
    """Serving-side counters (the sweep-side ones live in the session's
    `CacheStats`/`CompileCacheStats`; the results cache has its own)."""

    requests: int = 0             # tickets admitted
    responses: int = 0            # futures resolved with an answer
    batches: int = 0              # dispatcher batches drained
    sweeps: int = 0               # distinct questions swept (not cache hits)
    engine_sweeps: int = 0        # engine calls that swept them: several
                                  # questions of one batch share one
                                  # (sweeps / engine_sweeps: the mean
                                  # questions a call)
    coalesced: int = 0            # requests served by a sibling's sweep
                                  # (group members beyond the first)
    deadline_expired: int = 0     # tickets failed with DeadlineExceeded
    errors: int = 0               # questions whose sweep raised (failed
                                  # their group)
    sysid_swaps: int = 0          # set_service_times calls

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)


class AdvisorServer:
    """Async advisor service over one warm `SweepSession`.

    ``st`` seeds the model (or pass ``sysid=`` / a session constructed
    with one). ``session=`` shares an existing session (not closed on
    server close); otherwise the server builds and owns a private one
    (``cache_dir=`` persists its DAG cache across restarts).
    ``default_timeout_s`` is the deadline for requests that don't carry
    their own; None means no deadline. ``device`` places a server-built
    session (default ``"cuda"``); it must not be combined with
    ``session=``, which brings its own.

    Lifecycle: ``async with AdvisorServer(...) as srv`` (or explicit
    `start`/`close`). `submit` is the one client entry point.
    """

    def __init__(self, st: Optional[ServiceTimes] = None, *,
                 session: Optional[SweepSession] = None,
                 sysid: Optional[Union[SysIdReport, str]] = None,
                 cache_dir: Optional[str] = None,
                 batch_window_s: float = BATCH_WINDOW_S,
                 max_batch: int = 64,
                 default_timeout_s: Optional[float] = None,
                 results_entries: int = 256,
                 device: Optional[DeviceLike] = None):
        if session is None:
            session = SweepSession(cache_dir=cache_dir, sysid=sysid,
                                   device="cuda" if device is None else device)
            self._owns_session = True
        else:
            if cache_dir is not None:
                raise ValueError("pass session= or cache_dir=, not both")
            if device is not None:
                raise ValueError("pass session= or device=, not both")
            self._owns_session = False
        self.session = session
        if st is None:
            if session.sysid is None:
                raise ValueError("no service times: pass st= or sysid=")
            st = session.sysid.service_times
        self._st = st
        self._digest = service_digest(st)
        self.batch_window_s = batch_window_s
        self.max_batch = max(int(max_batch), 1)
        self.default_timeout_s = default_timeout_s
        self.results = ResultsCache(results_entries)
        self.stats = ServeStats()
        self._queue: Optional["asyncio.Queue[Ticket]"] = None
        self._dispatcher: Optional["asyncio.Task"] = None
        # id(request) -> its slice of the engine call in flight (set and
        # read under the session lock, by the sweep thread)
        self._swept: Dict[int, List[Evaluation]] = {}
        self.closed = False

    @classmethod
    def from_predictor(cls, pred: Predictor, **kw) -> "AdvisorServer":
        """A server on a predictor's warm state: shares its session
        (engine, DAG cache, pools) and serves its service times."""
        kw.setdefault("st", pred.service_times)
        return cls(session=pred.sweep_session(), **kw)

    # -- model seed ------------------------------------------------------------
    @property
    def service_times(self) -> ServiceTimes:
        return self._st

    @property
    def digest(self) -> str:
        """Current service digest — the tag new cached answers carry."""
        return self._digest

    def set_service_times(self, st: ServiceTimes) -> None:
        """Swap the model seed (a re-identified system). Cached answers
        computed under the old seed invalidate lazily on next lookup —
        digest mismatch, never a stale serve."""
        self._st = st
        self._digest = service_digest(st)
        self.stats.sysid_swaps += 1

    # -- lifecycle -------------------------------------------------------------
    async def start(self) -> "AdvisorServer":
        if self.closed:
            raise ServerClosed("server is closed")
        if self._dispatcher is None:
            self._queue = asyncio.Queue()
            self._dispatcher = asyncio.ensure_future(self._serve_loop())
        return self

    async def close(self) -> None:
        """Stop dispatching, fail unserved tickets with `ServerClosed`,
        and close the session if this server owns it. Idempotent."""
        if self.closed:
            return
        self.closed = True
        if self._dispatcher is not None:
            self._dispatcher.cancel()
            try:
                await self._dispatcher
            except asyncio.CancelledError:
                pass
            self._dispatcher = None
        if self._queue is not None:
            while not self._queue.empty():
                t = self._queue.get_nowait()
                if not t.future.done():
                    t.future.set_exception(ServerClosed("server closed"))
        if self._owns_session:
            self.session.close()

    async def __aenter__(self) -> "AdvisorServer":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.close()

    # -- client entry point ----------------------------------------------------
    async def submit(self, request: AdvisorRequest) -> AdvisorResponse:
        """Admit one request and await its answer. Raises
        `DeadlineExceeded` when the deadline (measured from this call)
        expires before dispatch, `ServerClosed` on shutdown, and
        whatever the sweep itself raised on invalid queries."""
        if self.closed or self._queue is None:
            raise ServerClosed("server not started (use `async with` "
                               "or await start())")
        timeout = request.timeout_s if request.timeout_s is not None \
            else self.default_timeout_s
        ticket = Ticket(request, asyncio.get_running_loop().create_future(),
                        timeout_s=timeout)
        self.stats.requests += 1
        ticket.rid = self.stats.requests
        await self._queue.put(ticket)
        resp: Optional[AdvisorResponse] = None
        try:
            resp = await ticket.future
            return resp
        finally:
            tracer = self.session.tracer
            tracer.record("serve.request", ticket.submit, tracer.clock(),
                          phase="serve", req=ticket.rid,
                          client=request.client,
                          cached=resp is not None and resp.cached,
                          group=0 if resp is None else resp.group_size)

    # -- dispatcher ------------------------------------------------------------
    async def _serve_loop(self) -> None:
        assert self._queue is not None
        while True:
            batch = await collect_batch(self._queue,
                                        window_s=self.batch_window_s,
                                        max_batch=self.max_batch)
            self.stats.batches += 1
            await self._process(batch)

    async def _process(self, batch: List[Ticket]) -> None:
        # expire overdue tickets at dispatch: their budget (measured
        # from submit) is already gone, so they must not occupy a sweep
        live: List[Ticket] = []
        for t in batch:
            if t.expired():
                self.stats.deadline_expired += 1
                if not t.future.done():
                    t.future.set_exception(
                        DeadlineExceeded(t.waited(), t.timeout_s or 0.0))
            else:
                live.append(t)
        tracer = self.session.tracer
        digest = self._digest
        # the questions the results cache cannot answer, by whether they
        # compile locality-aware: those that agree share one engine call
        calls: "OrderedDict[bool, list]" = OrderedDict()
        for key, tickets in group_tickets(live).items():
            evals = self.results.get(key, digest)
            if evals is None:
                calls.setdefault(tickets[0].request.locality_aware,
                                 []).append((key, tickets))
                continue
            t_hit = tracer.clock()
            for t in tickets:
                tracer.record("serve.wait", t.submit, t_hit,
                              phase="serve", req=t.rid)
            self._answer(tickets, evals, cached=True)
        for groups in calls.values():
            # off the event loop; the session lock serializes it against
            # any other thread driving the same session
            self.stats.sweeps += len(groups)
            outs = await asyncio.to_thread(self._sweep_groups,
                                           [tickets for _, tickets in groups])
            for (key, tickets), out in zip(groups, outs):
                if isinstance(out, Exception):    # fail the group cleanly
                    self.stats.errors += 1
                    for t in tickets:
                        if not t.future.done():
                            t.future.set_exception(out)
                    continue
                self.results.put(key, digest, out)
                self._answer(tickets, out, cached=False)

    def _answer(self, tickets: List[Ticket], evals: List[Evaluation], *,
                cached: bool) -> None:
        self.stats.coalesced += len(tickets) - 1
        for t in tickets:
            self.stats.responses += 1
            if not t.future.done():
                t.future.set_result(AdvisorResponse(
                    evaluations=evals, cached=cached,
                    group_size=len(tickets), latency_s=t.waited()))

    def _sweep_groups(self, groups: List[List[Ticket]]
                      ) -> List[Union[List[Evaluation], Exception]]:
        """Every group's answer, or what its sweep raised, in a worker
        thread: every ticket's wait ends once this thread holds the
        session lock. The groups' questions share one engine call; if
        it raises, each is swept alone, so the error lands only on the
        question that raised it."""
        tracer = self.session.tracer
        with self.session.lock:
            t_lock = tracer.clock()
            for tickets in groups:
                for t in tickets:
                    tracer.record("serve.wait", t.submit, t_lock,
                                  phase="serve", req=t.rid)
            try:
                return self._engine_sweep(groups)
            except Exception as exc:
                if len(groups) == 1:
                    return [exc]
            outs: List[Union[List[Evaluation], Exception]] = []
            for tickets in groups:
                try:
                    outs += self._engine_sweep([tickets])
                except Exception as exc:
                    outs.append(exc)
            return outs

    def _engine_sweep(self, groups: List[List[Ticket]]
                      ) -> List[List[Evaluation]]:
        """One engine call for the groups' questions (the caller holds
        the session lock), then each answer through `_run_sweep`.
        The call's spans carry the first ticket's request id."""
        self.stats.engine_sweeps += 1
        tracer = self.session.tracer
        reqs = [tickets[0].request for tickets in groups]
        with tracer.request(groups[0][0].rid), \
                tracer.span("serve.sweep", phase="serve",
                            questions=len(reqs),
                            candidates=sum(len(r.candidates) for r in reqs),
                            group=sum(len(tickets) for tickets in groups)):
            try:
                self._swept = dict(zip(map(id, reqs), self._explore(reqs)))
                return [self._run_sweep(r) for r in reqs]
            finally:
                self._swept = {}

    def _explore(self, reqs: List[AdvisorRequest]) -> List[List[Evaluation]]:
        """One `explore_batch` of ``reqs``, which agree on
        ``locality_aware``; the caller holds the session lock."""
        return explore_batch(
            [Question(lambda c, wf=r.workflow: wf, r.candidates,
                      r.verify_top_k, r.objective) for r in reqs],
            self._st, locality_aware=reqs[0].locality_aware,
            session=self.session)

    def _run_sweep(self, req: AdvisorRequest) -> List[Evaluation]:
        """``req``'s slice of the engine call just made for its batch; a
        request that call did not sweep is swept alone. The caller holds
        the session lock."""
        evals = self._swept.pop(id(req), None)
        return evals if evals is not None else self._explore([req])[0]
