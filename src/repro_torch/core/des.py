"""Minimal process-based discrete-event simulation engine (simpy-style).

Used by `emulator.py` only — the *fine-grained* ground-truth system that
plays the role of the real 20-node MosaStore testbed. It is deliberately
independent from the compiled-DAG machinery in `compile.py`/`ref_sim.py`
so that predictor-vs-"actual" accuracy numbers are not a tautology.

Processes are Python generators that yield:
    Timeout(dt)      — advance simulated time
    Acquire(res)     — wait for a FIFO resource token (returns a grant)
    Wait(event)      — wait for an Event to fire
    AllOf([events])  — wait for all events
A process's completion fires its `done` Event.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Any, Generator, Iterable, List, Optional


class Event:
    __slots__ = ("env", "fired", "value", "_waiters")

    def __init__(self, env: "Environment"):
        self.env = env
        self.fired = False
        self.value: Any = None
        self._waiters: List["Process"] = []

    def fire(self, value: Any = None) -> None:
        if self.fired:
            return
        self.fired = True
        self.value = value
        for p in self._waiters:
            self.env._schedule(p, None)
        self._waiters.clear()


class Timeout:
    __slots__ = ("dt",)

    def __init__(self, dt: float):
        assert dt >= 0.0, f"negative timeout {dt}"
        self.dt = dt


class Acquire:
    __slots__ = ("res",)

    def __init__(self, res: "Resource"):
        self.res = res


class Wait:
    __slots__ = ("event",)

    def __init__(self, event: Event):
        self.event = event


class AllOf:
    __slots__ = ("events",)

    def __init__(self, events: Iterable[Event]):
        self.events = list(events)


class Resource:
    """Single- or multi-server FIFO resource."""

    __slots__ = ("env", "capacity", "in_use", "queue", "name")

    def __init__(self, env: "Environment", capacity: int = 1, name: str = ""):
        self.env = env
        self.capacity = capacity
        self.in_use = 0
        self.queue: List["Process"] = []
        self.name = name

    @property
    def backlog(self) -> int:
        return len(self.queue)

    def _acquire(self, proc: "Process") -> bool:
        if self.in_use < self.capacity:
            self.in_use += 1
            return True
        self.queue.append(proc)
        return False

    def release(self) -> None:
        self.in_use -= 1
        if self.queue:
            nxt = self.queue.pop(0)
            self.in_use += 1
            self.env._schedule(nxt, None)


class Process:
    __slots__ = ("env", "gen", "done")

    def __init__(self, env: "Environment", gen: Generator):
        self.env = env
        self.gen = gen
        self.done = Event(env)


class Environment:
    def __init__(self):
        self.now = 0.0
        self._heap: List = []
        self._seq = itertools.count()
        self.n_events = 0

    # -- scheduling internals ---------------------------------------------------
    def _schedule(self, proc: Process, delay: Optional[float]) -> None:
        t = self.now if delay is None else self.now + delay
        heapq.heappush(self._heap, (t, next(self._seq), proc))

    def process(self, gen: Generator) -> Process:
        p = Process(self, gen)
        self._schedule(p, 0.0)
        return p

    def event(self) -> Event:
        return Event(self)

    def resource(self, capacity: int = 1, name: str = "") -> Resource:
        return Resource(self, capacity, name)

    def _step(self, proc: Process) -> None:
        while True:
            try:
                cmd = next(proc.gen)
            except StopIteration:
                proc.done.fire()
                return
            self.n_events += 1
            if isinstance(cmd, Timeout):
                self._schedule(proc, cmd.dt)
                return
            if isinstance(cmd, Acquire):
                if cmd.res._acquire(proc):
                    continue            # got it immediately
                return                  # parked in the resource queue
            if isinstance(cmd, Wait):
                if cmd.event.fired:
                    continue
                cmd.event._waiters.append(proc)
                return
            if isinstance(cmd, AllOf):
                pending = [e for e in cmd.events if not e.fired]
                if not pending:
                    continue
                # chain: wait events one by one via a helper event
                gate = self.event()
                state = {"left": len(pending)}

                def arm(e: Event):
                    def cb_proc():
                        yield Wait(e)
                        state["left"] -= 1
                        if state["left"] == 0:
                            gate.fire()
                    self.process(cb_proc())

                for e in pending:
                    arm(e)
                cmd = Wait(gate)
                if gate.fired:
                    continue
                gate._waiters.append(proc)
                return
            raise TypeError(f"bad yield {cmd!r}")

    def run(self, until: float = float("inf")) -> float:
        while self._heap:
            t, _, proc = heapq.heappop(self._heap)
            if t > until:
                self.now = until
                return self.now
            self.now = t
            self._step(proc)
        return self.now
