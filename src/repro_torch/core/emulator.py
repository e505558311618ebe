"""Fine-grained emulator of the deployed system — the "actual cluster".

There is no 20-node testbed to run on, so predictor accuracy is
measured against this emulator instead. It intentionally models
everything the paper's predictor *abstracts away* (§5 lists these as the
known inaccuracy sources), so the predictor-vs-actual gap is structurally
similar to the paper's:

  * packet-granularity network with per-message framing overhead,
  * acknowledgement and metadata messages that cost network time,
  * per-connection TCP setup, with a 3 s SYN-timeout artifact under
    congestion (the paper discovered exactly this in MosaStore, §5),
  * lognormal service-time jitter,
  * manager lock contention (service inflates with outstanding requests),
  * task-launch stagger from the workflow runtime,
  * dynamic (not idealized) task dispatch to free clients,
  * optional history-dependent spinning-disk model (seek penalties).

Implementation is process-based on the mini engine in `des.py` and shares
no simulation code with the predictor path.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .des import Acquire, AllOf, Environment, Event, Timeout, Wait
from .placement import Manager
from .types import (CTRL_BYTES, KB, MB, FileAttr, RunReport, StorageConfig,
                    Task, Workflow)


@dataclass(frozen=True)
class EmulatorParams:
    """Ground-truth hardware/software behaviour, *independent* of the
    predictor's seed (sysid recovers ServiceTimes from this system the
    same way the paper's scripts recover them from a real cluster)."""

    nic_bps: float = 119 * MB          # 1 Gbps payload rate
    loopback_bps: float = 2.2 * 1024 * MB
    ramdisk_bps: float = 1.1 * 1024 * MB
    disk_bps: float = 95 * MB          # spinning-disk streaming rate
    disk_seek: float = 8e-3            # seek penalty when switching files
    hdd: bool = False
    rtt: float = 200e-6
    packet_bytes: int = 256 * KB
    per_msg_overhead: float = 60e-6    # syscall/framing per message
    storage_rpc: float = 0.35e-3       # per-chunk RPC handling at storage node
    manager_svc: float = 0.35e-3       # base manager service per request
    manager_lock: float = 0.08e-3      # extra per queued manager request (locking)
    jitter_sigma: float = 0.05         # lognormal sigma on service times
    tcp_connect: float = 1e-3          # connection setup (one-time per pair)
    tcp_timeout: float = 3.0           # SYN-timeout under congestion (§5)
    tcp_timeout_backlog: int = 24      # in-queue backlog triggering SYN loss risk
    tcp_timeout_prob: float = 0.25
    stagger: float = 50e-3             # task-launch stagger upper bound
    client_overhead: float = 0.15e-3   # SAI per-operation overhead


class _HostNet:
    def __init__(self, env: Environment, h: int):
        self.out = env.resource(name=f"out{h}")
        self.inq = env.resource(name=f"in{h}")
        self.loop = env.resource(name=f"loop{h}")
        self.cpu = env.resource(name=f"cpu{h}")


class _Disk:
    """History-dependent spinning-disk state (what makes HDD predictions
    harder, §5): switching between files costs a seek."""

    def __init__(self):
        self.last_file: Optional[str] = None

    def access_penalty(self, fname: str, p: EmulatorParams) -> float:
        pen = p.disk_seek if (p.hdd and self.last_file != fname) else 0.0
        self.last_file = fname
        return pen


class Emulator:
    def __init__(self, cfg: StorageConfig, params: EmulatorParams = EmulatorParams(),
                 seed: int = 0):
        self.cfg = cfg
        self.p = params
        self.rng = np.random.default_rng(seed)
        self.env = Environment()
        self.hosts = [_HostNet(self.env, h) for h in range(cfg.n_hosts)]
        self.storage_svc = {h: self.env.resource(name=f"sm{h}") for h in cfg.storage_hosts}
        self.disks = {h: _Disk() for h in cfg.storage_hosts}
        self.manager_svc = self.env.resource(name="manager")
        self.mgr = Manager(cfg)            # placement decisions (same policy code;
        # placement is configuration, not timing — timing is all re-derived here)
        self.connected: set[Tuple[int, int]] = set()
        self.bytes_moved = 0
        # fault scenario (docs/faults.md): the emulator models the *rate*
        # components — degraded disks inflate storage service, stragglers
        # inflate compute — so sysid and accuracy studies can run against
        # a sick "actual cluster". Node *death* is a predictor-side
        # structural question (failover chains); emulating the kill
        # protocol is out of scope here and NodeFailure entries are
        # ignored, documented in docs/faults.md.
        self.degr: Dict[int, float] = {}
        self.slow: Dict[int, float] = {}
        if cfg.faults is not None:
            self.degr = {cfg.storage_hosts[d.node]: d.factor
                         for d in cfg.faults.degraded}
            self.slow = {cfg.client_hosts[s.rank]: s.factor
                         for s in cfg.faults.stragglers}

    # --- low-level network ------------------------------------------------------
    def _jit(self, t: float) -> float:
        if self.p.jitter_sigma <= 0:
            return t
        return t * float(self.rng.lognormal(0.0, self.p.jitter_sigma))

    def transfer(self, src: int, dst: int, nbytes: int):
        """Packet-level message transfer; generator process."""
        p = self.p
        self.bytes_moved += nbytes
        if src == dst:
            res = self.hosts[src].loop
            yield Acquire(res)
            yield Timeout(self._jit(nbytes / p.loopback_bps + p.per_msg_overhead))
            res.release()
            return
        # TCP connection setup, once per ordered pair; the handshake work
        # occupies the sender's network stack (it serializes with other
        # outbound work — this is the "connection handling overhead" of
        # the paper's Fig. 1 at high stripe widths)
        if (src, dst) not in self.connected:
            self.connected.add((src, dst))
            setup = p.tcp_connect
            if (self.hosts[dst].inq.backlog > p.tcp_timeout_backlog
                    and self.rng.random() < p.tcp_timeout_prob):
                setup += p.tcp_timeout          # the 3 s SYN-timeout artifact
            yield Acquire(self.hosts[src].out)
            yield Timeout(setup)
            self.hosts[src].out.release()
        n_pkts = max(1, math.ceil(nbytes / p.packet_bytes))
        pkts = [p.packet_bytes] * (n_pkts - 1) + [nbytes - p.packet_bytes * (n_pkts - 1)]
        if pkts[-1] == 0:
            pkts[-1] = nbytes  # nbytes == 0: one empty packet
        crossed = [self.env.event() for _ in pkts]

        def receiver():
            for ev, pkt in zip(crossed, pkts):
                yield Wait(ev)
                yield Acquire(self.hosts[dst].inq)
                yield Timeout(self._jit(pkt / p.nic_bps))
                self.hosts[dst].inq.release()

        rp = self.env.process(receiver())
        for ev, pkt in zip(crossed, pkts):
            yield Acquire(self.hosts[src].out)
            yield Timeout(self._jit(pkt / p.nic_bps))
            self.hosts[src].out.release()
            ev.fire()
        yield Wait(rp.done)          # packets pipeline through out->in
        yield Timeout(p.rtt / 2)
        yield Timeout(p.per_msg_overhead)

    def _manager_request(self):
        yield Acquire(self.manager_svc)
        lock_penalty = self.p.manager_lock * self.manager_svc.backlog
        yield Timeout(self._jit(self.p.manager_svc + lock_penalty))
        self.manager_svc.release()

    def _storage_serve(self, host: int, fname: str, nbytes: int):
        p = self.p
        yield Acquire(self.storage_svc[host])
        rate = p.disk_bps if p.hdd else p.ramdisk_bps
        dt = p.storage_rpc + nbytes / rate + self.disks[host].access_penalty(fname, p)
        dt *= self.degr.get(host, 1.0)     # degraded-disk slowdown
        yield Timeout(self._jit(dt))
        self.storage_svc[host].release()

    # --- storage protocol ---------------------------------------------------------
    def write_file(self, client_host: int, fname: str, size: int,
                   attr: Optional[FileAttr]):
        env = self.env
        loc = self.mgr.place(fname, size, client_host, attr)
        m = self.cfg.manager_host
        yield Timeout(self.p.client_overhead)
        # allocation round-trip (manager request #1)
        yield from self.transfer(client_host, m, CTRL_BYTES)
        yield from self._manager_request()
        yield from self.transfer(m, client_host, CTRL_BYTES)

        # chunks, each an independent process; ack costs network (unlike predictor)
        def store_chunk(j: int):
            cb = loc.chunk_bytes(j)
            chain = loc.chunks[j]
            yield from self.transfer(client_host, chain[0], cb)
            yield from self._storage_serve(chain[0], fname, cb)
            for prev, nxt in zip(chain, chain[1:]):
                yield from self.transfer(prev, nxt, cb)
                yield from self._storage_serve(nxt, fname, cb)
            yield from self.transfer(chain[-1], client_host, CTRL_BYTES)  # ack

        procs = [env.process(store_chunk(j)) for j in range(loc.n_chunks)]
        yield AllOf([pr.done for pr in procs])
        # commit round-trip (manager request #2)
        yield from self.transfer(client_host, m, CTRL_BYTES)
        yield from self._manager_request()
        yield from self.transfer(m, client_host, CTRL_BYTES)

    def read_file(self, client_host: int, fname: str):
        env = self.env
        loc = self.mgr.lookup(fname)
        m = self.cfg.manager_host
        yield Timeout(self.p.client_overhead)
        yield from self.transfer(client_host, m, CTRL_BYTES)
        yield from self._manager_request()
        yield from self.transfer(m, client_host, CTRL_BYTES)

        def fetch_chunk(j: int):
            cb = loc.chunk_bytes(j)
            src = loc.chunks[j][j % len(loc.chunks[j])]
            yield from self.transfer(client_host, src, CTRL_BYTES)
            yield from self._storage_serve(src, fname, cb)
            yield from self.transfer(src, client_host, cb)

        procs = [env.process(fetch_chunk(j)) for j in range(loc.n_chunks)]
        yield AllOf([pr.done for pr in procs])

    # --- workflow runtime (dynamic dispatch, §5 "idealized image" gap) -----------
    def run_workflow(self, wf: Workflow, *, locality_aware: bool = True) -> RunReport:
        wf.validate()
        env = self.env
        cfg = self.cfg
        for fname, (size, attr) in wf.preloaded.items():
            self.mgr.place(fname, size, cfg.manager_host, attr)

        file_ready: Dict[str, Event] = {n: env.event() for t in wf.tasks
                                        for n, _ in t.outputs}
        for n in wf.preloaded:
            file_ready[n] = env.event()
            file_ready[n].fire()

        client_free = {c: env.resource(name=f"cl{c}") for c in range(cfg.n_clients)}
        host_to_client = {h: i for i, h in enumerate(cfg.client_hosts)}
        task_end: Dict[int, float] = {}
        stage_end: Dict[str, float] = {}

        def run_task(t: Task):
            yield AllOf([file_ready[f] for f in t.inputs])
            # runtime dispatch: fixed client, locality choice, or least-loaded
            if t.client is not None:
                c = t.client
            else:
                c = None
                if locality_aware and t.inputs:
                    hosts = set()
                    for f in t.inputs:
                        loc = self.mgr.files.get(f)
                        h = loc.single_host() if loc else None
                        if h is None:
                            hosts = set()
                            break
                        hosts.add(h)
                    if len(hosts) == 1:
                        c = host_to_client.get(hosts.pop())
                if c is None:
                    c = min(range(cfg.n_clients),
                            key=lambda k: (client_free[k].in_use + client_free[k].backlog, k))
            yield Acquire(client_free[c])
            chost = cfg.client_hosts[c]
            yield Timeout(float(self.rng.uniform(0.0, self.p.stagger)))  # launch stagger
            reads = [env.process(self.read_file(chost, f)) for f in t.inputs]
            if reads:
                yield AllOf([r.done for r in reads])
            if t.runtime > 0:
                yield Acquire(self.hosts[chost].cpu)
                yield Timeout(self._jit(t.runtime * self.slow.get(chost, 1.0)))
                self.hosts[chost].cpu.release()
            writes = [env.process(self.write_file(chost, n, sz, t.file_attrs.get(n)))
                      for n, sz in t.outputs]
            if writes:
                yield AllOf([w.done for w in writes])
            for n, _ in t.outputs:
                file_ready[n].fire()
            client_free[c].release()
            task_end[t.tid] = env.now
            stage_end[t.stage] = max(stage_end.get(t.stage, 0.0), env.now)

        for t in wf.tasks:
            env.process(run_task(t))
        makespan = env.run()
        return RunReport(makespan=makespan, bytes_moved=self.bytes_moved,
                         storage_used=self.mgr.storage_used(),
                         per_task_end=task_end, per_stage_end=stage_end,
                         n_events=env.n_events)


def run_trials(wf_factory, cfg: StorageConfig, *, params: EmulatorParams = EmulatorParams(),
               trials: int = 5, locality_aware: bool = True,
               seed: int = 0) -> Tuple[float, float, List[RunReport]]:
    """Paper methodology: several actual runs, report mean and stddev."""
    reports = []
    for k in range(trials):
        emu = Emulator(cfg, params, seed=seed + 1000 * k)
        reports.append(emu.run_workflow(wf_factory(), locality_aware=locality_aware))
    times = np.array([r.makespan for r in reports])
    return float(times.mean()), float(times.std()), reports
