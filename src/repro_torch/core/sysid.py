"""System identification (§2.5): seed the model from end-to-end
measurements only — no probes inside the storage system.

Procedure (faithful to the paper, automated here against the emulator the
way the paper's scripts run against a real deployment):

 1. iperf-style throughput measurement, remote and loopback
    -> ``net_remote``, ``net_local``; a tiny-message echo -> ``net_latency``.
 2. 0-size read ops (touch the manager, not the storage module)
    -> manager service time; the client time is set to 0 and its cost
    folded into the manager (paper's choice: "associate the whole cost of
    0-size operations to the manager").
 3. timed file writes at two chunk sizes, repeated until the 95% CI is
    within ±5% of the mean (Jain's procedure [25]);
    T_sm = T_tot - T_net - T_man, then a 2x2 solve separates the
    per-byte rate (mu_sm) from the per-chunk RPC cost.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, List, Optional, Tuple, Union

import numpy as np

from .emulator import Emulator, EmulatorParams
from .types import CTRL_BYTES, MB, ServiceTimes, partitioned_config


def params_digest(params: EmulatorParams) -> str:
    """Content digest of the emulated system a report was identified
    against. A persisted report is only valid for the exact system it
    probed — any parameter change (different NIC rate, HDD mode, jitter)
    invalidates it, the way a re-imaged cluster invalidates measured
    service times."""
    blob = json.dumps(dataclasses.asdict(params), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _timed(emu: Emulator, gen_factory: Callable[[], object]) -> float:
    start = emu.env.now
    proc = emu.env.process(gen_factory())
    emu.env.run()
    return emu.env.now - start


def _mean_ci(samples: List[float], conf: float = 1.96) -> Tuple[float, float]:
    a = np.asarray(samples)
    if len(a) < 2:
        return float(a.mean()), float("inf")
    half = conf * a.std(ddof=1) / np.sqrt(len(a))
    return float(a.mean()), float(half)


def _measure_until_ci(run_one: Callable[[int], float], *, rel: float = 0.05,
                      min_runs: int = 5, max_runs: int = 60) -> float:
    """Jain's stopping rule: sample until the 95% CI is within ±rel of the mean."""
    samples: List[float] = []
    k = 0
    while True:
        samples.append(run_one(k))
        k += 1
        if k >= min_runs:
            mean, half = _mean_ci(samples)
            if half <= rel * mean or k >= max_runs:
                return mean


@dataclass
class SysIdReport:
    service_times: ServiceTimes
    n_measurements: int
    details: dict
    digest: str = ""               # params_digest() of the probed system
    probe: dict = dataclasses.field(default_factory=dict)
                                   # identification settings (seed, probe
                                   # sizes) the measurements were taken with

    # -- persistence: identified ServiceTimes
    # are expensive (dozens of emulator runs under Jain's stopping rule)
    # and deterministic per (params, seed) — benchmark and CI processes
    # should load them instead of re-probing from scratch.
    def save(self, path: Union[str, Path]) -> None:
        """Write the report as JSON, tagged with the system digest."""
        payload = {
            "version": 1,
            "digest": self.digest,
            "probe": self.probe,
            "service_times": dataclasses.asdict(self.service_times),
            "n_measurements": self.n_measurements,
            "details": self.details,
        }
        Path(path).write_text(json.dumps(payload, indent=2, sort_keys=True))

    @classmethod
    def load(cls, path: Union[str, Path], *,
             params: Optional[EmulatorParams] = None) -> "SysIdReport":
        """Read a persisted report. When ``params`` is given, the stored
        digest must match the digest of that system — a stale report
        (identified against different hardware) raises ValueError rather
        than silently seeding the predictor with wrong service times."""
        payload = json.loads(Path(path).read_text())
        digest = payload.get("digest", "")
        if params is not None and digest != params_digest(params):
            raise ValueError(
                f"stale sysid report {path}: identified against system "
                f"{digest or '<unknown>'}, requested {params_digest(params)}")
        return cls(service_times=ServiceTimes(**payload["service_times"]),
                   n_measurements=int(payload["n_measurements"]),
                   details=dict(payload.get("details", {})),
                   digest=digest,
                   probe=dict(payload.get("probe", {})))


def identify(params: EmulatorParams = EmulatorParams(), *, seed: int = 7,
             probe_mb: int = 32, file_mb: int = 16,
             cache_path: Union[str, Path, None] = None) -> SysIdReport:
    """Run the identification benchmarks on a 3-node deployment
    (manager + 1 storage + 1 client on distinct machines, as in §2.5).

    ``cache_path`` warm-starts across processes: a fresh report for the
    same emulated system (matching `params_digest`) *and* the same
    identification settings (seed, probe sizes) is loaded instead of
    re-probing; a missing or stale file triggers a probe and rewrites
    the cache.
    """
    probe = {"seed": seed, "probe_mb": probe_mb, "file_mb": file_mb}
    if cache_path is not None and Path(cache_path).exists():
        try:
            cached = SysIdReport.load(cache_path, params=params)
            if cached.probe == probe:
                return cached
        except ValueError:
            pass                   # stale digest: re-probe below
    details: dict = {}
    n_meas = 0

    def fresh(k: int) -> Emulator:
        cfg = partitioned_config(n_app=1, n_storage=1)
        return Emulator(cfg, params, seed=seed + 17 * k)

    # -- 1a. remote network throughput (iperf) -------------------------------------
    nbytes = probe_mb * MB
    def remote_probe(k: int) -> float:
        emu = fresh(k)
        t = _timed(emu, lambda: emu.transfer(1, 2, nbytes))
        return t
    t_remote = _measure_until_ci(remote_probe)
    net_remote = t_remote / nbytes
    n_meas += 5

    # -- 1b. loopback throughput ----------------------------------------------------
    def local_probe(k: int) -> float:
        emu = fresh(k)
        return _timed(emu, lambda: emu.transfer(1, 1, nbytes))
    t_local = _measure_until_ci(local_probe)
    net_local = t_local / nbytes
    n_meas += 5

    # -- 1c. latency: tiny message, subtract the serialization part -----------------
    def lat_probe(k: int) -> float:
        emu = fresh(k)
        emu.connected.add((1, 2))      # measure past connection setup, like ping
        return _timed(emu, lambda: emu.transfer(1, 2, 64))
    t_tiny = _measure_until_ci(lat_probe)
    net_latency = max(t_tiny - 64 * net_remote, 1e-9)
    n_meas += 5

    # -- 2. 0-size reads isolate the manager ----------------------------------------
    # model cost of a 0-size read: 2 ctrl transfers (there and back) + 1
    # manager request; each remote ctrl hop costs CTRL*(out+in rates)/1 + lag
    def zero_probe(k: int) -> float:
        emu = fresh(k)
        emu.mgr.place("z", 0, 2, None)
        emu.connected.update({(2, 0), (0, 2)})
        return _timed(emu, lambda: emu.read_file(2, "z"))
    t_zero = _measure_until_ci(zero_probe)
    ctrl_net = 2 * (2 * CTRL_BYTES * net_remote + net_latency)
    manager = max(t_zero - ctrl_net, 1e-6)
    n_meas += 5

    # -- 3. timed *local* writes at two chunk sizes separate mu_sm from the
    # per-chunk RPC cost. Remote writes pipeline chunks behind the NIC, which
    # hides the storage service entirely on RAMdisk-class nodes (our
    # adaptation of §2.5: collocate the probe client with the storage node so
    # the loopback, not the NIC, is the transport floor).
    from .types import collocated_config
    size = file_mb * MB

    def write_time(chunk: int) -> float:
        def one(k: int) -> float:
            cfg = collocated_config(2, chunk_size=chunk)
            emu = Emulator(cfg, params, seed=seed + 31 * k)
            emu.connected.update({(1, 0), (0, 1)})
            return _timed(emu, lambda: emu.write_file(1, f"f{chunk}", size, None))
        return _measure_until_ci(one)

    chunk_a, chunk_b = 256 * 1024, 4 * MB
    t_a, t_b = write_time(chunk_a), write_time(chunk_b)
    n_meas += 10

    def t_storage_total(t_tot: float, chunk: int) -> float:
        # modeled non-storage parts of a local write: one tail chunk on the
        # loopback (the rest pipelines behind storage) + 2 manager round-trips
        t_net = chunk * net_local
        t_man = 2 * manager + 2 * (2 * CTRL_BYTES * net_remote + net_latency)
        return max(t_tot - t_net - t_man, 1e-9)

    n_a, n_b = -(-size // chunk_a), -(-size // chunk_b)
    s_a, s_b = t_storage_total(t_a, chunk_a), t_storage_total(t_b, chunk_b)
    #   s(chunk) = n_chunks * storage_req + size * mu_sm   -> 2x2 solve
    denom = (n_a - n_b)
    storage_req = max((s_a - s_b) / denom, 0.0) if denom else 0.0
    mu_sm = max((s_a - n_a * storage_req) / size, 1e-12)

    st = ServiceTimes(net_remote=net_remote, net_local=net_local,
                      net_latency=net_latency, storage=mu_sm, manager=manager,
                      client=0.0, storage_req=storage_req)
    details.update(t_remote=t_remote, t_local=t_local, t_tiny=t_tiny,
                   t_zero=t_zero, t_write_small_chunk=t_a, t_write_big_chunk=t_b)
    report = SysIdReport(service_times=st, n_measurements=n_meas,
                         details=details, digest=params_digest(params),
                         probe=probe)
    if cache_path is not None:
        report.save(cache_path)
    return report
