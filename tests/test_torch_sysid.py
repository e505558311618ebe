"""The port's system identification (`repro_torch.core.sysid`, on its
`emulator` and `des` kernel) against the reference's.

`identify` at the reference test's probe settings (``probe_mb=8,
file_mb=8``, seed 7) must give the same `ServiceTimes`, field for field
and to the bit (the probes are the same seeded Python DES runs), the
same measurement count and details, and the same `params_digest`. The
emulator's `RunReport` on a small workflow must equal the reference's.
The persistence contract of `tests/test_sysid_search.py` is restated on
the port: JSON round trip, stale-digest rejection, and the three
``cache_path`` cases (warm hit, other probe settings, other system).
"""
import dataclasses

import pytest

from repro.core import sysid as J
from repro.core import workloads as JW
from repro.core.emulator import Emulator as JEmulator
from repro.core.emulator import EmulatorParams as JParams
from repro.core.types import collocated_config as j_collocated

import repro_torch.core as T
from repro_torch.core import sysid as P
from repro_torch.core import workloads as TW
from repro_torch.core.emulator import Emulator, EmulatorParams, run_trials


@pytest.fixture(scope="module")
def pair():
    return (J.identify(probe_mb=8, file_mb=8),
            P.identify(probe_mb=8, file_mb=8))


def test_identify_equals_reference(pair):
    jrep, prep = pair
    assert dataclasses.asdict(prep.service_times) == \
        dataclasses.asdict(jrep.service_times)
    assert prep.n_measurements == jrep.n_measurements
    assert prep.details == jrep.details
    assert prep.probe == jrep.probe == {"seed": 7, "probe_mb": 8, "file_mb": 8}
    assert prep.digest == jrep.digest == P.params_digest(EmulatorParams())
    assert P.params_digest(EmulatorParams()) == J.params_digest(JParams())
    # the reference's floor on the identified latency is kept
    assert prep.service_times.net_latency >= 1e-9


def test_params_digest_tracks_every_parameter():
    base = P.params_digest(EmulatorParams())
    for f in dataclasses.fields(EmulatorParams):
        v = getattr(EmulatorParams(), f.name)
        other = (not v) if isinstance(v, bool) else v * 2 + 1
        kw = {f.name: other}
        assert P.params_digest(EmulatorParams(**kw)) != base, f.name
        assert P.params_digest(EmulatorParams(**kw)) == \
            J.params_digest(JParams(**kw)), f.name


@pytest.mark.parametrize("locality_aware", [True, False])
def test_emulator_run_report_equals_reference(locality_aware):
    cfg = T.collocated_config(6, chunk_size=512 * 1024)
    jcfg = j_collocated(6, chunk_size=512 * 1024)
    wf = TW.pipeline(5, stage_mb=(24, 48, 24, 1))
    jwf = JW.pipeline(5, stage_mb=(24, 48, 24, 1))
    rep = Emulator(cfg, EmulatorParams(), seed=3).run_workflow(
        wf, locality_aware=locality_aware)
    jrep = JEmulator(jcfg, JParams(), seed=3).run_workflow(
        jwf, locality_aware=locality_aware)
    assert dataclasses.asdict(rep) == dataclasses.asdict(jrep)
    assert rep.makespan > 0 and rep.n_events > 0


def test_run_trials_and_hdd_faulted_emulator_equal_reference():
    from repro.core.emulator import run_trials as j_run_trials
    from repro.core import parse_faults as j_parse
    params = EmulatorParams(hdd=True)
    cfg = T.collocated_config(5, chunk_size=1 << 20,
                              faults=T.parse_faults("disk=0:4,slow=0:2"))
    jcfg = j_collocated(5, chunk_size=1 << 20,
                        faults=j_parse("disk=0:4,slow=0:2"))
    mean, std, reps = run_trials(lambda: TW.reduce_(4, in_mb=4, mid_mb=4,
                                                    out_mb=8),
                                 cfg, params=params, trials=2)
    jmean, jstd, jreps = j_run_trials(lambda: JW.reduce_(4, in_mb=4, mid_mb=4,
                                                         out_mb=8),
                                      jcfg, params=JParams(hdd=True),
                                      trials=2)
    assert (mean, std) == (jmean, jstd)
    assert [r.makespan for r in reps] == [r.makespan for r in jreps]


# ---------------- persistence (tests/test_sysid_search.py, restated) ---------------

def test_sysid_report_roundtrips_through_json(pair, tmp_path):
    identified = pair[1]
    path = tmp_path / "sysid.json"
    identified.save(path)
    loaded = P.SysIdReport.load(path, params=EmulatorParams())
    assert loaded.service_times == identified.service_times
    assert loaded.n_measurements == identified.n_measurements
    assert loaded.details == pytest.approx(identified.details)
    assert loaded.digest == identified.digest
    assert loaded.probe == identified.probe
    # a report saved by either package loads in the other
    jpath = tmp_path / "ref.json"
    pair[0].save(jpath)
    assert P.SysIdReport.load(jpath).service_times == identified.service_times
    assert J.SysIdReport.load(path).digest == identified.digest


def test_sysid_load_rejects_stale_digest(pair, tmp_path):
    identified = pair[1]
    path = tmp_path / "sysid.json"
    identified.save(path)
    other = EmulatorParams(nic_bps=10 * T.MB)      # "re-imaged" system
    with pytest.raises(ValueError, match="stale sysid report"):
        P.SysIdReport.load(path, params=other)
    assert P.SysIdReport.load(path).service_times == identified.service_times


def test_identify_cache_path_skips_reprobe(pair, tmp_path, monkeypatch):
    identified = pair[1]
    path = tmp_path / "sysid.json"
    identified.save(path)
    monkeypatch.setattr(P, "Emulator",
                        lambda *a, **k: pytest.fail("re-probed warm cache"))
    warm = P.identify(probe_mb=8, file_mb=8, cache_path=path)
    assert warm.service_times == identified.service_times


def test_identify_cache_path_reprobes_on_different_probe_settings(
        pair, tmp_path):
    path = tmp_path / "sysid.json"
    pair[1].save(path)
    fresh = P.identify(probe_mb=4, file_mb=4, cache_path=path)
    assert fresh.probe == {"seed": 7, "probe_mb": 4, "file_mb": 4}
    assert P.SysIdReport.load(path).probe == fresh.probe  # cache rewritten
    jfresh = J.identify(probe_mb=4, file_mb=4)
    assert dataclasses.asdict(fresh.service_times) == \
        dataclasses.asdict(jfresh.service_times)


def test_identify_cache_path_reprobes_on_stale_digest(pair, tmp_path):
    identified = pair[1]
    path = tmp_path / "sysid.json"
    identified.save(path)
    other = EmulatorParams(nic_bps=40 * T.MB)
    fresh = P.identify(other, probe_mb=4, file_mb=4, cache_path=path)
    assert fresh.digest == P.params_digest(other)
    assert P.SysIdReport.load(path, params=other).digest == fresh.digest
    assert fresh.service_times.net_remote > identified.service_times.net_remote


def test_session_takes_a_report_or_its_path(pair, tmp_path):
    """`SweepSession(sysid=...)` takes the port's `SysIdReport` or a
    saved report's path, and its service times become the default for
    a sweep: the same makespans as passing them explicitly."""
    identified = pair[1]
    path = tmp_path / "sysid.json"
    identified.save(path)
    wfs = [TW.pipeline(3)]
    cfgs = [T.collocated_config(5)]
    with T.SweepSession(sysid=identified, device="cpu") as a, \
            T.SweepSession(sysid=str(path), device="cpu") as b, \
            T.SweepSession(device="cpu") as c:
        assert isinstance(b.sysid, P.SysIdReport)
        va = a.simulate_batch(wfs, cfgs)
        vb = b.simulate_batch(wfs, cfgs)
        vc = c.simulate_batch(wfs, cfgs, st=identified.service_times)
    assert list(va) == list(vb) == list(vc)
    with pytest.raises(TypeError):
        T.SweepSession(sysid=object(), device="cpu")
