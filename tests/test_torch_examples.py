"""The system's entry points on the port (`repro_torch.examples`) against
the reference's scripts in ``examples/``, on the CPU.

Each case runs the port's ``main([..., "--device", "cpu"])`` and the
reference script's ``main`` (loaded from ``examples/`` by path) with the
same arguments, captures both stdouts and compares them line for line,
except the lines listed per example that name the device, a process or
a wall time (`DEVICE_OR_TIME`): those are dropped, or masked where only
a name in them differs. Where an example prints a ranking, the
structured results are compared too: the same candidates in the same
order, makespans `np.array_equal`.

Sizes are cut for the CPU the same way for both packages, by patching
the module globals both scripts look up: the scatter/gather workload at
a tenth of its megabytes, a generated family's members at width 4 and
2 MB files, Scenario II's clusters of 11, 17 and 20 nodes at 5, 7 and
9, sysid's probes at 8 MB and one emulated trial, the serving model's
compute in f32 with the reference's parameters carried over (token ids
are then equal), 52 training steps.
"""
import asyncio
import contextlib
import functools
import importlib.util
import io
import json
import re
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro import configs as j_cfgs
from repro.core import workloads as JW
from repro.models import init_decode_state as j_init_decode_state

import repro_torch.core as T
from repro_torch import configs as t_cfgs
from repro_torch.core import workloads as TW
from repro_torch.core.sweep import shutdown_pools
from repro_torch.examples import (advisor_client, advisor_server,
                                  provisioning_advisor, quickstart,
                                  serve_batch, train_e2e)
from repro_torch.models import init_decode_state as t_init_decode_state
from repro_torch.models.interop import params_from_numpy

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
TRACES = EXAMPLES / "traces"

# lines that may differ, per example: (pattern, replacement or None to
# drop the line). The port's own trailer lines name the device and wall
# seconds; the rest are the scripts' own lines with a time, a port, a
# path or process names in them.
DEVICE_OR_TIME = {
    "provisioning_advisor": [
        (r"^\[device: ", None), (r"^\[wall: ", None),
        (r"^(\[worker fleet: \d+ work items over \d+ processes) — .*$",
         r"\1"),
        (r"^\[profile: (\d+) spans -> .*$", r"[profile: \1 spans]")],
    "quickstart": [],
    # whether the second tenant is coalesced or served from the results
    # cache depends on when it arrives (the admission window): a time
    "advisor_server": [(r"^advisor listening on [\d.]+:\d+ ",
                        "advisor listening on HOST:PORT "),
                       (r" cached=\S+ group_size=\d+$", ""),
                       (r"^(selftest ok); stats: .*$", r"\1")],
    "advisor_client": [(r"  \[cached=.*$", ""),
                       (r"^\d+/\d+ answered in .*$", None)],
    "serve_batch": [(r"^generated \d+ tokens/seq; .*$", None),
                    (r"^\[device: ", None)],
    "train_e2e": [(r"^\[train\] ", None), (r"^\[device: ", None),
                  (r"^\[ckpt\] step \d+: wrote .*$", None),
                  (r"^loss .* survived\)$", None),
                  (r"^  step +\d+ loss=.*$", None)],
}


# under --backend multiproc, which worker takes which work item is the
# pool's choice: the executable-cache and disk-hit counts the workers
# roll up depend on it (in either package, run to run), the number of
# DAG compiles does not (each structural class compiles once)
MULTIPROC_COUNTS = [
    (r"^(\[sweep engine: \d+ sims in \d+ batch calls), .*$", r"\1"),
    (r"^(\[compile cache: \d+ candidates -> \d+ DAG compiles), .*$", r"\1")]


def normalized(name: str, out: str, extra=()):
    lines = []
    for ln in out.splitlines():
        for pat, rep in [*DEVICE_OR_TIME[name], *extra]:
            if re.search(pat, ln):
                ln = None if rep is None else re.sub(pat, rep, ln)
                if ln is None:
                    break
        if ln is not None:
            lines.append(ln)
    return lines


def load_reference(name: str):
    """``examples/<name>.py`` as a module of its own."""
    spec = importlib.util.spec_from_file_location(f"ref_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def captured(fn, *args) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def run_reference(monkeypatch, mod, name: str, argv) -> str:
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    return captured(mod.main)


def assert_same_output(name, ref_out, port_out, extra=()):
    want = normalized(name, ref_out, extra)
    got = normalized(name, port_out, extra)
    assert got == want, "\n".join(
        ["port vs reference, lines that differ:"]
        + [f"  {g!r}\n  {w!r}" for g, w in zip(got, want) if g != w]
        + [f"  ({len(got)} vs {len(want)} lines)"])
    assert want, ref_out


# ---------------- provisioning_advisor ---------------------------------------------

def small_advisor(monkeypatch, mod, P, W):
    """The CPU's cut for one advisor module (reference or port), and a
    recorder of every ranking `explore` / `explore_many` return. A
    generated family's members are drawn narrower and lighter."""
    def factory(kind, queries):
        assert kind == "scatter_gather"
        return lambda c: W.scatter_gather(c.n_app, in_mb=20, shard_mb=4,
                                          out_mb=1)

    def grid(**kw):
        if kw.get("n_nodes") == [11, 17, 20]:       # Scenario II's clusters
            kw["n_nodes"] = [5, 7, 9]
        return P.grid(**kw)

    rankings = []

    def recorded(fn):
        @functools.wraps(fn)
        def run(*a, **kw):
            out = fn(*a, **kw)
            groups = out if out and isinstance(out[0], list) else [out]
            for g in groups:
                rankings.append([(key(e.candidate), e.makespan, e.verified)
                                 for e in g])
            return out
        return run

    monkeypatch.setattr(mod, "GenSpec", functools.partial(
        P.trace.GenSpec, width=4, mean_mb=2.0))
    monkeypatch.setattr(mod, "workflow_factory", factory)
    monkeypatch.setattr(mod, "grid", grid)
    monkeypatch.setattr(mod, "explore", recorded(mod.explore))
    monkeypatch.setattr(mod, "explore_many", recorded(mod.explore_many))
    return rankings


def key(c):
    return (c.n_nodes, c.n_app, c.n_storage, c.chunk_size, c.stripe_width,
            c.replication, c.faults.fingerprint() if c.faults else None)


def assert_same_rankings(rj, rt):
    assert len(rj) == len(rt) > 0
    for a, b in zip(rj, rt):
        assert [x[0] for x in b] == [x[0] for x in a]
        assert [x[2] for x in b] == [x[2] for x in a]
        np.testing.assert_array_equal([x[1] for x in b], [x[1] for x in a])


ADVISOR_CASES = {
    "scatter_gather": ["--workload", "scatter_gather", "--nodes", "9"],
    "trace": ["--trace", str(TRACES / "cycles_small.dax"), "--nodes", "7"],
    "gen": ["--gen", "fan_out", "--gen-n", "3", "--nodes", "7"],
    "faults": ["--workload", "scatter_gather", "--nodes", "7",
               "--faults", "disk=0:8,kill=1@2", "--replications", "1,2"],
    "multiproc": ["--workload", "scatter_gather", "--nodes", "7",
                  "--backend", "multiproc", "--workers", "2"],
}


@pytest.mark.parametrize("case", list(ADVISOR_CASES))
def test_provisioning_advisor_matches_reference(monkeypatch, tmp_path, case):
    argv = ADVISOR_CASES[case]
    ref = load_reference("provisioning_advisor")
    rj = small_advisor(monkeypatch, ref, J, JW)
    rt = small_advisor(monkeypatch, provisioning_advisor, T, TW)
    mp = case == "multiproc"
    # the multi-process fleets warm-start from a disk cache, one each
    cache = (lambda who: ["--cache-dir", str(tmp_path / who)]) if mp \
        else (lambda who: [])
    try:
        ref_out = run_reference(monkeypatch, ref, "provisioning_advisor",
                                argv + cache("ref"))
        port_out = captured(provisioning_advisor.main,
                            [*argv, *cache("port"), "--device", "cpu"])
    finally:
        if mp:
            shutdown_pools()
    assert_same_output("provisioning_advisor", ref_out, port_out,
                       MULTIPROC_COUNTS if mp else ())
    assert_same_rankings(rj, rt)
    assert "[device: cpu; sweep_scan kernel: 0 launches" in port_out


def test_provisioning_advisor_profile(monkeypatch, tmp_path):
    """``--profile``: the port's trace file parses and holds the best
    candidate's simulated timeline; the run prints what the reference's
    prints, but that the port's span count also holds one ``compile_dag``
    span a DAG compile, which the reference does not record."""
    argv = ["--workload", "scatter_gather", "--nodes", "7"]
    ref = load_reference("provisioning_advisor")
    rj = small_advisor(monkeypatch, ref, J, JW)
    rt = small_advisor(monkeypatch, provisioning_advisor, T, TW)
    ref_out = run_reference(monkeypatch, ref, "provisioning_advisor",
                            argv + ["--profile", str(tmp_path / "j.json")])
    port_out = captured(provisioning_advisor.main,
                        [*argv, "--profile", str(tmp_path / "t.json"),
                         "--device", "cpu"])
    assert_same_output("provisioning_advisor", ref_out, port_out,
                       [(r"^\[profile: \d+ spans\]$", None)])
    assert_same_rankings(rj, rt)
    doc = json.loads((tmp_path / "t.json").read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    n_spans = [int(re.search(r"^\[profile: (\d+) spans", out, re.M).group(1))
               for out in (ref_out, port_out)]
    compiles = [e for e in events
                if e.get("ph") == "X" and e.get("name") == "compile_dag"]
    assert compiles and n_spans[1] == n_spans[0] + len(compiles)
    best = next(ln for ln in port_out.splitlines() if "best :" in ln)
    label = "best candidate: " + best.split("best : ")[1].split(" ->")[0]
    names = {e.get("args", {}).get("name") for e in events
             if e.get("ph") == "M"}
    assert label in names, sorted(n for n in names if n)
    slices = [e for e in events if e.get("ph") == "X"]
    assert len(slices) > 10


def test_provisioning_advisor_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        provisioning_advisor.main(["--workload", "scatter_gather"])


# ---------------- quickstart -------------------------------------------------------

def test_quickstart_matches_reference(monkeypatch):
    """sysid at 8 MB probes, one emulated trial a configuration."""
    ref = load_reference("quickstart")
    for mod, P in ((ref, J), (quickstart, T)):
        monkeypatch.setattr(mod, "identify",
                            functools.partial(P.identify, probe_mb=8,
                                              file_mb=8))
        monkeypatch.setattr(mod, "run_trials", _one_trial(mod.run_trials))
    ref_out = run_reference(monkeypatch, ref, "quickstart", [])
    port_out = captured(quickstart.main, ["--device", "cpu"])
    assert_same_output("quickstart", ref_out, port_out)
    assert "err" in port_out


def _one_trial(run_trials):
    def run(*a, **kw):
        kw["trials"] = 1
        return run_trials(*a, **kw)
    return run


# ---------------- advisor_server / advisor_client ----------------------------------

def test_advisor_server_selftest_matches_reference(monkeypatch):
    ref = load_reference("advisor_server")
    ref_out = run_reference(monkeypatch, ref, "advisor_server",
                            ["--selftest"])
    port_out = captured(advisor_server.main, ["--selftest", "--device",
                                              "cpu"])
    assert_same_output("advisor_server", ref_out, port_out)
    assert "selftest ok" in port_out


def test_advisor_client_against_the_ports_server():
    """The port's server on an ephemeral port; the port's client and the
    reference's client ask it the same seeded questions: every answer
    ok, the same bests, the second client's all from the results cache."""
    ref_client = load_reference("advisor_client")

    async def scenario():
        loop = asyncio.get_running_loop()
        ready = loop.create_future()
        args = advisor_server.build_parser().parse_args(
            ["--port", "0", "--device", "cpu"])
        srv = asyncio.ensure_future(advisor_server.serve(
            args, ready=lambda p: ready.set_result(p)))
        port = await ready
        cargs = advisor_client.build_parser().parse_args(
            ["--port", str(port), "--tenants", "3", "--requests", "2",
             "--device", "cpu"])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rows = await advisor_client.run(cargs)
            port_out = buf.getvalue()
            buf.truncate(0)
            buf.seek(0)
            await ref_client.main(types.SimpleNamespace(**vars(cargs)))
            ref_out = buf.getvalue()
        srv.cancel()
        with contextlib.suppress(asyncio.CancelledError):
            await srv
        return rows, port_out, ref_out

    rows, port_out, ref_out = asyncio.run(scenario())
    assert all(r["ok"] for _, _, r, _ in rows) and len(rows) == 6
    # the reference's client asks what the port's asked before it: every
    # answer comes from the server's results cache
    asked = [ln for ln in ref_out.splitlines() if ln.startswith("tenant")]
    assert len(asked) == 6 and all("[cached=True " in ln for ln in asked)
    got = sorted(normalized("advisor_client", port_out.split("advisor "
                                                             "listening")[-1]))
    want = sorted(normalized("advisor_client", ref_out))
    got = [ln for ln in got if ln.startswith("tenant")]
    want = [ln for ln in want if ln.startswith("tenant")]
    assert got == want and len(got) == 6


# ---------------- serve_batch ------------------------------------------------------

def test_serve_batch_matches_reference_with_carried_parameters(monkeypatch):
    """Compute in f32 for both, the reference's seeded parameters carried
    into the port: the same plan and the same continuation ids."""
    def f32_configs(real):
        def get(name):
            arch = real.get(name)
            return types.SimpleNamespace(
                reduced=lambda: arch.reduced().replace(dtype="float32"))
        return types.SimpleNamespace(get=get)

    ref = load_reference("serve_batch")
    carried = {}

    def ref_init(key, arch):
        p = ref.__dict__["_real_init"](key, arch)
        carried["params"] = params_from_numpy(
            jax.tree.map(np.asarray, p), device="cpu")
        return p

    ref._real_init = ref.init
    monkeypatch.setattr(ref, "cfgs", f32_configs(j_cfgs))
    monkeypatch.setattr(ref, "init", ref_init)
    monkeypatch.setattr(ref, "init_decode_state", functools.partial(
        j_init_decode_state, dtype=jnp.float32))
    monkeypatch.setattr(serve_batch, "cfgs", f32_configs(t_cfgs))
    monkeypatch.setattr(serve_batch, "init",
                        lambda gen, arch, device: carried["params"])
    monkeypatch.setattr(serve_batch, "init_decode_state", functools.partial(
        t_init_decode_state, dtype=torch.float32))
    ref_out = run_reference(monkeypatch, ref, "serve_batch", [])
    port_out = captured(serve_batch.main, ["--device", "cpu"])
    assert_same_output("serve_batch", ref_out, port_out)
    assert "sample continuation ids" in port_out
    assert "[device: cpu; sweep_scan kernel (the plan): 0 launches" in port_out


# ---------------- train_e2e --------------------------------------------------------

def test_train_e2e_matches_reference(monkeypatch):
    """52 steps, the script's checkpoint at step 50, a fault at 51 and a
    restart from that checkpoint. Loss and time lines differ between the
    packages (their own seeded initialisations); the rest, the plan among
    it, is the same."""
    ref = load_reference("train_e2e")
    argv = ["--steps", "52", "--fail-at", "51"]
    ref_out = run_reference(monkeypatch, ref, "train_e2e", argv)
    port_out = captured(train_e2e.main, [*argv, "--device", "cpu"])
    assert_same_output("train_e2e", ref_out, port_out)
    assert "[fault] injected failure at step 51; restarting" in port_out
    assert "[device: cpu]" in port_out


# ---------------- the entry points leave the reference out ------------------------

def test_entry_points_import_neither_jax_nor_repro():
    """Each example module, `core.x64` and `core.search` import in a
    process that never imports ``jax`` or ``repro``."""
    import os
    import subprocess
    root = Path(__file__).resolve().parents[1]
    code = ("import sys\n"
            "import repro_torch.core.x64, repro_torch.core.search\n"
            "import repro_torch.examples.provisioning_advisor\n"
            "import repro_torch.examples.quickstart\n"
            "import repro_torch.examples.advisor_server\n"
            "import repro_torch.examples.advisor_client\n"
            "import repro_torch.examples.serve_batch\n"
            "import repro_torch.examples.train_e2e\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=root, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(root / "src")})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"
