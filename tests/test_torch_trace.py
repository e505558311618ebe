"""The port's trace front-end (`repro_torch.core.trace`) against the
reference's (`repro.core.trace`).

The same trace files and the same `GenSpec` + seed go through both
packages: the resulting `Workflow.fingerprint()`s must be equal (the
fingerprint digests every task, file size, client rank, stage and
placement hint, so equal fingerprints mean the port compiles the same
DAG). Malformed inputs must raise `TraceError` in the port exactly where
`tests/test_trace.py` expects the reference to. And the shipped
fixtures' scan-vs-exact golden pin (`FIXTURE_SCAN_EXACT_RTOL`) holds on
the port's simulator, on the CPU.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.core import trace as J

import repro_torch.core as T
from repro_torch.core import trace as P
from repro_torch.core.trace import dax, wfcommons

# the CPU paths step through tiny tensors one op at a time, where
# PyTorch's intra-op thread pool costs more than it gives
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TRACES = ROOT / "examples" / "traces"
FIXTURES = ["montage_small.json", "blast_small.json", "cycles_small.dax"]
# the reference's golden bound (tests/test_trace.py), held here on the
# port's scan and exact modes
FIXTURE_SCAN_EXACT_RTOL = 0.015
MB = T.MB


@pytest.mark.parametrize("clients", [None, 3])
@pytest.mark.parametrize("fixture", FIXTURES)
def test_fixture_fingerprints_equal(fixture, clients):
    jtw, ptw = J.load_trace(TRACES / fixture), P.load_trace(TRACES / fixture)
    assert ptw.name == jtw.name and ptw.n_tasks == jtw.n_tasks
    assert ptw.levels() == jtw.levels()
    assert ptw.total_bytes() == jtw.total_bytes()
    jwf = J.to_workflow(jtw, clients=clients)
    pwf = P.to_workflow(ptw, clients=clients)
    assert pwf.fingerprint() == jwf.fingerprint()
    assert [t.stage for t in pwf.tasks] == [t.stage for t in jwf.tasks]


@pytest.mark.parametrize("family", J.FAMILIES)
def test_generated_family_fingerprints_equal(family):
    assert P.FAMILIES == J.FAMILIES
    jspec = J.GenSpec(family=family, depth=3, width=5, mean_mb=4, sigma=0.6,
                      zipf_a=1.6, runtime_s=0.5)
    pspec = P.GenSpec(family=family, depth=3, width=5, mean_mb=4, sigma=0.6,
                      zipf_a=1.6, runtime_s=0.5)
    jfam = J.generate_family(jspec, 4, seed=11, n_structures=2)
    pfam = P.generate_family(pspec, 4, seed=11, n_structures=2)
    assert [t.name for t in pfam] == [t.name for t in jfam]
    for jtw, ptw in zip(jfam, pfam):
        assert P.to_workflow(ptw, clients=2).fingerprint() == \
            J.to_workflow(jtw, clients=2).fingerprint()
        assert ptw.file_sizes == jtw.file_sizes
    # one workflow alone, the generator's other entry point
    assert P.to_workflow(P.generate_workflow(pspec, seed=7)).fingerprint() \
        == J.to_workflow(J.generate_workflow(jspec, seed=7)).fingerprint()


def test_generator_fingerprint_in_a_process_without_jax():
    """The port's generator alone, in a fresh interpreter that never
    imports `jax` or `repro`, under another hash seed: the same
    fingerprint as the reference's here."""
    spec = J.GenSpec(family="straggler", depth=2, width=4, mean_mb=4,
                     sigma=0.7, runtime_s=1.0)
    want = J.to_workflow(J.generate_workflow(spec, seed=21),
                         clients=3).fingerprint()
    prog = (
        "import sys\n"
        "from repro_torch.core.trace import GenSpec, generate_workflow, "
        "to_workflow\n"
        "spec = GenSpec(family='straggler', depth=2, width=4, mean_mb=4,\n"
        "               sigma=0.7, runtime_s=1.0)\n"
        "print(to_workflow(generate_workflow(spec, seed=21), clients=3)"
        ".fingerprint())\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'repro')]\n")
    import os
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "PYTHONHASHSEED": "12345"}
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, check=True, env=env, timeout=120)
    assert out.stdout.strip() == want


# ---------------- the same malformed inputs as tests/test_trace.py ----------------

def diamond(M):
    return M.TraceWorkflow(
        name="diamond",
        tasks=[
            M.TraceTask("a", category="prep", inputs=("in",), outputs=("x",)),
            M.TraceTask("b", inputs=("x",), outputs=("y1",)),
            M.TraceTask("c", inputs=("x",), outputs=("y2",)),
            M.TraceTask("d", category="join", inputs=("y1", "y2"),
                        outputs=("out",)),
        ],
        file_sizes={"in": 2 * MB, "x": MB, "y1": MB, "y2": MB, "out": MB})


def _cycle(M):
    tw = diamond(M)
    tw.edges.append(("d", "a"))
    M.to_workflow(tw)


def _no_producer(M):
    tw = diamond(M)
    tw.tasks.append(M.TraceTask("e", inputs=("nowhere",), outputs=()))
    tw.validate()


def _written_twice(M):
    tw = diamond(M)
    tw.tasks.append(M.TraceTask("e", inputs=(), outputs=("x",)))
    tw.validate()


def _no_size(M):
    tw = diamond(M)
    del tw.file_sizes["out"]
    M.to_workflow(tw)


def _in_place(M):
    tw = diamond(M)
    tw.tasks.append(M.TraceTask("e", inputs=("z",), outputs=("z",)))
    tw.file_sizes["z"] = MB
    tw.validate()


def _no_tasks(M):
    M.wfcommons.loads("{}")


def _unknown_link(M):
    M.wfcommons.loads(json.dumps({"workflow": {"tasks": [
        {"id": "t", "files": [{"name": "f", "link": "sideways"}]}]}}))


def _malformed_dax(M):
    M.dax.loads("<adag><job")


def _empty_dax(M):
    M.dax.loads("<adag name='empty'></adag>")


def _bad_family(M):
    M.generate_workflow(M.GenSpec(family="nope"))


def _bad_depth(M):
    M.generate_workflow(M.GenSpec(depth=0))


def _bad_mean(M):
    M.generate_workflow(M.GenSpec(mean_mb=-1))


def _bad_structures(M):
    M.generate_family(M.GenSpec(), 4, n_structures=5)


MALFORMED = [(_cycle, "cycle"), (_no_producer, "no producer"),
             (_written_twice, "written by both"), (_no_size, "no size"),
             (_in_place, "in-place"), (_no_tasks, "tasks"),
             (_unknown_link, "unknown link"), (_malformed_dax, "malformed"),
             (_empty_dax, "no <job>"), (_bad_family, "family"),
             (_bad_depth, "depth/width"), (_bad_mean, "mean_mb"),
             (_bad_structures, "n_structures")]


@pytest.mark.parametrize("make,match", MALFORMED,
                         ids=[m.__name__.strip("_") for m, _ in MALFORMED])
def test_trace_error_on_the_same_malformed_inputs(make, match):
    for M in (J, P):
        with pytest.raises(M.TraceError, match=match):
            make(M)
    assert issubclass(P.TraceError, ValueError)


def test_load_trace_unknown_extension(tmp_path):
    p = tmp_path / "trace.yaml"
    p.write_text("x: 1")
    with pytest.raises(P.TraceError, match="extension"):
        P.load_trace(p)


def test_ir_structure_matches_reference():
    """Leveling, client ranks, control edges and hints on the reference's
    diamond, compared structure for structure."""
    jtw, ptw = diamond(J), diamond(P)
    for tw in (jtw, ptw):
        tw.edges.append(("a", "d"))               # control-only edge
        assert tw.levels() == {"a": 0, "b": 1, "c": 1, "d": 2}
    ptw.hints["x"] = T.FileAttr(placement=T.Placement.BROADCAST,
                                replication=2)
    from repro.core import FileAttr, Placement
    jtw.hints["x"] = FileAttr(placement=Placement.BROADCAST, replication=2)
    jwf, pwf = J.to_workflow(jtw, clients=2), P.to_workflow(ptw, clients=2)
    assert pwf.fingerprint() == jwf.fingerprint()
    assert [t.client for t in pwf.tasks] == [0, 1, 0, 1]
    assert ("__ctrl__a", 0) in pwf.tasks[0].outputs
    assert pwf.tasks[0].file_attrs["x"].placement == T.Placement.BROADCAST


def test_wfcommons_split_layout_and_zero_ids():
    doc = {"name": "split", "workflow": {
        "specification": {"tasks": [
            {"id": 0, "files": [
                {"link": "input", "name": "i", "size": MB},
                {"link": "output", "name": "o", "size": MB}]},
            {"id": 1, "parents": [0], "files": [
                {"link": "input", "name": "o"},
                {"link": "output", "name": "p", "size": MB}]}]},
        "execution": {"tasks": [{"id": 0, "runtimeInSeconds": 2.5},
                                {"id": 1, "machine": "m"}]}}}
    text = json.dumps(doc)
    ptw, jtw = wfcommons.loads(text), J.wfcommons.loads(text)
    assert [t.tid for t in ptw.tasks] == ["0", "1"]
    assert [t.runtime for t in ptw.tasks] == [t.runtime for t in jtw.tasks]
    assert P.to_workflow(ptw).fingerprint() == \
        J.to_workflow(jtw).fingerprint()
    dax_text = (TRACES / "cycles_small.dax").read_text()
    assert P.to_workflow(dax.loads(dax_text)).fingerprint() == \
        J.to_workflow(J.dax.loads(dax_text)).fingerprint()


# ---------------- the golden scan-accuracy pin, on the port -----------------------

@pytest.mark.parametrize("fixture", FIXTURES)
def test_fixture_scan_accuracy_golden_on_the_port(fixture):
    """Scan-vs-exact relative error of the port's simulator on every
    shipped fixture stays under the reference's golden bound, and both
    modes equal the reference's (scan to the bit, exact to rtol=1e-12)."""
    from repro.core import (CompileCache as JCache, Predictor as JPredictor,
                            PAPER_RAMDISK as J_ST, grid as j_grid)
    wf = P.to_workflow(P.load_trace(TRACES / fixture))
    cfg = T.grid(n_nodes=[9], chunk_sizes=[MB],
                 partitions=[(4, 4)])[0].to_config()
    pred = T.Predictor(T.PAPER_RAMDISK, compile_cache=T.CompileCache(),
                       device="cpu")
    exact = pred.predict(wf, cfg, backend="exact").makespan
    scan = pred.predict(wf, cfg, backend="scan").makespan
    assert scan == pytest.approx(exact, rel=FIXTURE_SCAN_EXACT_RTOL), (
        f"{fixture}: scan drifted {abs(scan - exact) / exact:.2%} from exact "
        f"(golden bound {FIXTURE_SCAN_EXACT_RTOL:.1%})")
    jwf = J.to_workflow(J.load_trace(TRACES / fixture))
    jcfg = j_grid(n_nodes=[9], chunk_sizes=[MB],
                  partitions=[(4, 4)])[0].to_config()
    jpred = JPredictor(J_ST, compile_cache=JCache())
    assert scan == jpred.predict(jwf, jcfg, backend="scan").makespan
    assert exact == pytest.approx(
        jpred.predict(jwf, jcfg, backend="exact").makespan, rel=1e-12)
