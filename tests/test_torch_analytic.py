"""The port's analytic roofline counts (`repro_torch.launch.analytic`)
against the reference's (`repro.launch.analytic`): equal to the bit for
every architecture x shape cell, helper by helper; and the counter that
stands for XLA's cost analysis (`OpCounter`), against
`torch.utils.flop_counter.FlopCounterMode` and the closed form."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as JC
from repro.launch import analytic as J

from repro_torch import configs as TC
from repro_torch.launch import analytic as T
from repro_torch.models import forward, init

CELLS = [(a, s.name) for a in sorted(JC.ARCHS)
         for s in JC.cells(JC.get(a))]


def pair(arch, shape):
    js = {s.name: s for s in JC.ALL_SHAPES}[shape]
    ts = {s.name: s for s in TC.ALL_SHAPES}[shape]
    return JC.get(arch), js, TC.get(arch), ts


@pytest.mark.parametrize("arch,shape", CELLS)
def test_counts_equal_reference_to_the_bit(arch, shape):
    ja, js, ta, ts = pair(arch, shape)
    B, S = js.global_batch, js.seq_len
    assert T.cell_flops(ta, ts) == J.cell_flops(ja, js)
    assert T.cell_flops(ta, ts, remat=False) == J.cell_flops(ja, js,
                                                             remat=False)
    assert T.cell_bytes(ta, ts) == J.cell_bytes(ja, js)
    assert T.model_flops(ta, ts) == J.model_flops(ja, js)
    assert T.forward_flops(ta, B, S) == J.forward_flops(ja, B, S)
    assert T.forward_flops(ta, B, 1, decode=True, ctx=S) == \
        J.forward_flops(ja, B, 1, decode=True, ctx=S)
    assert T._attn_flops(ta, B, S, S, causal=True) == \
        J._attn_flops(ja, B, S, S, causal=True)
    assert T._attn_decode_flops(ta, B, S) == J._attn_decode_flops(ja, B, S)
    assert T._ffn_flops(ta, B, S) == J._ffn_flops(ja, B, S)
    if ta.ssm_state:
        assert T._ssd_flops(ta, B, S) == J._ssd_flops(ja, B, S)
        assert T._ssd_decode_flops(ta, B) == J._ssd_decode_flops(ja, B)


def _reduced_forward():
    cfg = TC.get("granite-3-2b").reduced()
    params = init(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks = torch.zeros((2, 64), dtype=torch.long)
    return cfg, (lambda: forward(params, toks, cfg, remat=False))


def test_analytic_flops_match_flop_counter_on_small_dense():
    """Closed-form forward FLOPs against `FlopCounterMode` on the reduced
    dense model, with the reference's guard against XLA's count (its
    `tests/test_dryrun_smoke.py`): the same order, within 2x."""
    cfg, run = _reduced_forward()
    with FlopCounterMode(display=False) as fc:
        run()
    counted = float(fc.get_total_flops())
    ours = T.forward_flops(cfg, 2, 64)
    assert ours == pytest.approx(counted, rel=1.0), (ours, counted)
    assert ours > 0.3 * counted


def test_op_counter_counts_what_flop_counter_counts():
    """`cost_analysis_dict`'s FLOPs are `FlopCounterMode`'s formulas over
    the same ops; its bytes are every non-view op's inputs and outputs."""
    _cfg, run = _reduced_forward()
    with FlopCounterMode(display=False) as fc:
        run()
    cost = T.cost_analysis_dict(run)
    assert cost["flops"] == float(fc.get_total_flops()) > 0
    assert cost["bytes accessed"] > 0

    a, b = torch.ones(4, 8), torch.ones(8, 3)
    cost = T.cost_analysis_dict(lambda: (a @ b).reshape(12))
    assert cost == {"flops": 2.0 * 4 * 8 * 3,
                    "bytes accessed": 4.0 * (32 + 24 + 12)}
