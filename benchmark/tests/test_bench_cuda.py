"""The card's side of the comparison and of the trace, at 64^3: each
cell's program agrees with its reference and the control fails it, every
per-layer metric of the cell reads a number from the trace, and a step
that returns its state unchanged reads ``correct`` false.  Marked
``cuda``: they skip where there is no card (run them on the card with
``python -m pytest -m cuda benchmark/tests``)."""

import pytest

from bench_helpers import WORKLOADS, correct, over_limits, run

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.parametrize("workload", WORKLOADS)
def test_card_agrees_control_fails_and_trace_reads(workload, card):
    cell, out = run(workload, 2 ** 32 + 5, device=card, n=64, trace=True,
                    control=True)
    assert correct(out), out["checks"]
    assert over_limits(out["control"], out), out["control"]
    got = {m["name"]: cell.metric_reader(m["name"]).read(out)
           for m in cell.per_layer}
    assert all(v is not None for v in got.values()), got
    assert 0.0 < got["negdiv_sweep_roofline"] <= 105.0
    assert out["trace"].busy_s() > 0.0


def test_card_unchanged_state_reads_incorrect(card, monkeypatch):
    from athenapk_tpu_torch.solver.hydro_pkg import HydroPackage

    def unchanged(self, u, dt, c_h, t=0.0, emit_dt=False):
        return u.clone()
    monkeypatch.setattr(HydroPackage, "step", unchanged)
    _, out = run(WORKLOADS[0], 9, device=card, n=64)
    assert not correct(out)
