"""``chip_smoke.py``'s ``cost.solve`` phase rehearsed on the CPU: fig14's
grid (four topologies x the six scenarios x two levels) through the port's
search with the torch backend on the CPU in place of the card, held to the
NumPy backend, at 8 of deepseek-v3's 61 layers and one Pareto size; and
its gate fails when the torch backend's grids drift."""
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
CUT = dict(device="cpu", layers=8, sizes=(64,))


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    return chip_smoke


def test_chip_smoke_cost_phase_rehearses_on_cpu(chip_smoke):
    from repro_torch.core import sweep

    res = chip_smoke.cost_solve_phase(torch, "cpu", **CUT)
    assert res["equal_to_numpy"] and res["points"] == 48 and res["layers"] == 8
    assert res["of_layers"] == 61 and res["device"] == "cpu"
    assert len(res["table"]) == 6
    for row in res["table"].values():
        assert set(row) == set(chip_smoke.COST_TOPOLOGIES)
        assert all(row[t]["dbo+sd"]["tok_s_per_cost"] > 0 for t in ("torus", "fullmesh"))
    assert set(res["switchless_gain_band_pct"]) == {"torus", "fullmesh", "best_switchless"}
    assert res["pareto"]["points"] == 20 and res["pareto"]["frontier"]
    assert res["quickstart"]["ok"] and res["quickstart"]["rc"] == 0
    assert sweep._DEFAULT_DEVICE == "cuda"       # the phase restores the default


def test_chip_smoke_cost_phase_fails_when_the_grids_drift(chip_smoke, monkeypatch):
    """The torch backend's no-overlap times half as large again: its
    operating points leave NumPy's, and the phase fails."""
    from repro_torch.core import sweep_torch
    seq = sweep_torch.TorchGridEngine.seq_components

    def drifting(self, q, half=False):
        tc, tm = seq(self, q, half)
        return tc * 1.5, tm * 1.5

    monkeypatch.setattr(sweep_torch.TorchGridEngine, "seq_components", drifting)
    with pytest.raises(AssertionError, match="cost.solve: .* differences"):
        chip_smoke.cost_solve_phase(torch, "cpu", quickstart=False, **CUT)


def test_fields_equal(chip_smoke):
    """Integers and flags exactly, floats within ``COST_RTOL`` relative."""
    from repro_torch.core.optimizer import OperatingPoint

    def point(batch=8, tpot=0.04, dbo=True):
        return OperatingPoint(batch, tpot, 200.0, dbo, False, 0.001, 0.03, 0.01)

    def fails(got, want):
        out = []
        chip_smoke.fields_equal(got, want, "x", out)
        return out

    assert fails([point(), None], [point(), None]) == []
    assert fails(point(tpot=0.04 * (1 + 1e-12)), point()) == []
    for other in (point(tpot=0.04 * (1 + 1e-8)), point(batch=16), point(dbo=False), None):
        assert fails(other, point()), other
