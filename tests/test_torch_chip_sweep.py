"""``chip_smoke.py``'s ``sweep.torch_grid`` phase rehearsed on the CPU: the
whole product grid (>= 10^6 TPOT cells) at 2 of deepseek-v3's 61 layers,
the engine on the CPU in place of the card, then the block held to a second
run on the CPU; and its gate fails when the two runs disagree."""
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
CUT = dict(device="cpu", layers=2)


@pytest.fixture
def chip_smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    return chip_smoke


def test_chip_smoke_sweep_phase_rehearses_on_cpu(chip_smoke):
    res = chip_smoke.sweep_grid_phase(torch, "cpu", **CUT)
    assert res["cells"] >= 10 ** 6 and res["layers"] == 2 and res["device"] == "cpu"
    assert res["tpot_monotone_in_link_bw"] and res["cells_per_s"] > 0
    assert set(res["block_gates"]) == {"uniform", "uniform_dbo", "zipf", "zipf_dbo"}
    for gate in res["block_gates"].values():
        assert gate["max_rel"] == 0.0 and gate["cells"] > 0


def test_chip_smoke_sweep_phase_fails_when_the_runs_disagree(chip_smoke, monkeypatch):
    """Each TPOT grid 1e-5 relative above the one before: the block's two
    runs differ by more than ``GRID_RTOL``, and the phase fails."""
    from repro_torch.core import sweep_torch
    tpot, calls = sweep_torch.TorchGridEngine.tpot, []

    def drifting(self, **kw):
        calls.append(1)
        return tpot(self, **kw) * (1.0 + 1e-5 * len(calls))

    monkeypatch.setattr(sweep_torch.TorchGridEngine, "tpot", drifting)
    with pytest.raises(AssertionError, match="card and CPU differ"):
        chip_smoke.sweep_grid_phase(torch, "cpu", **CUT)
