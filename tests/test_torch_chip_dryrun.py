"""``chip_smoke.py``'s ``dryrun`` phase rehearsed on the CPU at a reduced
size: the bf16 job of ``sharded.olmoe-1b-7b`` served on four gloo ranks
with the counting Dist, then the phase's dry run (a spawned process) held
to rank 0's counts and argument bytes, and the production cells' roofline
rows."""
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import serve  # noqa: E402
from repro_torch.sharding import counting  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CUT = dict(reduced=True, layers=2, new_tokens=4, config={"num_heads": 4, "num_kv_heads": 2})


def test_chip_smoke_dryrun_phase_rehearses_on_cpu(monkeypatch):
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    job = chip_smoke.sharded_jobs("olmoe-1b-7b", **CUT)["bf16"]
    r0 = serve.serve([job], mesh_shape=chip_smoke.SHARDED_MESH, transport="gloo",
                     device="cpu", wrap_dist=counting.count_collectives)[0][0]
    steps_n = job["new_tokens"] - 1
    snap = r0["snapshots"]["decode"]
    row = {"collective_prefill": r0["snapshots"]["prefill"],
           "collective_bytes_per_step": {k: v["bytes"] / steps_n for k, v in snap.items()},
           "collective_calls_per_step": {k: v["calls"] / steps_n for k, v in snap.items()},
           "param_bytes": r0["param_bytes"], "cache_bytes": r0["cache_bytes"]}
    res = chip_smoke.dryrun_phase(torch, "cpu", row, **CUT)
    assert set(res["cells"]) == {"prefill", "decode"}
    assert res["cells"]["decode"]["collectives"]["dispatch_count"] == 2     # 2 MoE layers
    for arch in chip_smoke.DRYRUN_ARCHS:
        rf = res["production"][arch]
        assert rf["bottleneck"] in ("compute", "memory", "collective")
        assert rf["mesh"] == [16, 16] and rf["useful_flops_ratio"] > 0
    # a wrong count fails the phase
    bad = dict(row, param_bytes=row["param_bytes"] + 2)
    with pytest.raises(AssertionError, match="argument bytes"):
        chip_smoke.dryrun_phase(torch, "cpu", bad, **CUT)
