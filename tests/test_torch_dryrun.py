"""The port's dry run (``repro_torch.launch.dryrun``) and roofline
(``repro_torch.analysis.roofline``).

The dry run traces one rank of a mesh in one process, under a fake process
group and fake CUDA tensors; it runs in a subprocess here, so that the fake
group never meets this process. Its collective bytes and calls per kind
must equal those of the same steps run for real on four gloo ranks on the
CPU, counted by the same rule; its FLOPs on a 1x1 mesh must equal
``FlopCounterMode`` over the real step on the CPU (the plain kernel
versions there, the custom ops' formulas in the trace); and no fake trace
may reach a plain kernel version. The configs' shape cells and the
roofline's model FLOPs are held to the JAX package's. A train cell needs a
build of torch with CUDA (``tests/test_torch_cuda_dryrun.py``)."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro.analysis.roofline as jroof  # noqa: E402
import repro.configs as jcfgs  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.analysis import roofline as troof  # noqa: E402
from repro_torch.launch import serve, steps  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
TESTS = ROOT / "tests"
sys.path.insert(0, str(TESTS))
import torch_dryrun_workers as W  # noqa: E402

CELLS = {
    "decode": {"arch": "olmoe-1b-7b", "reduced": True, "shape": ["d", 64, 8, "decode"],
               "mesh": [2, 2]},
    "prefill": {"arch": "olmoe-1b-7b", "reduced": True, "shape": ["p", 16, 8, "prefill"],
                "mesh": [2, 2]},
}
# the decode cell with replicated attention in place of head-TP (``run_cell``'s
# plan_overrides, as JAX's)
CELLS["decode_replicated"] = dict(CELLS["decode"], plan_overrides={"attn_mode": "replicated"})
ONE = {k: dict(CELLS[k], mesh=[1, 1]) for k in ("decode", "prefill")}


def env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(TESTS)]))


def run_dry(cells):
    r = subprocess.run([sys.executable, str(TESTS / "torch_dryrun_workers.py"),
                        json.dumps(cells)], env=env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def dry():
    """Every cell's record, the 1x1 cells', and the decode cell's again
    (``decode_again``: a second trace in the same process)."""
    names = list(CELLS) + [f"{k}_1x1" for k in ONE] + ["decode_again"]
    recs = run_dry(list(CELLS.values()) + list(ONE.values()) + [CELLS["decode"]])
    return dict(zip(names, recs))


@pytest.fixture(scope="module")
def real_counts():
    out = serve.spawn(W.real_step_counts, (list(CELLS.values()),), mesh_shape=(2, 2),
                      transport="gloo", device="cpu", timeout=300)
    return {name: [rank[i] for rank in out] for i, name in enumerate(CELLS)}


@pytest.mark.parametrize("kind", list(CELLS))
def test_fake_mesh_collectives_equal_a_gloo_run(dry, real_counts, kind):
    """Bytes and calls per kind of what rank 0 sends, on a fake (2, 2) mesh
    and on four real gloo ranks."""
    rec = dry[kind]
    real = real_counts[kind][0]
    assert real, "the real step ran no collective"
    want = {}
    for k, c in real.items():
        want[f"{k}_bytes"] = c["bytes"]
        want[f"{k}_count"] = c["calls"]
    want["total_bytes"] = sum(c["bytes"] for c in real.values())
    assert rec["collectives"] == want
    assert rec["n_devices"] == 4 and rec["mesh"] == [2, 2]


def test_plan_overrides_reach_the_traced_step(dry):
    """``plan_overrides`` replaces fields of the cell's plan: replicated
    attention gathers no query heads, so the decode step runs no all-gather
    (its counts equal the gloo run of the same plan, above)."""
    rec, base = dry["decode_replicated"], dry["decode"]
    assert base["plan"]["attn_mode"] == "head_tp"
    assert rec["plan"] == dict(base["plan"], attn_mode="replicated")
    assert "all_gather_bytes" in base["collectives"]
    assert "all_gather_bytes" not in rec["collectives"]


KEYS_THAT_REPEAT = ("flops", "flops_by_op", "bytes_accessed", "mem_argument_size_in_bytes",
                    "mem_output_size_in_bytes", "mem_temp_size_in_bytes", "collectives")


@pytest.mark.parametrize("where", ["same_process", "new_process"])
def test_two_traces_of_one_cell_agree(dry, where):
    """The counts of a cell do not depend on what ran before it: a second
    trace in the same process, and one in a new process, give the same
    bytes, memory, FLOPs and collectives."""
    again = dry["decode_again"] if where == "same_process" else run_dry([CELLS["decode"]])[0]
    assert {k: again[k] for k in KEYS_THAT_REPEAT} == \
        {k: dry["decode"][k] for k in KEYS_THAT_REPEAT}


def _traffic_cases():
    """(name, the op as a function of fake CPU tensors, the bytes it moves)."""
    n = lambda t: t.numel() * t.element_size()          # noqa: E731

    def setitem(t):
        t["cache"][t["rows"], 5] = t["v"]

    def where(t):
        return torch.where(t["a"] > 0, t["a"], 0.0)

    return [
        # a product: its inputs and its output
        ("mm", lambda t: t["a"] @ t["b"], lambda t: n(t["a"]) + n(t["b"]) + 4 * 16 * 4),
        # a batched product folds to mm; the _unsafe_view back is a view
        ("matmul_3d", lambda t: t["x3"] @ t["b"],
         lambda t: n(t["x3"]) + n(t["b"]) + 2 * 4 * 16 * 4),
        # gt (a in, the mask out), and where (the mask, a and a 0-d scalar
        # in, a's shape out); the prim::device reads between them are
        # metadata and move nothing
        ("where", where, lambda t: 3 * n(t["a"]) + 2 * n(t["a"] > 0) + 4),
        # a gather of 3 rows out of a [8, 64, 32] cache: the indices, and
        # the rows read and written
        ("gather", lambda t: t["cache"][t["rows"], 5], lambda t: n(t["rows"]) + 2 * n(t["v"])),
        # the write of the same rows: the indices, the values read and written
        ("setitem", setitem, lambda t: n(t["rows"]) + 2 * n(t["v"])),
        # an add into 3 rows also reads them
        ("index_add", lambda t: t["a"].index_add_(0, t["rows"], t["src"]),
         lambda t: n(t["rows"]) + 3 * n(t["src"])),
        ("device", lambda t: t["a"].device, lambda t: 0),
    ]


@pytest.mark.parametrize("case", _traffic_cases(), ids=lambda c: c[0])
def test_traffic_charges_what_each_op_moves(case):
    """``bytes_accessed``'s rule, op by op, on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.dryrun import _Traffic
    _, op, want = case
    with FakeTensorMode():
        t = {"a": torch.empty(4, 8), "b": torch.empty(8, 16), "x3": torch.empty(2, 4, 8),
             "cache": torch.empty(8, 64, 32), "rows": torch.zeros(3, dtype=torch.int64),
             "v": torch.empty(3, 32), "src": torch.empty(3, 8)}
        traffic = _Traffic()
        with traffic:
            op(t)
        assert traffic.bytes == want(t)


def test_to_the_card_a_tensor_is_on_copies_nothing():
    """On a build without CUDA the dry run runs ``Tensor.to`` itself: to
    "cuda" or "cuda:0" in its dtype a fake tensor on the card is returned
    as it is, as torch's own ``to`` does, and moves no byte; a new dtype
    is one copy."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.dryrun import _FakeCardBindings, _Traffic
    with FakeTensorMode():
        x = torch.empty(4, dtype=torch.int64, device="cuda")
        traffic = _Traffic()
        with traffic, _FakeCardBindings():
            same = [x.to("cuda"), x.to(device="cuda:0", dtype=torch.int64),
                    x.to(torch.device("cuda"))]
            moved = traffic.bytes
            y = x.to(device="cuda", dtype=torch.int32)
    assert all(t is x for t in same) and moved == 0
    assert y.dtype == torch.int32 and traffic.bytes == 4 * 8 + 4 * 4


@pytest.mark.parametrize("kind", list(ONE))
def test_one_device_flops_equal_the_real_step(dry, kind):
    """FLOPs of the trace (the kernels' custom ops) equal FlopCounterMode
    over the real CPU step (their plain versions)."""
    cell = ONE[kind]
    cfg, shape = W.cell_config(cell), W.cell_shape(cell)
    mesh = Mesh((1, 1), W.AXES)
    step, plan = steps.build_cell(cfg, shape, mesh, transport="gloo")
    args = W.step_args(step, cfg, shape, plan, mesh)
    with FlopCounterMode(display=False) as fc:
        step(*args)
    rec = dry[f"{kind}_1x1"]
    assert rec["flops"] == fc.get_total_flops() > 0
    assert rec["collectives"] == {"total_bytes": 0}


def test_trace_counts_the_kernels_as_custom_ops(dry):
    """The trace went through the kernels' custom ops (the plain versions
    raise in the dry run's process), and its record has JAX's keys."""
    dec, pre = dry["decode"]["flops_by_op"], dry["prefill"]["flops_by_op"]
    assert dec["repro_torch.moe_gmm"] > 0 and dec["repro_torch.flash_decode_lse"] > 0
    assert pre["repro_torch.moe_gmm"] > 0
    for rec in dry.values():
        for key in ("flops", "bytes_accessed", "bytes_accessed_inplace",
                    "dus_overcount_bytes", "mem_argument_size_in_bytes",
                    "mem_output_size_in_bytes", "mem_temp_size_in_bytes", "collectives",
                    "plan", "axes", "mesh", "n_devices", "trace_s"):
            assert key in rec, key
        assert rec["bytes_accessed"] > 0 and rec["mem_temp_size_in_bytes"] > 0
        parts = rec["mem_argument_parts"]
        assert rec["mem_argument_size_in_bytes"] == sum(parts.values())


def test_decode_arguments_are_the_ranks_params_and_caches(dry):
    """The decode record's argument bytes: the rank's shards of the weights
    and of the caches at capacity, and its tokens."""
    from repro_torch.convert import tree_leaves
    from repro_torch.models import model as M
    cell = CELLS["decode"]
    cfg, shape = W.cell_config(cell), W.cell_shape(cell)
    mesh = Mesh((2, 2), W.AXES)          # rank 0, without a process group
    step, plan = steps.build_cell(cfg, shape, mesh, transport="gloo")
    params = steps.init_params(cfg, plan, mesh, device="cpu")
    want = sum(x.numel() * x.element_size() for x in tree_leaves(params))
    caches = M.init_cache(cfg, plan, batch=8, seq=64, device="cpu", mesh=mesh)
    parts = dry["decode"]["mem_argument_parts"]
    assert parts["params"] == want
    assert parts["caches"] == sum(x.numel() * x.element_size() for x in tree_leaves(caches))
    assert parts["inputs"] == 4 * 1 * 8       # [B / data, 1] int64


def test_cli_writes_only_where_asked(tmp_path):
    """One production cell through the CLI (16x16), written to --out; a
    cell that fails is recorded with its error, not dropped; nothing lands
    at the repository's root."""
    before = set(ROOT.glob("results_dryrun*"))
    out = tmp_path / "dry.json"
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                        "olmoe-1b-7b", "--shape", "decode_32k", "--out", str(out)],
                       env=env(), capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "ok" and rec["n_devices"] == 256
    assert rec["collectives"]["dispatch_count"] == 16            # one per MoE layer
    bad = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "no-such-arch", "--shape", "decode_32k", "--out", str(out)],
                         env=env(), capture_output=True, text=True, timeout=300,
                         cwd=tmp_path)
    assert bad.returncode == 1
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "error" and "KeyError" in rec["error"]
    assert set(ROOT.glob("results_dryrun*")) == before


def test_skipped_cell_has_jax_reason():
    from repro_torch.launch.dryrun import run_cell
    rec = run_cell("starcoder2-3b", "long_500k")
    ok, why = jcfgs.cell_applicable(jcfgs.get_arch("starcoder2-3b"), jcfgs.SHAPES["long_500k"])
    assert rec == {"arch": "starcoder2-3b", "shape": "long_500k", "status": "skipped",
                   "reason": why} and not ok


# ---------------------------------------------------------------------------
# configs and roofline against the JAX package
# ---------------------------------------------------------------------------

def test_shape_cells_equal_jax():
    assert tcfgs.ASSIGNED_ARCHS == jcfgs.ASSIGNED_ARCHS
    assert {k: (v.name, v.seq_len, v.global_batch, v.kind, v.is_decode)
            for k, v in tcfgs.SHAPES.items()} == \
        {k: (v.name, v.seq_len, v.global_batch, v.kind, v.is_decode)
         for k, v in jcfgs.SHAPES.items()}
    for arch in jcfgs.ARCHS:
        for s in jcfgs.SHAPES:
            assert tcfgs.cell_applicable(tcfgs.get_arch(arch), tcfgs.SHAPES[s]) == \
                jcfgs.cell_applicable(jcfgs.get_arch(arch), jcfgs.SHAPES[s]), (arch, s)


@pytest.mark.parametrize("arch", sorted(jcfgs.ARCHS))
def test_model_flops_equal_jax(arch):
    for s in jcfgs.SHAPES:
        for n in (256, 512):
            assert troof.model_flops_per_device(arch, s, n) == \
                jroof.model_flops_per_device(arch, s, n)


def test_roofline_terms_rescale_to_jax(dry):
    """One record through both rooflines: each term times its package's
    constant is the same count (FLOPs, bytes, collective bytes)."""
    rec = dict(dry["decode"], arch="olmoe-1b-7b", shape="decode_32k", status="ok")
    t, j = troof.from_dryrun(rec), jroof.from_dryrun(rec)
    assert t.compute_s * troof.PEAK_FLOPS == pytest.approx(j.compute_s * jroof.PEAK_FLOPS,
                                                           rel=1e-12)
    assert t.memory_s * troof.HBM_BW == pytest.approx(j.memory_s * jroof.HBM_BW, rel=1e-12)
    assert t.collective_s * troof.LINK_BW == pytest.approx(
        j.collective_s * jroof.LINK_BW, rel=1e-12)
    assert t.model_flops_per_dev == j.model_flops_per_dev
    assert t.bottleneck in ("compute", "memory", "collective")
    assert troof.what_would_help(t)
    assert troof.from_dryrun({"status": "error"}) is None
