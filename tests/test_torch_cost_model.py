"""The port's copy of the cost model's search and selection
(``repro_torch.core``: sweep, optimizer, api, tco, availability, pareto,
future, traffic, and ``repro_torch.faults.sample_faultset``) against
``repro.core`` on the CPU.

Each case builds the same configs, clusters and scenarios in both packages
from the same names and runs the reference with its NumPy backend, the
port with its torch backend on ``device="cpu"``, and the port again with
its own NumPy backend. Results are compared through ``dataclasses.asdict``
(the two packages' dataclasses are different classes).

Tolerance: every field is equal. Integers, flags and strings exactly;
floats within 1e-9 relative (``RTOL``). The search re-derives each winner
through the scalar path, so equal argmaxes give bitwise equal points.

Sizes: deepseek-v3 cut to 8 layers on 64 XPUs (the ``dsv3_small`` of
``tests/test_torch_sweep.py``), olmoe-1b-7b on 8 XPUs with traces of a
few seconds for the traffic simulator.
"""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro import faults as r_faults  # noqa: E402
from repro.configs import get_arch as r_get_arch  # noqa: E402
from repro.core import availability as r_av  # noqa: E402
from repro.core import future as r_future  # noqa: E402
from repro.core import pareto as r_pareto  # noqa: E402
from repro.core import traffic as r_traffic  # noqa: E402
from repro_torch import faults as p_faults  # noqa: E402
from repro_torch.configs import get_arch as p_get_arch  # noqa: E402
from repro_torch.core import availability as p_av  # noqa: E402
from repro_torch.core import future as p_future  # noqa: E402
from repro_torch.core import pareto as p_pareto  # noqa: E402
from repro_torch.core import sweep as p_sweep  # noqa: E402
from repro_torch.core import sweep_torch  # noqa: E402
from repro_torch.core import traffic as p_traffic  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-9
N = 64
PORT_BACKENDS = ("torch", "numpy")


@pytest.fixture(scope="module", autouse=True)
def grids_on_the_cpu():
    """The torch backend evaluates on the CPU for this module only."""
    prev = p_sweep.set_default_device("cpu")
    yield
    p_sweep.set_default_device(prev)


def same(got, want, path="result"):
    """Field-by-field equality of two results from the two packages."""
    if dataclasses.is_dataclass(want) and not isinstance(want, type):
        assert dataclasses.is_dataclass(got), path
        assert type(got).__name__ == type(want).__name__, path
        got, want = dataclasses.asdict(got), dataclasses.asdict(want)
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.shape == want.shape, path
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=0.0,
                                       err_msg=path)
        else:
            assert np.array_equal(got, want), path
    elif isinstance(want, (bool, np.bool_)) or want is None \
            or isinstance(want, str):
        assert got == want, (path, got, want)
    elif isinstance(want, (int, np.integer)):
        assert got == want and not isinstance(got, float), (path, got, want)
    elif isinstance(want, (float, np.floating)):
        if math.isnan(want):
            assert math.isnan(got), path
        elif math.isinf(want) or want == 0.0:
            assert got == want, (path, got, want)
        else:
            assert abs(got - want) <= RTOL * abs(want), (path, got, want)
    else:
        assert got == want, (path, got, want)


def cfgs(arch="deepseek-v3", layers=8):
    r, p = r_get_arch(arch), p_get_arch(arch)
    if layers is not None:
        r, p = r.replace(num_layers=layers), p.replace(num_layers=layers)
    return r, p


def clusters(topo, n=N, **kw):
    return (R.make_cluster(topo, n, R.H100, **kw),
            P.make_cluster(topo, n, P.H100, **kw))


def scenarios(*args, **kw):
    return R.Scenario(*args, **kw), P.Scenario(*args, **kw)


def held(call_ref, call_port):
    """Run the reference on NumPy and the port on each of its backends;
    every port result equals the reference's."""
    want = call_ref()
    for backend in PORT_BACKENDS:
        prev = p_sweep.set_default_backend(backend)
        try:
            got = call_port()
        finally:
            p_sweep.set_default_backend(prev)
        same(got, want, f"[{backend}]")
    return want


def solution(sol):
    """A `Solution` as plain fields (its spec is not compared: the two
    packages' specs differ only in class)."""
    return dict(kind=sol.kind, point=sol.point, plan=sol.plan,
                throughput=sol.throughput)


# ---------------------------------------------------------------------------
# solve: every topology and level, prefill modes, degraded, placement, tp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("level", ("noopt", "dbo", "dbo+sd"))
@pytest.mark.parametrize("topo", R.TOPOLOGIES)
def test_solve_decode(topo, level):
    (rc, pc), (rl, pl), (rs, ps) = cfgs(), clusters(topo), scenarios(40.0, 512)
    want = held(lambda: solution(R.solve(rc, rl, rs, R.SearchSpec(opts=level))),
                lambda: solution(P.solve(pc, pl, ps, P.SearchSpec(opts=level))))
    assert want["point"] is not None


def test_solve_levels_grid():
    """One `solve_levels` over the four topologies, two scenarios and the
    three levels (the chip phase's call, at 8 layers)."""
    rc, pc = cfgs()
    rcl = [R.make_cluster(t, N, R.H100) for t in R.TOPOLOGIES]
    pcl = [P.make_cluster(t, N, P.H100) for t in P.TOPOLOGIES]
    rsc = [R.Scenario(15.0, 4096), R.Scenario(100.0, 512)]
    psc = [P.Scenario(15.0, 4096), P.Scenario(100.0, 512)]

    def grid(api, c, cl, sc):
        out = api.solve_levels(c, cl, sc)
        return {lvl: [[solution(s) for s in row] for row in rows]
                for lvl, rows in out.items()}

    held(lambda: grid(R.api, rc, rcl, rsc), lambda: grid(P.api, pc, pcl, psc))


@pytest.mark.parametrize("mode", ("chunked", "disagg"))
def test_solve_prefill_modes(mode):
    (rc, pc), (rl, pl) = cfgs(), clusters("scale-up")
    rs, ps = scenarios(40.0, 4096, prompt_len=2048, ttft_ms=2000.0)
    want = held(
        lambda: solution(R.solve(rc, rl, rs, R.SearchSpec(mode=mode, tp=2, dbo=True))),
        lambda: solution(P.solve(pc, pl, ps, P.SearchSpec(mode=mode, tp=2, dbo=True))))
    assert want["kind"] == "prefill" and want["point"] is not None


def test_solve_degraded():
    (rc, pc), (rl, pl), (rs, ps) = cfgs(), clusters("torus"), scenarios(40.0, 4096)
    fs = dict(mesh_links=(2, 1, 0), xpus=1)
    want = held(
        lambda: solution(R.solve(rc, rl, rs, R.SearchSpec(faults=R.FaultSet(**fs),
                                                          dbo=True))),
        lambda: solution(P.solve(pc, pl, ps, P.SearchSpec(faults=P.FaultSet(**fs),
                                                          dbo=True))))
    assert want["kind"] == "degraded" and want["plan"] is not None


def test_solve_placement_under_zipf():
    (rc, pc), (rl, pl) = cfgs(), clusters("fullmesh")
    rs, ps = scenarios(40.0, 4096, routing="zipf", zipf_s=1.0)
    want = held(
        lambda: solution(R.solve(rc, rl, rs, R.SearchSpec(dbo=True, placement="auto"))),
        lambda: solution(P.solve(pc, pl, ps, P.SearchSpec(dbo=True, placement="auto"))))
    assert want["point"] is not None


def test_solve_tp_auto():
    (rc, pc), (rl, pl), (rs, ps) = cfgs(), clusters("torus"), scenarios(40.0, 512)
    held(lambda: solution(R.solve(rc, rl, rs, R.SearchSpec(tp="auto", dbo=True))),
         lambda: solution(P.solve(pc, pl, ps, P.SearchSpec(tp="auto", dbo=True))))


def test_tpot_curve_of_a_solved_point():
    (rc, pc), (rl, pl), (rs, ps) = cfgs(), clusters("fullmesh"), scenarios(40.0, 512)
    pt_r = R.solve(rc, rl, rs, R.SearchSpec(opts="dbo+sd")).point
    pt_p = P.solve(pc, pl, ps, P.SearchSpec(opts="dbo+sd", backend="numpy")).point
    same(pt_p, pt_r)
    batches = [1, 16, 256, pt_r.batch, 4096]
    held(lambda: R.api.tpot_curve(rc, rl, rs, batches, point=pt_r),
         lambda: P.api.tpot_curve(pc, pl, ps, batches, point=pt_p))


def test_deprecated_shims_warn_with_the_ports_class():
    """The legacy wrappers warn with the port's own
    `ReproDeprecationWarning` and return the reference's point."""
    (rc, pc), (rl, pl), (rs, ps) = cfgs(), clusters("torus"), scenarios(40.0, 512)
    with pytest.warns(R.ReproDeprecationWarning):
        want = R.optimizer.best_of_opts(rl, rc, rs, opts="dbo")
    with pytest.warns(P.ReproDeprecationWarning, match="repro_torch.core.api.solve"):
        got = P.optimizer.best_of_opts(pl, pc, ps, opts="dbo")
    same(got, want)
    assert P.ReproDeprecationWarning is not R.ReproDeprecationWarning


# ---------------------------------------------------------------------------
# tco, faults, availability
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topo", R.TOPOLOGIES)
def test_cluster_tco_and_throughput_per_cost(topo):
    rl, pl = clusters(topo)
    same(P.cluster_tco(pl), R.cluster_tco(rl))
    same(P.cluster_tco(pl).per_xpu(N, 2.0), R.cluster_tco(rl).per_xpu(N, 2.0))
    for thr in (1.0, 123456.789):
        same(P.throughput_per_cost(thr, pl), R.throughput_per_cost(thr, rl))


@pytest.mark.parametrize("topo", R.TOPOLOGIES)
def test_sample_faultset(topo):
    rl, pl = clusters(topo)
    for seed in range(4):
        same(p_faults.sample_faultset(pl, exposure_h=5000.0, seed=seed),
             r_faults.sample_faultset(rl, exposure_h=5000.0, seed=seed))
    with pytest.raises(ValueError):
        p_faults.sample_faultset(pl, exposure_h=-1.0)


def test_build_availability():
    (rc, pc), (rl, pl), (rs, ps) = cfgs(), clusters("fullmesh"), scenarios(40.0, 512)
    want_m = R.build_availability(rl, rc, rs, max_total_faults=1)
    for backend in PORT_BACKENDS:
        prev = p_sweep.set_default_backend(backend)
        try:
            got_m = P.build_availability(pl, pc, ps, max_total_faults=1)
        finally:
            p_sweep.set_default_backend(prev)
        same(got_m.healthy_throughput, want_m.healthy_throughput)
        same(got_m.classes, want_m.classes)
        same(got_m.states, want_m.states)
        for scale in (0.1, 1.0, 10.0):
            same(got_m.report(scale), want_m.report(scale))
        same(P.availability_adjusted_throughput_per_cost(pl, None, None, model=got_m),
             R.availability_adjusted_throughput_per_cost(rl, None, None, model=want_m))
    same(p_av.component_inventory(pl), r_av.component_inventory(rl))


# ---------------------------------------------------------------------------
# pareto, future
# ---------------------------------------------------------------------------

def test_sweep_networks_and_frontier():
    (rc, pc), (rs, ps) = cfgs(), scenarios(40.0, 512)
    kw = dict(sizes=(64,), bw_fracs=(1 / 3, 1.0))
    want = held(lambda: r_pareto.sweep_networks(rc, rs, R.H100, **kw),
                lambda: p_pareto.sweep_networks(pc, ps, P.H100, **kw))
    assert len(want) == 8
    same(p_pareto.pareto_frontier(p_pareto.sweep_networks(pc, ps, P.H100, **kw)),
         r_pareto.pareto_frontier(want))


def test_throughput_vs_bandwidth_and_generation_report():
    (rc, pc), (rs, ps) = cfgs(), scenarios(40.0, 512)
    grid = [100e9, 450e9, 900e9]
    for alpha in (1.0, 0.0):
        want = held(
            lambda: r_future.throughput_vs_bandwidth(rc, rs, R.BLACKWELL, "fullmesh",
                                                     N, grid, alpha_scale=alpha),
            lambda: p_future.throughput_vs_bandwidth(pc, ps, P.BLACKWELL, "fullmesh",
                                                     N, grid, alpha_scale=alpha))
        same(p_future.saturating_bandwidth(
            p_future.throughput_vs_bandwidth(pc, ps, P.BLACKWELL, "fullmesh", N,
                                             grid, alpha_scale=alpha)),
             r_future.saturating_bandwidth(want))
    held(lambda: r_future.generation_report(rc, rs, "Rubin", n=N),
         lambda: p_future.generation_report(pc, ps, "Rubin", n=N))


# ---------------------------------------------------------------------------
# traffic
# ---------------------------------------------------------------------------

MIX = ((0.75, 0, 256), (0.25, 384, 512))


@pytest.fixture(scope="module")
def catalogs():
    """olmoe-1b-7b on 8 torus XPUs (tests/test_traffic.py's cell) with two
    pool sizes, from each package and each of the port's backends."""
    (rc, pc), (rl, pl) = cfgs("olmoe-1b-7b", None), clusters("torus", 8)
    rs, ps = scenarios(15.0, 512, ttft_ms=500.0)
    kw = dict(pool_fracs=(0.5, 1.0), mix=MIX)
    out = {"ref": r_traffic.build_catalog(rc, rl, rs, R.SearchSpec(), **kw)}
    for backend in PORT_BACKENDS:
        out[backend] = p_traffic.build_catalog(pc, pl, ps,
                                               P.SearchSpec(backend=backend), **kw)
    return out


def traces(cap, load, horizon=8.0, seed=7, **kw):
    spec = dict(horizon_s=horizon, rate_rps=cap * load, length_mix=MIX,
                seed=seed, **kw)
    return (r_traffic.generate_trace(r_traffic.TraceSpec(**spec)),
            p_traffic.generate_trace(p_traffic.TraceSpec(**spec)))


def cap_rps(catalogs):
    ref = catalogs["ref"]
    return ref.capacity_rps(ref.full, r_traffic.TraceSpec(1.0, 1.0,
                                                          length_mix=MIX).mean_gen)


def test_catalog_and_trace(catalogs):
    ref = catalogs["ref"]
    for backend in PORT_BACKENDS:
        got = catalogs[backend]
        assert len(got.entries) == len(ref.entries) == 2
        for g, w in zip(got.entries, ref.entries):
            same(g.point, w.point, backend)
            same(g.tpot, w.tpot, backend)
            same((g.chunk_time, g.domains, g.n_xpus),
                 (w.chunk_time, w.domains, w.n_xpus), backend)
    cap = cap_rps(catalogs)
    same(catalogs["torch"].capacity_rps(catalogs["torch"].full,
                                        p_traffic.TraceSpec(1.0, 1.0,
                                                            length_mix=MIX).mean_gen),
         cap)
    rt, pt = traces(cap, 0.8, arrival="gamma", cv2=4.0, diurnal_amplitude=0.3,
                    diurnal_period_s=4.0)
    same(dataclasses.asdict(pt), dataclasses.asdict(rt))
    assert rt.n > 10


def test_simulate_trace(catalogs):
    cap = cap_rps(catalogs)
    rt, pt = traces(cap, 0.9, arrival="gamma", cv2=4.0)
    want = r_traffic.simulate_trace(catalogs["ref"], rt).as_dict()
    for backend in PORT_BACKENDS:
        same(p_traffic.simulate_trace(catalogs[backend], pt).as_dict(), want)


def test_simulate_trace_with_faults_and_autoscale(catalogs):
    cap = cap_rps(catalogs)
    rt, pt = traces(cap, 0.8)
    rl, pl = clusters("torus", 8)
    kw = dict(rate_per_iter=2e-3, seed=2, repair_s=2.0, downtime_s=0.5)
    r_plan = r_traffic.seeded_fault_plan(
        rl, n_iters=catalogs["ref"].est_iterations(rt), **kw)
    p_plan = p_traffic.seeded_fault_plan(
        pl, n_iters=catalogs["torch"].est_iterations(pt), **kw)
    same(p_plan, r_plan)
    assert len(r_plan.faultsets) >= 1
    pol = dict(check_interval_s=1.0, min_dwell_s=2.0, switch_downtime_s=0.5)
    want = r_traffic.simulate_trace(catalogs["ref"], rt, faults=r_plan,
                                    autoscale=r_traffic.AutoscalePolicy(**pol))
    for backend in PORT_BACKENDS:
        got = p_traffic.simulate_trace(catalogs[backend], pt, faults=p_plan,
                                       autoscale=p_traffic.AutoscalePolicy(**pol))
        same(got.as_dict(), want.as_dict())
    assert want.n_fault_events >= 1


def test_best_provisioning(catalogs):
    cap = cap_rps(catalogs)
    rt, pt = traces(cap, 0.4, horizon=12.0, diurnal_amplitude=0.6,
                    diurnal_period_s=6.0, seed=13)
    pol = dict(check_interval_s=1.0, target_util=0.7, min_dwell_s=2.0,
               switch_downtime_s=0.5)
    name_r, want = r_traffic.best_provisioning(
        catalogs["ref"], rt, policies=[None, r_traffic.AutoscalePolicy(**pol)])
    for backend in PORT_BACKENDS:
        name_p, got = p_traffic.best_provisioning(
            catalogs[backend], pt, policies=[None, p_traffic.AutoscalePolicy(**pol)])
        assert name_p == name_r
        same(got.as_dict(), want.as_dict())
    rl, pl = clusters("torus", 8)
    same(p_traffic.fleet_cost(pl, 0.5), r_traffic.fleet_cost(rl, 0.5))


# ---------------------------------------------------------------------------
# the backend seam: torch by default, on the card, no fallback
# ---------------------------------------------------------------------------

def test_backends_and_default():
    assert p_sweep.BACKENDS == ("numpy", "torch")
    assert p_sweep._DEFAULT_BACKEND == "torch"
    (rc, pc), (rl, pl), (rs, ps) = cfgs(), clusters("torus"), scenarios(40.0, 512)
    with pytest.raises(ValueError, match="unknown sweep backend"):
        P.solve(pc, pl, ps, P.SearchSpec(backend="jax"))
    with pytest.raises(ValueError, match="unknown sweep backend"):
        p_sweep.set_default_backend("jax")
    assert p_sweep._DEFAULT_BACKEND == "torch"


def test_torch_backend_reaches_the_engine():
    """backend="torch" evaluates through `TorchGridEngine` on the default
    device; the NumPy durations are never built."""
    rc, pc = cfgs()
    table = P.optable.op_table(pc, 2, 32, N, "fp8")
    ev = p_sweep.GridEval(table, [P.make_cluster("torus", N, P.H100)],
                          [P.Scenario(25.0, 512)], np.array([1, 64, 512]))
    assert ev.backend == "torch"
    ev.tpot(dbo=True)
    assert isinstance(ev._engine, sweep_torch.TorchGridEngine)
    assert ev._engine.device.type == "cpu"
    assert ev._dur == {}


def test_default_backend_refuses_without_a_card(monkeypatch):
    """With no CUDA device, the default (torch on the card) raises before
    any grid is evaluated; nothing runs on NumPy or the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(p_sweep, "_DEFAULT_DEVICE", "cuda")
    ran = []
    monkeypatch.setattr(p_sweep.GridEval, "_durations",
                        lambda self, *a: ran.append(a))
    (rc, pc), (rl, pl), (rs, ps) = cfgs(), clusters("torus"), scenarios(40.0, 512)
    for call in (lambda: P.solve(pc, pl, ps),
                 lambda: P.solve(pc, pl, ps, P.SearchSpec(opts="dbo+sd")),
                 lambda: P.solve_levels(pc, [pl], [ps]),
                 lambda: p_pareto.sweep_networks(pc, ps, P.H100, sizes=(64,))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert ran == []


def test_no_environment_variable_moves_the_default():
    """A `REPRO_SWEEP_BACKEND` left in the shell changes nothing."""
    code = ("from repro_torch.core import sweep\n"
            "assert sweep._DEFAULT_BACKEND == 'torch', sweep._DEFAULT_BACKEND\n"
            "assert sweep._DEFAULT_DEVICE == 'cuda', sweep._DEFAULT_DEVICE\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_SWEEP_BACKEND="numpy")
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    src = (ROOT / "src" / "repro_torch" / "core" / "sweep.py").read_text()
    assert "REPRO_SWEEP_BACKEND" not in src and "os.environ" not in src


def test_exports_match_the_reference():
    """`repro_torch.core` exports every public name of `repro.core`."""
    want = {n for n in dir(R) if not n.startswith("_")} - {"sweep_jax"}
    missing = sorted(n for n in want if not hasattr(P, n))
    assert missing == []
    assert P.optimizer.Scenario is P.scenario.Scenario is P.Scenario
