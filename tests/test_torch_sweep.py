"""The port's grid engine (``repro_torch.core.sweep_torch``) against the
NumPy ``GridEval`` of the reference, and the port's copies of the cost
model against ``repro.core``.

The JAX engine (``repro.core.sweep_jax``) does not import under this jax
(no ``jax.experimental.enable_x64``), so the port is held to the NumPy
engine, the reference of ``docs/sweep_engine.md``, at the JAX engine's bar
of 1e-6 relative, on the cases of ``tests/test_sweep_jax.py`` (deepseek-v3
at 8 layers on 64 devices). The search entry points of ``repro.core.sweep``
admit only the backends "numpy" and "jax", so the end-to-end cases place a
shim under the name ``repro.core.sweep_jax`` (the port's engine on the CPU)
and call them with ``backend="jax"``: the OperatingPoints must equal
``backend="numpy"``'s exactly. The copies of the cost model
(``repro_torch.core``) are held bitwise: the same op tables and the same
lowered collective menus."""
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402
from repro.configs import ARCHS, get_arch  # noqa: E402
from repro.core import H100, Scenario, make_cluster  # noqa: E402
from repro.core import optable, sweep  # noqa: E402
from repro.core.specdec import SpecDecConfig  # noqa: E402
from repro.core.topology import TOPOLOGIES, FaultSet  # noqa: E402
from repro_torch.configs import get_arch as t_get_arch  # noqa: E402
from repro_torch.core import hardware as t_hw  # noqa: E402
from repro_torch.core import optable as t_optable  # noqa: E402
from repro_torch.core import scenario as t_scenario  # noqa: E402
from repro_torch.core import sweep_torch  # noqa: E402
from repro_torch.core import topology as t_topology  # noqa: E402

RTOL = 1e-6          # the bar of the JAX engine against the NumPy one
BATCHES = np.array([1, 4, 64, 512, 4096, 32768])
N = 64


@pytest.fixture(scope="module")
def dsv3_small():
    return get_arch("deepseek-v3").replace(num_layers=8)


def cpu_engine(*args, **kw):
    return sweep_torch.TorchGridEngine(*args, device="cpu", **kw)


def cpu_prefill_chunk_times(*args, **kw):
    return sweep_torch.prefill_chunk_times(*args, device="cpu", **kw)


@pytest.fixture
def torch_as_jax(monkeypatch):
    """``repro.core.sweep_jax`` replaced by the port's engine on the CPU,
    for this test only."""
    shim = types.ModuleType("repro.core.sweep_jax")
    shim.JaxGridEngine = cpu_engine
    shim.prefill_chunk_times = cpu_prefill_chunk_times
    shim.require_jax = lambda: None
    shim.HAVE_JAX = True
    monkeypatch.setitem(sys.modules, "repro.core.sweep_jax", shim)
    monkeypatch.setattr(repro.core, "sweep_jax", shim, raising=False)
    return shim


def _tpots(cfg, tp, pp, topo, *, dbo, faults=None, sd=None, scs=None, load_of=None):
    """(numpy, port) TPOT grids for one mapping on one topology."""
    ep = max(N // (tp * pp), 1)
    table = optable.op_table(cfg, tp, ep, N, "fp8", pp=pp)
    cl = make_cluster(topo, N, H100)
    if faults is not None:
        cl = cl.with_faults(faults)
    scs = scs or [Scenario(25.0, 512), Scenario(60.0, 8192)]
    load = load_of(table, scs) if load_of else None
    ref = sweep.GridEval(table, [cl], scs, BATCHES, backend="numpy", load=load)
    eng = cpu_engine(table, [cl], scs, BATCHES, ref.half, load=load)
    return ref.tpot(dbo=dbo, sd=sd), eng.tpot(dbo=dbo, sd=sd)


# ---------------------------------------------------------------------------
# grid parity: topology x (tp, pp) x dbo x faults x skew
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("topo", TOPOLOGIES)
@pytest.mark.parametrize("dbo", [False, True])
def test_grid_parity_topologies(dsv3_small, topo, dbo):
    ref, got = _tpots(dsv3_small, 2, 1, topo, dbo=dbo)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0.0)


@pytest.mark.parametrize("tp,pp", [(1, 1), (4, 1), (1, 4), (2, 2)])
def test_grid_parity_mappings(dsv3_small, tp, pp):
    """pp > 1 runs stage_scale and the pp send/recv lane of the makespan."""
    ref, got = _tpots(dsv3_small, tp, pp, "fullmesh", dbo=True)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0.0)


def test_grid_parity_faulted_fabric(dsv3_small):
    """Link faults derate the menus per cluster; the lowering picks the
    derated alphas up from Cluster.comm_spec unchanged."""
    ref, got = _tpots(dsv3_small, 2, 1, "torus", dbo=True,
                      faults=FaultSet(mesh_links=(2, 1, 0)))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0.0)


def test_grid_parity_speculative_decoding(dsv3_small):
    ref, got = _tpots(dsv3_small, 2, 1, "scale-up", dbo=True, sd=SpecDecConfig())
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0.0)


@pytest.mark.parametrize("extra_slots", [0, 2])
def test_grid_parity_skewed_load(dsv3_small, extra_slots):
    """Zipf expert skew: the `_skew` kernels, with and without replicas;
    the port's `op_load_factors` equals the reference's."""
    scs = [Scenario(40.0, 4096),
           Scenario(40.0, 4096, routing="zipf", zipf_s=0.6),
           Scenario(25.0, 1024, routing="zipf", zipf_s=1.0, routing_seed=3)]

    def load_of(table, scs):
        want = sweep.op_load_factors(table, dsv3_small, scs, extra_slots)
        got = sweep_torch.op_load_factors(table, dsv3_small, scs, extra_slots)
        assert want is not None
        for a, b in zip(got, want):
            assert np.array_equal(a, b)
        return want

    for dbo in (False, True):
        ref, got = _tpots(dsv3_small, 1, 1, "torus", dbo=dbo, scs=scs, load_of=load_of)
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0.0)


def test_seq_components_match(dsv3_small):
    """The components the makespan reads, not only their sum."""
    table = optable.op_table(dsv3_small, 2, 32, N, "fp8")
    clusters = [make_cluster(t, N, H100) for t in TOPOLOGIES]
    scs = [Scenario(25.0, 512), Scenario(60.0, 8192)]
    ref = sweep.GridEval(table, clusters, scs, BATCHES, backend="numpy")
    eng = cpu_engine(table, clusters, scs, BATCHES, ref.half)
    for half in (False, True):
        _, tc, tm = ref.seq_components(1, half)
        got_c, got_m = eng.seq_components(1, half)
        np.testing.assert_allclose(got_c, tc, rtol=RTOL, atol=0.0)
        np.testing.assert_allclose(got_m, tm, rtol=RTOL, atol=0.0)
    np.testing.assert_allclose(eng.dbo_makespan(1), ref.dbo_makespan(1),
                               rtol=RTOL, atol=0.0)


def test_comm_lowering_matches_numpy_menus(dsv3_small):
    """The padded (A, Mc, Bt) menus are exactly the per-cluster
    coefficients the NumPy path uses; padding is inert under the min."""
    table = optable.op_table(dsv3_small, 2, 32, N, "fp8")
    clusters = [make_cluster(t, N, H100) for t in TOPOLOGIES]
    A, Mc, Bt = sweep_torch.lower_comm_menus(table, clusters)
    for oi in range(table.n_ops):
        for ci, cl in enumerate(clusters):
            if table.is_compute[oi]:
                assert np.all(np.isinf(A[oi, ci]))
                continue
            want = np.array(sweep._comm_menu_coeffs(cl, int(table.kind[oi]),
                                                    int(table.group[oi]),
                                                    table.tp, table.pp))
            k = len(want)
            assert np.array_equal(A[oi, ci, :k], want[:, 0])
            assert np.array_equal(Mc[oi, ci, :k], want[:, 1])
            assert np.array_equal(Bt[oi, ci, :k], want[:, 2])
            assert np.all(np.isinf(A[oi, ci, k:]))


def test_prefill_chunk_times_parity(dsv3_small):
    """Uneven causal halves under DBO, pp = 2."""
    ptable = optable.prefill_op_table(dsv3_small, 2, 16, N, pp=2)
    cl = make_cluster("fullmesh", N, H100)
    sizes = np.array([1, 128, 513, 4096])
    offsets = np.array([0, 0, 512, 8192])
    for dbo in (False, True):
        ref = sweep._prefill_chunk_times(ptable, cl, 256, sizes, offsets,
                                         dbo=dbo, backend="numpy")
        got = cpu_prefill_chunk_times(ptable, cl, 256, sizes, offsets, dbo=dbo)
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=0.0)


def test_engine_defaults_to_the_card(dsv3_small, monkeypatch):
    """Without a card, the engine refuses its default device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    table = optable.op_table(dsv3_small, 2, 32, N, "fp8")
    cl = make_cluster("torus", N, H100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep_torch.TorchGridEngine(table, [cl], [Scenario(25.0, 512)], BATCHES,
                                    BATCHES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep_torch.prefill_chunk_times(optable.prefill_op_table(dsv3_small, 2, 32, N),
                                        cl, 64, [128], [0])


# ---------------------------------------------------------------------------
# the search entry points through the shim: EXACT OperatingPoint equality
# ---------------------------------------------------------------------------

def test_sweep_max_throughput_exact(dsv3_small, torch_as_jax):
    clusters = [make_cluster("scale-up", N, H100), make_cluster("torus", N, H100)]
    scs = [Scenario(25.0, 1024), Scenario(60.0, 4096)]
    ref = sweep.sweep_max_throughput(clusters, dsv3_small, scs, tp=2, dbo=True,
                                     backend="numpy")
    got = sweep.sweep_max_throughput(clusters, dsv3_small, scs, tp=2, dbo=True,
                                     backend="jax")
    assert got == ref


def test_degraded_max_throughput_exact(dsv3_small, torch_as_jax):
    cl = make_cluster("torus", N, H100)
    fs = FaultSet(mesh_links=(2, 1, 0), xpus=1)
    sc = Scenario(40.0, 4096)
    ref = sweep.degraded_max_throughput(cl, dsv3_small, sc, faults=fs, dbo=True,
                                        backend="numpy")
    got = sweep.degraded_max_throughput(cl, dsv3_small, sc, faults=fs, dbo=True,
                                        backend="jax")
    assert got == ref and got is not None


@pytest.mark.parametrize("mode", ["chunked", "disagg"])
def test_sweep_prefill_exact(dsv3_small, torch_as_jax, mode):
    clusters = [make_cluster("scale-up", N, H100)]
    sc = Scenario(40.0, 4096, prompt_len=2048, ttft_ms=2000.0)
    ref = sweep.sweep_prefill(clusters, dsv3_small, [sc], mode=mode, tp=2, dbo=True,
                              backend="numpy")
    got = sweep.sweep_prefill(clusters, dsv3_small, [sc], mode=mode, tp=2, dbo=True,
                              backend="jax")
    assert got == ref and got[0][0] is not None


def test_shim_reaches_the_port(dsv3_small, torch_as_jax):
    """`backend="jax"` really evaluates through the port's engine."""
    table = optable.op_table(dsv3_small, 2, 32, N, "fp8")
    ev = sweep.GridEval(table, [make_cluster("torus", N, H100)],
                        [Scenario(25.0, 512)], BATCHES, backend="jax")
    ev.tpot(dbo=True)
    assert isinstance(ev._engine, sweep_torch.TorchGridEngine)
    assert ev._engine.device.type == "cpu"


# ---------------------------------------------------------------------------
# randomized cells (hypothesis)
# ---------------------------------------------------------------------------

def test_decode_grid_parity_property(dsv3_small):
    hyp = pytest.importorskip("hypothesis")
    st = hyp.strategies

    @hyp.given(topo=st.sampled_from(TOPOLOGIES),
               tp_pp=st.sampled_from(((1, 1), (2, 1), (4, 1), (1, 2), (2, 2))),
               dbo=st.booleans(),
               fs=st.one_of(st.none(), st.builds(
                   FaultSet, mesh_links=st.tuples(st.integers(0, 3), st.integers(0, 3),
                                                  st.integers(0, 3)),
                   switch_planes=st.integers(0, 4), nics=st.integers(0, 4))),
               scs=st.lists(st.builds(Scenario, st.sampled_from((5.0, 15.0, 40.0, 100.0)),
                                      st.sampled_from((128, 1024, 8192, 32768))),
                            min_size=1, max_size=3),
               batches=st.lists(st.integers(1, 65536), min_size=1, max_size=6,
                                unique=True).map(sorted))
    @hyp.settings(max_examples=20, deadline=None, database=None)
    def check(topo, tp_pp, dbo, fs, scs, batches):
        tp, pp = tp_pp
        table = optable.op_table(dsv3_small, tp, max(N // (tp * pp), 1), N, "fp8", pp=pp)
        cl = make_cluster(topo, N, H100)
        if fs is not None:
            cl = cl.with_faults(fs)
        b = np.asarray(batches, np.int64)
        ref = sweep.GridEval(table, [cl], scs, b, backend="numpy")
        eng = cpu_engine(table, [cl], scs, b, ref.half)
        np.testing.assert_allclose(eng.tpot(dbo=dbo), ref.tpot(dbo=dbo),
                                   rtol=RTOL, atol=0.0)

    check()


# ---------------------------------------------------------------------------
# the port's copies of the cost model, bitwise
# ---------------------------------------------------------------------------

def _same_table(a, b):
    pa, pb = a.coeff_pytree(), b.coeff_pytree()
    assert pa.keys() == pb.keys()
    for k in pa:
        assert pa[k].dtype == pb[k].dtype and np.array_equal(pa[k], pb[k]), k
    assert np.array_equal(a.lane, b.lane) and a.n_ops == b.n_ops


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_op_tables_bitwise(arch):
    """Every config's decode and prefill op table at two mappings."""
    ref_cfg, port_cfg = get_arch(arch), t_get_arch(arch)
    for tp, pp in ((1, 1), (2, 2)):
        ep = max(N // (tp * pp), 1)
        _same_table(t_optable.op_table(port_cfg, tp, ep, N, "fp8", pp=pp),
                    optable.op_table(ref_cfg, tp, ep, N, "fp8", pp=pp))
        _same_table(t_optable.prefill_op_table(port_cfg, tp, ep, N, pp=pp),
                    optable.prefill_op_table(ref_cfg, tp, ep, N, pp=pp))


@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_cluster_menus_bitwise(topo):
    """Every topology's cluster from the port's copy lowers to the same
    menus as the reference's, with and without faults, on each XPU."""
    table = optable.op_table(get_arch("deepseek-v3").replace(num_layers=8),
                             2, 32, N, "fp8", pp=2)
    for xpu in ("H100", "BLACKWELL", "RUBIN"):
        ref = [make_cluster(topo, N, getattr(repro.core, xpu))]
        port = [t_topology.make_cluster(topo, N, getattr(t_hw, xpu))]
        fs = dict(mesh_links=(1, 0, 0), switch_planes=1, nics=1)
        ref.append(ref[0].with_faults(FaultSet(**fs)))
        port.append(port[0].with_faults(t_topology.FaultSet(**fs)))
        lw_p, lw_r = sweep_torch.lower_grid(table, port), sweep_torch.lower_grid(table, ref)
        for k in lw_r:
            assert np.array_equal(lw_p[k], lw_r[k]), (xpu, k)


def test_port_objects_end_to_end():
    """The port's own table, clusters and scenarios through the engine give
    the reference's TPOT grid exactly."""
    cfg_r = get_arch("deepseek-v3").replace(num_layers=8)
    cfg_p = t_get_arch("deepseek-v3").replace(num_layers=8)
    scs_r = [Scenario(25.0, 512), Scenario(60.0, 8192)]
    scs_p = [t_scenario.Scenario(25.0, 512), t_scenario.Scenario(60.0, 8192)]
    ref = sweep.GridEval(optable.op_table(cfg_r, 2, 32, N, "fp8"),
                         [make_cluster(t, N, H100) for t in TOPOLOGIES], scs_r,
                         BATCHES, backend="numpy")
    eng = cpu_engine(t_optable.op_table(cfg_p, 2, 32, N, "fp8"),
                     [t_topology.make_cluster(t, N, t_hw.H100) for t in TOPOLOGIES],
                     scs_p, BATCHES, ref.half)
    for dbo in (False, True):
        np.testing.assert_allclose(eng.tpot(dbo=dbo), ref.tpot(dbo=dbo),
                                   rtol=RTOL, atol=0.0)
    assert [s.name for s in scs_p] == [s.name for s in scs_r]
