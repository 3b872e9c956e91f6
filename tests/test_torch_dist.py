"""The port's ``Dist`` on ``torch.distributed``: four gloo ranks on the CPU
as a 2x2 ("data", "model") mesh, each collective over a single axis and
over the tuple of both, against the numpy definitions of the tiled
``lax`` collectives, and against the JAX package's own ``Dist`` inside
``jax.shard_map`` on four forced host devices (a subprocess: JAX fixes
its device count when it starts). Also the mesh's coordinates and groups,
and that the transport is the caller's choice."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import (Mesh, make_mesh, make_production_mesh,  # noqa: E402
                                     mesh_axis_sizes)
from repro_torch.sharding.dist import Dist, NullDist  # noqa: E402
from torch_sharded_workers import collectives, rank_input  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
N_RANKS = 4
# rank r sits at (data, model) = (r // 2, r % 2); each axis's group in
# index order
GROUPS = {"data": lambda r: [r % 2, 2 + r % 2],
          "model": lambda r: [2 * (r // 2), 2 * (r // 2) + 1],
          ("data", "model"): lambda r: [0, 1, 2, 3]}

# (name, op, axis, dtype, kwargs)
CASES = [
    ("psum_data", "psum", "data", "float32", {}),
    ("psum_model_bf16", "psum", "model", "bfloat16", {}),
    ("psum_both_u8", "psum", ("data", "model"), "uint8", {}),
    ("pmax_model", "pmax", "model", "float32", {}),
    ("pmax_both", "pmax", ("data", "model"), "float32", {}),
    ("ag_model_0", "all_gather", "model", "float32", {"dim": 0}),
    ("ag_data_2_bf16", "all_gather", "data", "bfloat16", {"dim": 2}),
    ("ag_both_1_u8", "all_gather", ("data", "model"), "uint8", {"dim": 1}),
    ("rs_model_0", "reduce_scatter", "model", "float32", {"dim": 0}),
    ("rs_data_2", "reduce_scatter", "data", "float32", {"dim": 2}),
    ("rs_both_0", "reduce_scatter", ("data", "model"), "float32", {"dim": 0}),
    ("a2a_model_0_1", "all_to_all", "model", "float32", {"split_dim": 0, "concat_dim": 1}),
    ("a2a_model_1_0", "all_to_all", "model", "float32", {"split_dim": 1, "concat_dim": 0}),
    ("a2a_data_0_0", "all_to_all", "data", "float32", {"split_dim": 0, "concat_dim": 0}),
    ("a2a_data_2_1_bf16", "all_to_all", "data", "bfloat16", {"split_dim": 2, "concat_dim": 1}),
    ("a2a_both_0_2_u8", "all_to_all", ("data", "model"), "uint8",
     {"split_dim": 0, "concat_dim": 2}),
    ("ppermute_model", "ppermute", "model", "float32", {"perm": [(0, 1)]}),
    ("roll_data", "roll", "data", "float32", {"shift": 1}),
    ("roll_both_back", "roll", ("data", "model"), "float32", {"shift": -1}),
    ("argmax_model", "argmax_across", "model", "float32", {}),
]


def x_of(r, dtype):
    x = rank_input(r, dtype)
    if dtype == "bfloat16":
        return torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    return x


def expected(name, r):
    """The numpy definition of case `name` on rank r."""
    _, op, axis, dtype, kw = next(c for c in CASES if c[0] == name)
    group = GROUPS[axis](r)
    me = group.index(r)
    xs = [x_of(g, dtype) for g in group]
    n = len(group)
    if op == "psum":
        if dtype == "bfloat16":      # one rounding of the exact sum of two
            return torch.tensor(xs[0] + xs[1]).to(torch.bfloat16).float().numpy()
        return sum(x.astype(np.int64) if dtype == "uint8" else x for x in xs).astype(xs[0].dtype)
    if op == "pmax":
        return np.max(xs, axis=0)
    if op == "all_gather":
        return np.concatenate(xs, axis=kw["dim"])
    if op == "reduce_scatter":
        return np.split(sum(xs), n, axis=kw["dim"])[me]
    if op == "all_to_all":
        return np.concatenate([np.split(x, n, axis=kw["split_dim"])[me] for x in xs],
                              axis=kw["concat_dim"])
    if op in ("ppermute", "roll"):
        perm = kw.get("perm") or [(i, (i + kw["shift"]) % n) for i in range(n)]
        src = [s for s, d in perm if d == me]
        return xs[src[0]] if src else np.zeros_like(xs[me])
    if op == "argmax_across":
        vals = np.stack([x.max(-1) for x in xs])                     # [n, 4, 6]
        idx = np.stack([x.argmax(-1) + 8 * i for i, x in enumerate(xs)])
        return np.take_along_axis(idx, vals.argmax(0)[None], 0)[0]
    raise ValueError(op)


@pytest.fixture(scope="module")
def port_results():
    return serve.spawn(collectives, (CASES,), mesh_shape=(2, 2), transport="gloo",
                       device="cpu", timeout=240)


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_collective_matches_numpy(port_results, case):
    for r in range(N_RANKS):
        got, want = port_results[r][case], expected(case, r)
        assert got.shape == want.shape, (case, r)
        np.testing.assert_array_equal(got, want, err_msg=f"{case} on rank {r}")


def test_index_is_row_major(port_results):
    for r in range(N_RANKS):
        assert port_results[r]["index"] == {"'data'": r // 2, "'model'": r % 2,
                                            "('data', 'model')": r}


JAX_SHARD_MAP = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.launch.mesh import make_mesh
from repro.sharding.dist import Dist, argmax_across
sys.path.insert(0, {tests!r})
from torch_sharded_workers import rank_input
cases = json.loads({cases!r})
mesh = make_mesh((2, 2), ("data", "model"))
dist = Dist(dict(data=2, model=2))
out = {{}}
for name, op, axis, dtype, kw in cases:
    axis = tuple(axis) if isinstance(axis, list) else axis
    if "perm" in kw:
        kw["perm"] = [tuple(p) for p in kw["perm"]]
    xs = np.stack([rank_input(r, dtype) for r in range(4)]).reshape((2, 2) + (4, 6, 8))
    g = jnp.asarray(xs, jnp.bfloat16 if dtype == "bfloat16" else xs.dtype)
    def f(x):
        x = x[0, 0]
        if op == "argmax_across":
            v = x.astype(jnp.float32)
            y = argmax_across(dist, v.max(-1), v.argmax(-1) + 8 * dist.index(axis), axis)
        else:
            y = getattr(dist, op)(x, axis, **kw)
        return y[None, None]
    y = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P("data", "model"),
                              out_specs=P("data", "model"), check_vma=False))(g)
    y = np.asarray(y.astype(jnp.float32) if dtype == "bfloat16" else y)
    out[name] = [y[r // 2, r % 2].tolist() for r in range(4)]
print(json.dumps(out))
"""


def test_matches_jax_shard_map(port_results):
    """The same collectives through the JAX package's Dist in shard_map."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=4").strip())
    code = JAX_SHARD_MAP.format(tests=str(REPO / "tests"), cases=json.dumps(CASES))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    jax_out = json.loads(out.stdout.strip().splitlines()[-1])
    for name, *_ in CASES:
        for r in range(N_RANKS):
            np.testing.assert_array_equal(port_results[r][name],
                                          np.asarray(jax_out[name][r]),
                                          err_msg=f"{name} on rank {r}")


def test_mesh_coordinates_and_groups():
    m = Mesh((2, 4), ("data", "model"), rank=6)
    assert m.coords() == {"data": 1, "model": 2}
    assert m.index(("data", "model")) == 6 and m.index("model") == 2
    assert m.group_ranks("data") == [2, 6]
    assert m.group_ranks("model") == [4, 5, 6, 7]
    assert m.all_groups(("data",)) == [[0, 4], [1, 5], [2, 6], [3, 7]]
    with pytest.raises(ValueError):
        m.index(("model", "data"))                   # not in mesh order
    pod = make_production_mesh(multi_pod=True)
    assert (pod.shape, pod.axes) == ((2, 16, 16), ("pod", "data", "model"))
    assert make_production_mesh().shape == (16, 16)
    assert mesh_axis_sizes(make_mesh((2, 2), ("data", "model"))) == {"data": 2, "model": 2}


def test_transport_is_explicit():
    """No silent switch: nccl without a card per rank raises, an unknown
    transport raises, and a Dist without a mesh refuses to communicate."""
    mesh = Mesh((2, 2), ("data", "model"))
    if torch.cuda.device_count() < 4:
        with pytest.raises(RuntimeError, match="one card per rank"):
            Dist.for_mesh(mesh, "nccl")
    with pytest.raises(ValueError):
        Dist(mesh.axis_sizes, mesh=mesh, transport="mpi")
    d = Dist({"model": 2})
    x = torch.ones(4)
    for op in (lambda: d.psum(x, "model"), lambda: d.all_gather(x, "model"),
               lambda: d.index("model")):
        with pytest.raises(ValueError, match="needs a Mesh"):
            op()
    assert d.psum(x, "data") is x and NullDist().all_to_all(x, "model", 0, 0) is x
    with pytest.raises(ValueError, match="gloo with --device cpu"):
        serve._rank_device(0, "nccl", "cpu")
