"""The sharded Mamba and MLA mixers of the port against the JAX package's
single device: four gloo ranks on the CPU as a 2x2 ("data", "model") mesh
(one spawn for the module), reduced jamba-v0.1-52b and deepseek-v3 in
f32.

- Layer by layer: the sequence-sharded ``mamba_fwd`` and ``mla_fwd``
  (batch over data, sequence and d_inner over model), their prefill caches,
  the caches re-laid out by ``kvcache.pad_to_capacity`` for the decode
  plan (Mamba's already in its layout, MLA's gathered and replicated over
  model), three decode steps past the prefill, and the gradients of
  sum(y * w) with respect to x and every weight, against JAX's
  single-device functions and ``jax.grad`` on weights from ``convert``:
  1e-5 (gradients rtol 1e-4, atol 1e-5).
- Whole serving through ``launch.serve``'s job: the greedy tokens equal the
  single-device port's from the same seed; prefill, re-layout and decode of
  JAX's converted weights give logits within 1e-4 of JAX's single device.
- The reference's own sharded Mamba, run in a subprocess on four forced
  host devices: its ``mamba_fwd`` under ``shard_map`` misses its single
  device by more than 1e-4 (``w_bc`` and ``w_dt_in`` are row-sharded over
  d_inner and their products are never summed over tp), and its sharded
  prefill keeps one model rank's positions of the MLA latent cache (its
  cache specs describe the decode layout); ROADMAP queue 3.

jamba routes top-2 of 8 experts in the reduced config: its capacity
factor is raised to 4 (no token dropped), so that a rank's capacity
group and the single device's whole batch keep the same tokens.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.layers import common as JC  # noqa: E402
from repro.models.layers import mamba as JMB  # noqa: E402
from repro.models.layers import mla as JMLA  # noqa: E402
from repro.serving import kvcache as jkv  # noqa: E402
from repro.sharding.dist import NullDist as JaxNullDist  # noqa: E402
from repro.sharding.plans import null_plan as jax_null_plan  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.configs.base import ShapeCell  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import kvcache  # noqa: E402
from repro_torch.sharding.plans import make_plan  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
AXES, SHAPE = ("data", "model"), (2, 2)
B, S, CAP, STEPS = 4, 16, 32, 3
TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
ARCHS = ("jamba-v0.1-52b", "deepseek-v3")
NEW_TOKENS = 6


def configs(arch):
    """(JAX config, port config): reduced, f32; jamba without drops."""
    j, t = jax_reduced(jax_arch(arch), dtype="float32"), \
        reduced_config(get_arch(arch), dtype="float32")
    if arch == "jamba-v0.1-52b":
        j = j.replace(moe=dataclasses.replace(j.moe, capacity_factor=4.0))
        t = t.replace(moe=dataclasses.replace(t.moe, capacity_factor=4.0))
    return j, t


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def weights(jcfg, tcfg):
    jp, _ = JM.init_model(jcfg, jax_null_plan("decode"), jax.random.PRNGKey(0))
    jp = jax.tree.map(np.asarray, jp)
    return jp, convert.params_from_jax(jp, tcfg, device="cpu")


def jax_layer0(jp):
    return jax.tree.map(lambda a: jnp.asarray(a[0]), jp["stack"]["periods"][0])["mixer"]


def jax_mixer_reference(arch, jcfg, jm, x, w, feed):
    """JAX single device on layer 0's mixer: y, the prefill cache, the
    padded cache, the decode outputs, the last cache, and jax.grad of
    sum(y * w) with respect to x and the weights."""
    plan, d = jax_null_plan("prefill"), JaxNullDist()
    mamba = arch == "jamba-v0.1-52b"
    fwd = JMB.mamba_fwd if mamba else JMLA.mla_fwd

    def loss(x_, p_):
        return jnp.sum(fwd(p_, x_, jcfg, plan, d)[0] * w)
    dx, dw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jm)
    y, cache = fwd(jm, jnp.asarray(x), jcfg, plan, d, make_cache=True)
    out = {"y": y, "cache": cache, "dx": dx, "dw": dw}
    if not mamba:
        cache = {k: jnp.pad(v, ((0, 0), (0, CAP - S), (0, 0))) for k, v in cache.items()}
    out["relaid"] = cache
    ys = []
    dplan = jax_null_plan("decode")
    for i in range(STEPS):
        if mamba:
            yt, cache = JMB.mamba_decode(jm, jnp.asarray(feed[i]), cache, jcfg, dplan, d)
        else:
            yt, cache = JMLA.mla_decode(jm, jnp.asarray(feed[i]), cache, S + i, jcfg,
                                        dplan, d)
        ys.append(yt)
    out["decode"], out["last_cache"] = np.stack(ys), cache
    return jax.tree.map(np.asarray, out)


def jax_serve_logits(jp, jcfg, prompt, feed):
    """JAX single-device prefill of `prompt` [B, P], the caches padded to
    CAP, then decode of `feed` [B, n] at positions P, P + 1, ...: each
    step's logits [n, B, V]."""
    plan, d = jax_null_plan("decode"), JaxNullDist()
    _, caches = JM.prefill(jp, {"tokens": jnp.asarray(prompt)}, jcfg,
                           jax_null_plan("prefill"), d)
    caches = jkv.pad_to_capacity(jcfg, caches, prompt.shape[1], CAP)
    out = []
    for i in range(feed.shape[1]):
        x = JC.embed(jp["embed"], jnp.asarray(feed[:, i:i + 1]), jcfg, plan, d)
        x, caches, _ = JT.apply_stack(jp["stack"], x, jcfg, plan, d, mode="decode",
                                      caches=caches, pos=jnp.int32(prompt.shape[1] + i))
        x = JC.rms_norm(x, jp["final_norm"]["scale"], jcfg.norm_eps)
        out.append(np.asarray(JC.lm_logits(jp["embed"], x, jcfg, plan, d)[:, 0], np.float32))
    return np.stack(out)


def serve_job(arch):
    _, tcfg = configs(arch)
    return dict(arch=arch, reduced=True, config=dict(dtype="float32", moe=tcfg.moe),
                batch=8, prompt_len=S, max_seq=CAP, new_tokens=NEW_TOKENS, seed=3)


def _cases():
    calls, refs = [], {}
    for k, arch in enumerate(ARCHS):
        jcfg, tcfg = configs(arch)
        jp, tp = weights(jcfg, tcfg)
        x, w = rand(10 + k, B, S, tcfg.d_model), rand(20 + k, B, S, tcfg.d_model)
        feed = rand(30 + k, STEPS, B, 1, tcfg.d_model)
        jm = jax_layer0(jp)
        refs[f"layer/{arch}"] = dict(jax=jax_mixer_reference(arch, jcfg, jm, x, w, feed),
                                     keys=list(tp["stack"][0]["mixer"]))
        calls.append(("mixer_layer", (dict(cfg=tcfg, params=tp["stack"][0]["mixer"], x=x,
                                           w=w, feed=feed, cap=CAP),)))
        prompt = np.random.default_rng(40 + k).integers(1, tcfg.vocab_size, (8, S))
        feed_tok = np.random.default_rng(50 + k).integers(1, tcfg.vocab_size, (8, STEPS))
        refs[f"serve/{arch}"] = dict(jax=jax_serve_logits(jp, jcfg, prompt, feed_tok))
        calls.append(("torch_sharded_workers.run_jobs", ([dict(
            kind="serve", cfg=tcfg, params=tp, batch=8, seq=S, to_seq=CAP,
            tokens=prompt.astype(np.int32), feed=feed_tok.astype(np.int32))],)))
        calls.append(("torch_sharded_workers.serve_reduced", (serve_job(arch),)))
    return calls, refs


@pytest.fixture(scope="module")
def runs():
    calls, refs = _cases()
    out = serve.spawn(__import__("torch_mixer_workers").in_order, (calls,),
                      mesh_shape=SHAPE, transport="gloo", device="cpu", timeout=400)
    res = {}
    for k, arch in enumerate(ARCHS):
        res[f"layer/{arch}"] = [out[r][3 * k] for r in range(4)]
        res[f"serve/{arch}"] = [out[r][3 * k + 1][0] for r in range(4)]
        res[f"launcher/{arch}"] = [out[r][3 * k + 2] for r in range(4)]
    return res, refs


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_mixer_prefill_matches_jax_single_device(runs, arch):
    """y and the prefill cache (gathered from the ranks) against JAX's
    single device; every rank gathers the same."""
    out, refs = runs
    got, want = out[f"layer/{arch}"], refs[f"layer/{arch}"]["jax"]
    for r in range(1, 4):
        np.testing.assert_array_equal(got[r]["y"], got[0]["y"])
    np.testing.assert_allclose(got[0]["y"], want["y"], **TOL)
    assert set(got[0]["cache"]) == set(want["cache"])
    for k, v in want["cache"].items():
        np.testing.assert_allclose(got[0]["cache"][k], v, err_msg=k, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_mixer_decode_matches_jax_single_device(runs, arch):
    """The re-laid-out cache (Mamba: as prefill left it; MLA: all positions,
    zero-padded to CAP), three decode steps and the last cache against
    JAX's single device; each rank's decode cache is its shard (Mamba:
    d_inner over model; MLA: every position, the batch over data)."""
    out, refs = runs
    got, want = out[f"layer/{arch}"][0], refs[f"layer/{arch}"]["jax"]
    for key in ("relaid", "last_cache"):
        for k, v in want[key].items():
            np.testing.assert_allclose(got[key][k], v, err_msg=f"{key}/{k}", **TOL)
    np.testing.assert_allclose(got["decode"], want["decode"], **TOL)
    _, tcfg = configs(arch)
    if arch == "jamba-v0.1-52b":
        di = tcfg.mamba.expand * tcfg.d_model
        assert got["local_cache_shapes"] == {"conv": (B // 2, 3, di // 2),
                                             "ssm": (B // 2, di // 2, 16)}
    else:
        assert got["local_cache_shapes"] == {"c_kv": (B // 2, CAP, 32),
                                             "k_rope": (B // 2, CAP, 8)}
    # the shapes ``init_cache`` gives a rank of the decode plan
    plan = make_plan(tcfg, ShapeCell("d", CAP, B, "decode"), AXES, SHAPE, fsdp=False)
    for r in range(4):
        mine = M.init_cache(tcfg, plan, B, CAP, device="cpu", mesh=Mesh(SHAPE, AXES, r))
        assert {k: tuple(v.shape) for k, v in mine[0]["mixer"].items()} == \
            out[f"layer/{arch}"][r]["local_cache_shapes"]


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_mixer_gradients_match_jax_single_device(runs, arch):
    """The gradients of sum(y * w) across the ranks, each weight's reduced
    over the axes its spec leaves unsharded, against jax.grad on one
    device: x, and every weight (for Mamba w_bc, w_dt_in and w_x among
    them, whose B, C and dt sums run ``psum_for_shards``)."""
    out, refs = runs
    got, ref = out[f"layer/{arch}"][0], refs[f"layer/{arch}"]
    np.testing.assert_allclose(got["dx"], ref["jax"]["dx"], **GRAD_TOL)
    assert len(got["dw"]) == len(ref["keys"])
    for key, g in zip(ref["keys"], got["dw"]):
        np.testing.assert_allclose(g, ref["jax"]["dw"][key], err_msg=key, **GRAD_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serving_logits_match_jax_single_device(runs, arch):
    """JAX's weights converted: the ranks' prefill, re-layout for CAP and
    three decode steps give logits within 1e-4 of JAX's single device."""
    out, refs = runs
    got = [res["logits"] for res in out[f"serve/{arch}"]]
    for r in range(1, 4):
        np.testing.assert_array_equal(got[r], got[0])
    assert got[0].shape[0] == STEPS
    np.testing.assert_allclose(got[0], refs[f"serve/{arch}"]["jax"], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_tokens_equal_single_device(runs, arch):
    """``launch.serve``'s job on the 2x2 mesh (weights drawn rank by rank
    from the seed): its greedy tokens equal the single-device port's from
    the same seed, prefill then decode."""
    out, _ = runs
    job = serve_job(arch)
    r0 = out[f"launcher/{arch}"][0]
    cfg = serve.job_config(job)
    params = M.init_model(cfg, None, seed=job["seed"], device="cpu")
    prompt = torch.from_numpy(r0["prompts"])
    with torch.no_grad():
        tok, caches = M.prefill(params, {"tokens": prompt}, cfg)
        caches = kvcache.pad_to_capacity(cfg, caches, S, CAP)
        toks = [tok]
        for i in range(NEW_TOKENS - 1):
            tok, caches = M.decode_step(params, caches, tok, S + i, cfg)
            toks.append(tok)
    np.testing.assert_array_equal(r0["tokens"], torch.cat(toks, dim=1).numpy())


JAX_SHARDED = r"""
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_arch, reduced_config
from repro.configs.base import ShapeCell
from repro.launch import steps as S
from repro.launch.mesh import make_mesh
from repro.models import model as M
from repro.models.layers import mamba as MB
from repro.sharding.dist import Dist, NullDist
from repro.sharding.plans import make_plan, null_plan
out = {}
mesh = make_mesh((2, 2), ("data", "model"))
dist = Dist(dict(data=2, model=2))
# the sharded Mamba layer against its single device
cfg = reduced_config(get_arch("jamba-v0.1-52b")).replace(dtype="float32")
params, _ = M.init_model(cfg, null_plan("prefill"), jax.random.PRNGKey(0))
lay = jax.tree.map(lambda a: a[0], params["stack"]["periods"][0])["mixer"]
plan = make_plan(cfg, ShapeCell("p", 16, 4, "prefill"), ("data", "model"), (2, 2), fsdp=False)
_, specs = MB.init_mamba(cfg, plan, jax.random.PRNGKey(0))
x = jnp.asarray(np.random.default_rng(10).standard_normal((4, 16, cfg.d_model)), jnp.float32)
single = MB.mamba_fwd(lay, x, cfg, null_plan("prefill"), NullDist())[0]
xs = P(plan.batch_axes, plan.seq_axis, None)
f = jax.jit(jax.shard_map(lambda p, x_: MB.mamba_fwd(p, x_, cfg, plan, dist)[0], mesh=mesh,
                          in_specs=(specs, xs), out_specs=xs, check_vma=False))
with mesh:
    got = f(lay, x)
out["mamba_gap"] = float(jnp.abs(got - single).max())
out["mamba_max_abs_y"] = float(jnp.abs(single).max())
# the sharded prefill's MLA cache
cfg = reduced_config(get_arch("deepseek-v3")).replace(dtype="float32")
plan = make_plan(cfg, ShapeCell("p", 16, 4, "prefill"), ("data", "model"), (2, 2), fsdp=False)
step, _, _ = S.build_prefill(cfg, ShapeCell("p", 16, 4, "prefill"), plan, mesh)
params, _ = M.init_model(cfg, null_plan("prefill"), jax.random.PRNGKey(0))
pspecs = S.abstract_model(cfg, plan)[1]
put = lambda t, s: jax.tree.map(lambda a, b: jax.device_put(a, NamedSharding(mesh, b)), t, s,
                                is_leaf=lambda s: isinstance(s, P))
tok = np.random.default_rng(3).integers(1, cfg.vocab_size, (4, 16)).astype(np.int32)
with mesh:
    _, caches = step(put(params, pspecs),
                     {"tokens": jax.device_put(tok, NamedSharding(mesh, P(plan.batch_axes,
                                                                          plan.seq_axis)))})
out["mla_prefill_cache_shape"] = list(jax.tree.leaves(caches)[0].shape)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_sharded():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_force_host_platform_device_count=4").strip())
    proc = subprocess.run([sys.executable, "-c", JAX_SHARDED], env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_reference_sharded_mamba_misses_its_single_device(runs, jax_sharded):
    """The reference's Megatron-SP Mamba (``shard_map``, model = 2) misses
    its single device by more than 1e-4 (3.28e-3 on this input, where |y|
    reaches 0.80), where f32 agrees to ~1e-7: B, C and the step sizes are each
    rank's partial sums over d_inner. The port's sharded forward, which
    sums them over tp, is within 1e-5 of that single device."""
    out, refs = runs
    assert jax_sharded["mamba_gap"] > 1e-4, jax_sharded
    got, want = out["layer/jamba-v0.1-52b"][0]["y"], refs["layer/jamba-v0.1-52b"]["jax"]["y"]
    assert np.abs(got - want).max() <= 1e-5


def test_reference_sharded_prefill_keeps_one_rank_of_the_mla_cache(jax_sharded):
    """The reference's sharded prefill (sequence over model = 2) returns the
    MLA latent cache under its decode specs, replicated over model: the
    global cache holds 8 of the prompt's 16 positions. The port's prefill
    cache keeps each rank's positions (``specs.cache_specs``) and
    ``pad_to_capacity`` gathers all 16."""
    assert jax_sharded["mla_prefill_cache_shape"] == [2, 4, 8, 32], jax_sharded


@pytest.mark.parametrize("arch", ["deepseek-v3", "jamba-v0.1-52b"])
def test_chip_smoke_sharded_mixer_phase_rehearses_on_cpu(monkeypatch, arch):
    """``chip_smoke.py``'s ``sharded.deepseek-v3`` and
    ``sharded.jamba-v0.1-52b`` at a reduced size on the CPU, with the
    timed deeper job: the launcher's jobs, the counting Dist, the
    teacher-forced single-device references, which replay the run's expert
    choices, and their gates. The counted
    all-to-all bytes equal the phase's own prediction (a gate of the phase
    too), and the f32 job is the single device's within 1e-4."""
    monkeypatch.syspath_prepend(str(REPO))
    import chip_smoke
    out = chip_smoke.sharded_phase(torch, M, kvcache, "cpu", device="cpu", arch=arch,
                                   timed=True, reduced=True)
    jobs = out["jobs"]
    assert set(jobs) == {"bf16", "fp8", "f32"} | (
        {"bf16_4_layers"} if arch == "deepseek-v3" else set())
    assert jobs["f32"]["max_abs_logit_diff_vs_single_device"] < 1e-4
    for name, job in jobs.items():
        pred = out["predicted_by_job"][name]
        assert pred["dispatch"] > 0
        for r in job["ranks"]:
            for kind in ("dispatch", "combine"):
                assert r["collective_bytes_per_step"][kind] == pytest.approx(pred[kind])
    assert out["predicted_by_job"]["fp8"]["dispatch"] < out["predicted_by_job"]["bf16"][
        "dispatch"]
    # the references replay the run's expert choices (``replaying_route``)
    assert all(jobs[n]["references_replay_expert_choices"] for n in ("bf16", "fp8", "f32"))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_runs_mamba_and_mla_on_cpu(arch):
    """``python -m repro_torch.launch.train`` takes deepseek-v3 and jamba
    jobs: reduced, four gloo ranks on the CPU, FSDP over data and the
    sequence, d_inner and the experts over model."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--transport", "gloo", "--reduced", "--mesh", "2x2", "--arch", arch,
         "--batch", "4", "--seq", "16", "--steps", "2"],
        env=env, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-4000:]
    losses = [float(line.split("loss ")[1].split()[0]) for line in proc.stdout.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and all(np.isfinite(losses)), proc.stdout
