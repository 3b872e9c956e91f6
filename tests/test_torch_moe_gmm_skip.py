"""The tensor-core ``moe_gmm`` skips token tiles that hold no nonzero
element. This file holds the skip's premises against JAX on the CPU, at
reduced widths with each config's published expert count and top-k (so
that 8 decode tokens leave experts unreached):

- the buffer that the port's ``moe_ffn`` hands to ``ops.moe_gmm`` reaches
  exactly the experts, with exactly the prefix fills, that JAX's
  ``route`` and ``slot_assignment`` give for the same logits;
- ``moe_gmm_pallas`` (interpret mode), the JAX oracle and the port's
  ``moe_gmm_ref`` give exact zeros on every zero row, so on every tile the
  kernel skips;
- ``ref.moe_gmm_active_tiles_ref`` counts the tiles and experts that a
  count by hand from those fills gives.

The kernel against these on the card is in test_torch_cuda.py."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_arch as jax_arch  # noqa: E402
from repro.configs import reduced_config as jax_reduced  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.moe_gmm import moe_gmm_pallas  # noqa: E402
from repro.models.layers import moe as JMoE  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.kernels import moe_gmm as tmg  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models.layers import moe as TMoE  # noqa: E402
from repro_torch.sharding.dist import NullDist  # noqa: E402
from repro_torch.sharding.plans import null_plan  # noqa: E402

ARCHS = ("olmoe-1b-7b", "deepseek-v3", "jamba-v0.1-52b")
# (name, rows of x, positions per row, capacity groups): decode is 8 slots
# of one token, each its own group (the engine's batched decode); training
# one group of 2048 tokens, which fills olmoe's and jamba's experts past
# 256 rows (the ROWS plan) and deepseek-v3's to 96 (the SWAP plan)
MODES = (("decode", 8, 1, 8), ("train", 4, 512, 1))


def cfg_pair(name):
    """The reduced config on both sides, with the published expert count
    and top-k."""
    full = get_arch(name).moe
    out = []
    for arch, reduce in ((jax_arch, jax_reduced), (get_arch, reduced_config)):
        cfg = reduce(arch(name))
        out.append(cfg.replace(moe=dataclasses.replace(
            cfg.moe, num_experts=full.num_experts,
            experts_per_token=full.experts_per_token)))
    return out


def layer_params(tcfg, seed):
    """init_moe's leaves, redrawn with numpy at a seed."""
    params = TMoE.init_moe(tcfg, null_plan("decode"), torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy((rng.standard_normal(v.shape) * v.shape[-2] ** -0.5)
                                .astype(np.float32)).to(v.dtype)
            for k, v in params.items()}


def dispatched(monkeypatch, tcfg, params, x, groups):
    """The [E, T, D] buffer that ``moe_ffn`` hands to ``ops.moe_gmm``."""
    seen = []

    def capture(x_e, *w):
        seen.append(x_e.clone())
        return ref.moe_gmm_ref(x_e, *w)

    monkeypatch.setattr(TMoE.kops, "moe_gmm", capture)
    TMoE.moe_ffn(params, x, tcfg, null_plan("decode"), NullDist(), capacity_groups=groups)
    assert len(seen) == 1
    return seen[0]


def jax_fills(logits, jcfg, e_pad, groups):
    """fill [E, G]: the kept decisions of each group for each expert, from
    JAX's route and slot_assignment on each group's logits; and cap."""
    m = jcfg.moe
    n_tok = logits.shape[0]
    per = n_tok // groups
    cap = int(JMoE.capacity(per, m.experts_per_token, e_pad, m.capacity_factor))
    fill = np.zeros((e_pad, groups), np.int64)
    for g in range(groups):
        _, idx, _ = JMoE.route(jnp.asarray(logits[g * per:(g + 1) * per]),
                               m.experts_per_token, m.num_experts)
        _, keep = JMoE.slot_assignment(idx, e_pad, cap)
        idx, keep = np.asarray(idx), np.asarray(keep)
        np.add.at(fill[:, g], idx[keep], 1)
    return fill, cap


@pytest.mark.parametrize("mode,rows,pos,groups", MODES)
@pytest.mark.parametrize("name", ARCHS)
def test_skip_premises_against_jax(monkeypatch, name, mode, rows, pos, groups):
    jcfg, tcfg = cfg_pair(name)
    params = layer_params(tcfg, seed=ARCHS.index(name))
    d, e_pad = tcfg.d_model, params["router"].shape[-1]
    rng = np.random.default_rng(100 + ARCHS.index(name))
    x = torch.from_numpy(rng.standard_normal((rows, pos, d)).astype(np.float32)) \
        .to(params["w_gate"].dtype)
    x_e = dispatched(monkeypatch, tcfg, params, x, groups)

    # the same logits moe_ffn computes, routed by JAX
    logits = (x.reshape(-1, d).float() @ params["router"]).numpy()
    fill, cap = jax_fills(logits, jcfg, e_pad, groups)
    e, t, _ = x_e.shape
    assert (e, t) == (e_pad, groups * cap)

    # reached experts and prefix fills: group g's rows of expert e are
    # [g*cap, g*cap + fill) nonzero, the rest of its cap rows zero
    nonzero = (x_e != 0).any(-1).reshape(e, groups, cap).numpy()
    want = np.arange(cap)[None, None, :] < fill[:, :, None]
    np.testing.assert_array_equal(nonzero, want)
    reached = fill.sum(1) > 0
    if mode == "decode":
        assert reached.sum() < e                      # the skip has work to save

    # the skip by hand: SWAP holds an expert as one tile; ROWS tiles of
    # 128 rows, live up to the group's prefix (one group in training)
    plan, _, tile, ntt = tmg.tile_plan(t)
    assert plan == ("rows" if t > tmg.SWAP_MAX_T else "swap")
    if plan == "swap":
        live_by_hand = reached[:, None]
    else:
        assert groups == 1
        live_by_hand = np.arange(ntt)[None, :] < -(-fill[:, :1] // tile)
    live = ref.moe_gmm_active_tiles_ref(x_e, tile).numpy()
    np.testing.assert_array_equal(live, live_by_hand)
    assert int((~live).sum()) == int(ntt * e - live_by_hand.sum())
    assert int((~live.any(1)).sum()) == int((~reached).sum())

    # exact zeros on every zero row: Pallas (interpret), the JAX oracle,
    # the port's plain version
    ws = [params[k] for k in ("w_gate", "w_up", "w_down")]
    zero_rows = ~nonzero.reshape(e, t)
    dead_rows = np.repeat(~live, tile, axis=1)[:, :t]
    assert not (dead_rows & ~zero_rows).any()         # a dead tile is zero rows
    jx = [jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in (x_e, *ws)]
    outs = {"pallas": np.asarray(moe_gmm_pallas(*jx, interpret=True), np.float32),
            "jax_ref": np.asarray(jref.moe_gmm_ref(*jx), np.float32),
            "port_ref": ref.moe_gmm_ref(x_e, *ws).float().numpy()}
    for which, out in outs.items():
        assert (out[zero_rows] == 0).all(), which
        assert np.isfinite(out).all(), which
    live_rows = ~zero_rows
    assert np.abs(outs["pallas"][live_rows]).max() > 0


@pytest.mark.parametrize("tile", [1, 2, 3, 8, 128])
def test_active_tiles_ref_counts(tile):
    """Tiles of `tile` rows past a ragged T, -0 counted as zero, NaN as
    live."""
    x = torch.zeros((4, 10, 16), dtype=torch.bfloat16)
    x[0, 9, 3] = 1.0                                  # the last row of expert 0
    x[1, 0, 0] = -0.0                                 # only a signed zero
    x[2, 4, 15] = float("nan")
    live = ref.moe_gmm_active_tiles_ref(x, tile)
    ntt = -(-10 // tile)
    assert live.shape == (4, ntt)
    want = torch.zeros((4, ntt), dtype=torch.bool)
    want[0, 9 // tile] = True
    want[2, 4 // tile] = True
    assert torch.equal(live, want)
    assert int((~live.any(1)).sum()) == 2
