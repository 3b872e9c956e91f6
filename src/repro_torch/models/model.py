"""Model API: init / train loss / prefill / decode / cache construction.

Port of ``repro.models.model`` for the attention, MLA, Mamba and RWKV
families, the ViT-patch frontend and the encoder-decoder. Parameters are
a dict ``{"embed", "stack": [per-layer dicts], "final_norm"}``, plus
``"encoder"`` (per-layer dicts) and ``"enc_norm"`` for an encoder-decoder;
caches a list with one ``{group: {...}}`` per decoder layer: the
``"mixer"`` group is ``k``, ``v`` for GQA (a ring buffer for a
sliding-window layer), the latent ``c_kv``, ``k_rope`` for MLA, ``conv``,
``ssm`` for Mamba, ``wkv``, ``shift`` for RWKV; an RWKV layer also has an
``"ffn"`` group (``shift``) and a decoder layer of an encoder-decoder a
``"cross"`` group (the encoder's ``k``, ``v``). Entry points run on
``device="cuda"`` unless told otherwise, and raise when there is no card.
Under a sharded plan every function runs on one rank's shards: tokens
[B_loc, S_loc] in prefill, [B_loc, 1] in decode, logits vocab-sharded;
``launch.steps`` binds them to a rank's ``Dist``.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch import resolve_device, tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.models.layers import common
from repro_torch.sharding.dist import Dist, NullDist
from repro_torch.sharding.plans import ShardingPlan, null_plan
from repro_torch.sharding.specs import cache_specs, local_shape


def init_model(cfg: ModelConfig, plan: Optional[ShardingPlan] = None, *,
               seed: int = 0, device="cuda", shard=None):
    """Random weights at the config's widths, drawn on `device` from a
    ``torch.Generator`` seeded with `seed`. The CPU and the card draw
    different numbers from one seed. Every leaf is drawn at its global
    shape; `shard(path, tree)`, when given, maps each piece as soon as it
    is drawn (the embedding, each layer, the norms), so that a rank keeps
    only its shards and never holds the whole model: path is ("embed",),
    ("stack", i), ("final_norm",), ("encoder", i) or ("enc_norm",)."""
    dev = resolve_device(device)
    plan = plan or null_plan("decode")
    shard = shard or (lambda path, tree: tree)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = {"embed": shard(("embed",), common.init_embedding(cfg, plan, gen))}
    params["stack"] = tf.init_stack(cfg, plan, gen, cross=cfg.is_encoder_decoder,
                                    each=lambda i, p: shard(("stack", i), p))
    params["final_norm"] = shard(("final_norm",), common.init_rms_norm(
        cfg.d_model, torch.float32, dev))
    if cfg.is_encoder_decoder:
        params["encoder"] = tf.init_stack(cfg, plan, gen,
                                          n_layers=cfg.encoder_layers,
                                          period=tf.ENCODER_PERIOD,
                                          each=lambda i, p: shard(("encoder", i), p))
        params["enc_norm"] = shard(("enc_norm",), common.init_rms_norm(
            cfg.d_model, torch.float32, dev))
    return params


def _plan_dist(plan, dist, kind):
    return plan or null_plan(kind), dist or NullDist()


def _embed_inputs(params, batch, cfg, plan: ShardingPlan, dist: Dist):
    """x [B, S_loc, D] from this rank's tokens (all of them on one device);
    with the ``vit_patches`` frontend and ``batch["patches"]`` [B, Pf, D],
    patch p replaces global position p for p < min(Pf, S), on whichever
    sequence rank holds it (as the JAX function)."""
    x = common.embed(params["embed"], batch["tokens"], cfg, plan, dist,
                     seq_axis=plan.seq_axis)
    if cfg.frontend == "vit_patches" and "patches" in batch:
        s_loc = x.shape[1]
        start = dist.index(plan.seq_axis) * s_loc
        window = batch["patches"][:, start:start + s_loc].to(x.dtype)
        x = torch.cat([window, x[:, window.shape[1]:]], dim=1)
    return x


def _encode(params, frames, cfg, plan: ShardingPlan, dist: Dist, param_specs=None):
    """The encoder over frames [B, Se_loc, D] (already embedded: the audio
    frontend is a stub, as in JAX), this rank's positions of the sequence
    axis, in mode "train" (so causal, with RoPE: the JAX function's
    choice), then ``enc_norm``. `param_specs`: the encoder layers' specs,
    whose FSDP shards each layer gathers where it runs (``apply_stack``)."""
    x, _ = tf.apply_stack(params["encoder"], frames.to(common.dtype_of(cfg)),
                          cfg, plan, dist, mode="train",
                          n_layers=cfg.encoder_layers, period=tf.ENCODER_PERIOD,
                          param_specs=param_specs)
    return common.rms_norm(x, params["enc_norm"]["scale"], cfg.norm_eps)


def train_loss(params, batch, cfg: ModelConfig, plan: Optional[ShardingPlan] = None,
               dist: Optional[Dist] = None, *, remat: bool = True,
               param_specs=None, capacity_groups=None):
    """batch: tokens [B, S] (+ "patches", or "frames" [B, S, D]), this
    rank's block.
    The global-mean LM loss: each position predicts the next token, the
    last position is masked; with experts, plus ``router_aux_loss_coef``
    times the load-balance loss averaged over the layers (and over the
    ranks, each of which routes its own tokens). A scalar f32 tensor, the
    same on every rank.

    Sequence-sharded (Megatron-SP): after the final norm the hidden states
    and the ids are all-gathered over the sequence, so that every rank of
    the vocab axis holds the logits of the same positions in its vocab
    shard; the cross entropy's max and sums over the vocab axis then
    reduce one position at a time, and the token losses are summed over
    the batch axes only (every sequence rank holds all positions). The JAX
    function reduces the logits of *different* position chunks over the
    vocab axis, which is also the sequence axis (ROADMAP queue 3).
    With `param_specs` on a plan with ``fsdp_axis``, the FSDP shards of
    ``embed``, ``final_norm`` (``enc_norm``) and each layer are gathered
    where they are used. `capacity_groups`: the MoE capacity groups of
    ``moe.moe_ffn`` (default one), to reproduce a sharded run's drops on
    one device."""
    plan, dist = _plan_dist(plan, dist, "train")
    stack_specs = enc_specs = None
    if param_specs is not None and plan.fsdp_axis is not None:
        params = dict(params)
        for k in ("embed", "final_norm", "enc_norm"):
            if k in params:
                params[k] = common.fsdp_gather(params[k], param_specs[k], plan, dist)
        stack_specs, enc_specs = param_specs["stack"], param_specs.get("encoder")
    x = _embed_inputs(params, batch, cfg, plan, dist)
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = _encode(params, batch["frames"], cfg, plan, dist, enc_specs)
    x, _, aux = tf.apply_stack(params["stack"], x, cfg, plan, dist, mode="train",
                               collect_aux=True, remat=remat, enc_out=enc_out,
                               param_specs=stack_specs,
                               capacity_groups=capacity_groups)
    x = common.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
    tokens = batch["tokens"]
    seq_ax = plan.seq_axis
    if dist.size(seq_ax) > 1:
        x = dist.all_gather(x, seq_ax, dim=1)                      # [B, S, D]
        tokens = dist.all_gather(tokens, seq_ax, dim=1)
    logits = common.lm_logits(params["embed"], x, cfg, plan, dist)
    # labels = next token; the last position is masked
    S = tokens.shape[1]
    labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])], dim=1)
    w = (torch.arange(S, device=tokens.device) < S - 1).float()[None, :]
    token_loss = common.xent_per_token(logits, labels, plan, dist) * w

    loss_sum, cnt = token_loss.sum(), w.expand_as(token_loss).sum()
    for ax in plan.batch_axes or ():
        loss_sum, cnt = dist.psum(loss_sum, ax), dist.psum(cnt, ax)
    loss = loss_sum / torch.clamp(cnt, min=1.0)
    if cfg.moe is not None and torch.is_tensor(aux):   # a stack with a MoE layer
        aux_mean = aux / max(cfg.num_layers, 1)
        for ax in (plan.batch_axes or ()) + ((seq_ax,) if seq_ax else ()):
            aux_mean = dist.psum(aux_mean, ax) / dist.size(ax)
        loss = loss + cfg.moe.router_aux_loss_coef * aux_mean
    return loss


def _prefill(params, batch, cfg: ModelConfig, plan: ShardingPlan, dist: Dist,
             capacity_groups, sample: bool):
    """``prefill_logits``; with `sample` the greedy token in place of the
    logits, inside the same ``lm.head`` span."""
    with tracing.span("lm.embed"):
        x = _embed_inputs(params, batch, cfg, plan, dist)
    enc_out = None
    if cfg.is_encoder_decoder:
        enc_out = _encode(params, batch["frames"], cfg, plan, dist)
    x, caches = tf.apply_stack(params["stack"], x, cfg, plan, dist,
                               mode="prefill", enc_out=enc_out,
                               capacity_groups=capacity_groups)
    with tracing.span("lm.head"):
        x = common.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        last = x[:, -1:]
        n_seq = dist.size(plan.seq_axis)
        if n_seq > 1:
            mine = dist.index(plan.seq_axis) == n_seq - 1
            last = dist.psum(last if mine else torch.zeros_like(last), plan.seq_axis)
        logits = common.lm_logits(params["embed"], last, cfg, plan, dist)
        return (common.greedy_sample(logits, cfg, plan, dist) if sample else logits), caches


def prefill_logits(params, batch, cfg: ModelConfig,
                   plan: Optional[ShardingPlan] = None,
                   dist: Optional[Dist] = None, *, capacity_groups=None):
    """batch: {"tokens": [B, S]}, with "patches" [B, Pf, D] (vit_patches)
    or "frames" [B, Se, D] (encoder-decoder; on a sequence-sharded plan
    this rank's positions, as the tokens). Returns (f32 logits of the last
    position [B, 1, V_pad], caches). On a sequence-sharded plan the
    last position lives on the last sequence rank, which broadcasts its
    final hidden state (a psum of it and zeros). `capacity_groups`: the
    MoE capacity groups (``moe.moe_ffn``; default one)."""
    plan, dist = _plan_dist(plan, dist, "prefill")
    return _prefill(params, batch, cfg, plan, dist, capacity_groups, sample=False)


def prefill(params, batch, cfg: ModelConfig, plan: Optional[ShardingPlan] = None,
            dist: Optional[Dist] = None):
    """Returns (next_token [B, 1] int32, caches). Fills the KV caches."""
    plan, dist = _plan_dist(plan, dist, "prefill")
    return _prefill(params, batch, cfg, plan, dist, None, sample=True)


def _decode(params, caches, tokens, pos, cfg: ModelConfig, plan: ShardingPlan,
            dist: Dist, enc_len: int, capacity_groups, sample: bool):
    """``decode_logits``; with `sample` the greedy token in place of the
    logits, inside the same ``lm.head`` span."""
    with tracing.span("lm.embed"):
        x = common.embed(params["embed"], tokens, cfg, plan, dist)
    x, caches = tf.apply_stack(params["stack"], x, cfg, plan, dist,
                               mode="decode", caches=caches, pos=pos,
                               enc_len=enc_len, capacity_groups=capacity_groups)
    with tracing.span("lm.head"):
        x = common.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        logits = common.lm_logits(params["embed"], x, cfg, plan, dist)
        return (common.greedy_sample(logits, cfg, plan, dist) if sample else logits), caches


def decode_logits(params, caches, tokens, pos, cfg: ModelConfig,
                  plan: Optional[ShardingPlan] = None,
                  dist: Optional[Dist] = None, *, enc_len: int = 0,
                  capacity_groups=None):
    """tokens [B, 1] -> (f32 logits [B, 1, V_pad], caches). pos: a scalar
    position for the whole batch (the JAX semantics: one MoE capacity
    group over the batch) or a [B] tensor, one position per slot (each slot
    its own capacity group, as the JAX engine's vmap); `capacity_groups`
    overrides that rule. enc_len: the encoder positions cross-attention
    reads (encoder-decoder only). Caches are written in place."""
    plan, dist = _plan_dist(plan, dist, "decode")
    return _decode(params, caches, tokens, pos, cfg, plan, dist, enc_len,
                   capacity_groups, sample=False)


def decode_step(params, caches, tokens, pos, cfg: ModelConfig,
                plan: Optional[ShardingPlan] = None,
                dist: Optional[Dist] = None, *, enc_len: int = 0):
    """One serving step: tokens [B, 1] -> (next token [B, 1], caches)."""
    plan, dist = _plan_dist(plan, dist, "decode")
    return _decode(params, caches, tokens, pos, cfg, plan, dist, enc_len, None,
                   sample=True)


def init_cache(cfg: ModelConfig, plan: Optional[ShardingPlan] = None,
               batch: int = 1, seq: int = 1, enc_seq: int = 0, *,
               device="cuda", mesh=None) -> List[dict]:
    """Zero-filled decode caches, per layer: k, v [batch, KV, seq, hd], or a
    ring [batch, KV, min(window, seq), hd] for a sliding-window layer; MLA's
    c_kv [batch, seq, r] and k_rope [batch, seq, rp]; Mamba's conv
    [batch, d_conv - 1, d_inner] and ssm [batch, d_inner, d_state]; RWKV's
    wkv [batch, nh, hd, hd] and shift [batch, D], with the channel mix's
    shift [batch, D] in the "ffn" group; for an encoder-decoder, the
    "cross" group's k, v [batch, KV, enc_seq, hd]. ssm and wkv are float32
    in any model dtype. These are the global shapes; with `mesh`, each leaf
    is this rank's shard of it under `plan`'s ``specs.cache_specs``."""
    dev = resolve_device(device)
    dt = common.dtype_of(cfg)
    layer_specs = cache_specs(cfg, plan) if mesh is not None else None

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    caches = []
    for i, spec in enumerate(cfg.layer_specs):
        tf.check_supported(spec, cfg)
        if spec.mixer == "mamba":
            mc = cfg.mamba
            di = mc.expand * cfg.d_model
            c = {"conv": ((batch, mc.d_conv - 1, di), dt),
                 "ssm": ((batch, di, mc.d_state), torch.float32)}
        elif spec.mixer == "rwkv":
            hd = cfg.rwkv.head_dim
            c = {"wkv": ((batch, cfg.d_model // hd, hd, hd), torch.float32),
                 "shift": ((batch, cfg.d_model), dt)}
        elif cfg.attn_kind == "mla":
            c = {"c_kv": ((batch, seq, cfg.mla_kv_lora_rank), dt),
                 "k_rope": ((batch, seq, cfg.mla_rope_head_dim), dt)}
        else:
            rows = seq
            if spec.mixer == "attn_local" and cfg.sliding_window:
                rows = min(cfg.sliding_window, seq)
            shape = (batch, cfg.num_kv_heads, rows, cfg.head_dim)
            c = {"k": (shape, dt), "v": (shape, dt)}
        layer = {"mixer": c}
        if spec.mixer == "rwkv":
            layer["ffn"] = {"shift": ((batch, cfg.d_model), dt)}
        if cfg.is_encoder_decoder:
            shape = (batch, cfg.num_kv_heads, enc_seq, cfg.head_dim)
            layer["cross"] = {"k": (shape, dt), "v": (shape, dt)}
        if layer_specs is not None:
            layer = {g: {n: (local_shape(sh, layer_specs[i][g][n], mesh), d)
                         for n, (sh, d) in leaves.items()}
                     for g, leaves in layer.items()}
        caches.append({g: {n: zeros(sh, d) for n, (sh, d) in leaves.items()}
                       for g, leaves in layer.items()})
    return caches
