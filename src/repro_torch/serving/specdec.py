"""Speculative decoding runtime (paper sections 2.3, 3.3).

Port of ``repro.serving.specdec``. Medusa-style multi-head drafting:
`spec_m - 1` extra linear heads on the final hidden state propose
candidate continuations; verification feeds the current token plus the
draft through the target model in `spec_m` sequential decode steps (the
JAX step's ``lax.scan``), accepts the longest prefix where the model's own
greedy prediction agrees with the draft, and rolls the cache back to the
acceptance point:

  * positional cache leaves (attention K/V at absolute positions) need no
    rollback: writes beyond the accepted position are masked by the
    attention length and overwritten later (serving/kvcache.py);
  * recurrent leaves (sliding-window ring buffers, Mamba's conv and SSM
    state, RWKV's WKV state and both token shifts) are copied after every
    verify step, and each row's state is restored from the copy at that
    row's own acceptance point (``kvcache.select_history``).

The JAX decoder passes no ``enc_len``, so neither package speculates on
an encoder-decoder (the port's cross-attention decode raises).

The emitted sequence equals plain greedy decoding for any draft quality
when the batch accepts alike. ``generate`` commits the minimum acceptance
over the batch, as the JAX decoder does, while the rollback restores each
row at its own acceptance: at B > 1 with recurrent leaves and mixed
acceptance, a row that accepted more than the minimum continues from a
state ahead of its committed tokens. The port mirrors this reference
behaviour.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf
from repro_torch.models.layers import common
from repro_torch.serving import kvcache
from repro_torch.sharding.dist import Dist, NullDist
from repro_torch.sharding.plans import ShardingPlan, null_plan


# ---------------------------------------------------------------------------
# draft heads (Medusa-style)
# ---------------------------------------------------------------------------

def init_draft_heads(cfg: ModelConfig, gen: torch.Generator, n_heads: int):
    """n_heads linear heads d_model -> vocab predicting tokens at +2..+n+1,
    drawn from `gen` on its device."""
    return [common.normal((cfg.d_model, cfg.vocab_size), common.dtype_of(cfg),
                          gen, cfg.d_model ** -0.5) for _ in range(n_heads)]


def draft_from_hidden(heads, hidden) -> torch.Tensor:
    """hidden: [B, 1, D] -> draft tokens [B, n_heads] int32."""
    toks = [torch.argmax(hidden[:, 0] @ w, dim=-1).to(torch.int32)
            for w in heads]
    return torch.stack(toks, dim=1)


# ---------------------------------------------------------------------------
# verification + top-level SD loop
# ---------------------------------------------------------------------------

class SDDecoder:
    """Greedy decoding accelerated by self-drafted speculation.

    Draft source options:
      heads   Medusa linear heads (untrained here; mechanics + interface),
              drawn from a generator seeded with `seed` on `device`, or
              given as `heads`
      fixed   caller-provided draft_fn(params, caches, cur_tok, pos) ->
              [B, spec_m - 1] (an oracle draft is one)
    """

    def __init__(self, cfg: ModelConfig, params, *, spec_m: int = 4,
                 plan: Optional[ShardingPlan] = None,
                 dist: Optional[Dist] = None,
                 draft_fn: Optional[Callable] = None, seed: int = 0,
                 heads: Optional[List[torch.Tensor]] = None, device="cuda"):
        if spec_m < 2:
            raise ValueError(f"spec_m {spec_m} < 2")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.plan = plan or null_plan("decode")
        self.dist = dist or NullDist()
        self.spec_m = spec_m
        if heads is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            heads = init_draft_heads(cfg, gen, spec_m - 1)
        self.heads = heads
        self.draft_fn = draft_fn

    def _decode_hidden(self, caches, tokens, pos):
        """decode_step that also returns the final hidden state."""
        cfg, plan, dist, params = self.cfg, self.plan, self.dist, self.params
        x = common.embed(params["embed"], tokens, cfg, plan, dist)
        x, nc = tf.apply_stack(params["stack"], x, cfg, plan, dist,
                               mode="decode", caches=caches, pos=pos)
        x = common.rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        logits = common.lm_logits(params["embed"], x, cfg, plan, dist)
        tok = common.greedy_sample(logits, cfg, plan, dist)
        return tok, nc, x

    def step(self, caches, cur_tok, draft, pos: int):
        """Verify `draft` [B, spec_m - 1] after `cur_tok` [B, 1] at `pos`.
        Returns (tokens [B, spec_m], n_accept [B], caches): the first
        n_accept tokens of each row are its greedy continuation. Positional
        leaves are written in place; recurrent ones come back restored at
        each row's acceptance point."""
        feed = torch.cat([cur_tok, draft], dim=1)
        preds, history = [], []
        for i in range(self.spec_m):
            nt, caches, _ = self._decode_hidden(caches, feed[:, i:i + 1],
                                                pos + i)
            preds.append(nt[:, 0])
            history.append(kvcache.snapshot_recurrent(self.cfg, caches))
        preds = torch.stack(preds, dim=1)                      # [B, spec_m]

        agree = (draft == preds[:, :-1]).to(torch.int32)
        n_agree = torch.cumprod(agree, dim=1).sum(dim=1).long()  # [B]
        idx = torch.arange(self.spec_m, device=preds.device)[None, :]
        own = torch.gather(preds, 1, n_agree[:, None])
        draft_pad = torch.cat([draft, torch.zeros_like(draft[:, :1])], dim=1)
        tokens = torch.where(idx < n_agree[:, None], draft_pad, own)
        caches = kvcache.select_history(self.cfg, caches, history, n_agree)
        return tokens, n_agree + 1, caches

    def draft(self, caches, cur_tok, pos) -> torch.Tensor:
        """Produce [B, spec_m - 1] draft tokens."""
        if self.draft_fn is not None:
            return self.draft_fn(self.params, caches, cur_tok, pos)
        # the heads path needs the last hidden state; approximate it with
        # the embedding of the current token (untrained heads anyway)
        h = common.embed(self.params["embed"], cur_tok, self.cfg, self.plan,
                         self.dist)
        return draft_from_hidden(self.heads, h)

    def generate(self, caches, first_tok, start_pos: int, n_tokens: int):
        """Greedy-equivalent generation of ~n_tokens (may emit a few more,
        then truncates). Returns (tokens [B, n_tokens], caches, stats)."""
        out: List[torch.Tensor] = []
        cur = first_tok
        pos = start_pos
        accepted = []
        while sum(int(t.shape[1]) for t in out) < n_tokens:
            d = self.draft(caches, cur, pos)
            toks, n_acc, caches = self.step(caches, cur, d, pos)
            # engine semantics need uniform progress: commit the MIN accept
            # across the batch
            k = int(n_acc.min())
            out.append(toks[:, :k])
            accepted.append(k)
            cur = toks[:, k - 1:k]
            pos += k
        tokens = torch.cat(out, dim=1)[:, :n_tokens]
        stats = {"iterations": len(accepted),
                 "mean_accepted": sum(accepted) / len(accepted)}
        return tokens, caches, stats
