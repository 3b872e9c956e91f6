"""Continuous-batching serving engine.

Port of ``repro.serving.engine``. A fixed pool of `max_batch` slots over a
fixed-capacity cache. Requests are admitted into free slots (prefill at
the request's length, cache padded to capacity and copied into the slot);
every decode wave advances ALL slots one token with per-slot positions.
Where the JAX engine vmaps a one-slot decode step over the slots, the port
runs one batched ``decode_step`` with a [max_batch] position vector, which
keeps each slot's attention length and MoE capacity group its own. Slots
free as requests hit EOS or their token budget, making room for waiting
requests.

An encoder-decoder is served as the JAX engine serves it: each prefill
encodes zero frames [1, L, D] (the audio frontend is a stub), its cross
cache of L positions is padded with zeros to `max_seq` like every
positional leaf, and every decode wave attends over all `max_seq` of
them (``enc_len = max_seq``), the zero keys included. A ViT-patch model
is served from its tokens alone, as in JAX.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional

import torch

from repro_torch import resolve_device, tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models.layers.common import dtype_of
from repro_torch.serving import kvcache
from repro_torch.sharding.dist import Dist, NullDist
from repro_torch.sharding.plans import ShardingPlan, null_plan


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new_tokens: int
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class Engine:
    """Single-device engine (NullDist) on `device` (the card by default)."""

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 4,
                 max_seq: int = 256, eos_id: int = 0,
                 plan: Optional[ShardingPlan] = None,
                 dist: Optional[Dist] = None, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.plan = plan or null_plan("decode")
        self.dist = dist or NullDist()
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.eos_id = eos_id

        # the JAX engine's cross-attention length: the cross cache's capacity
        self.enc_len = max_seq if cfg.is_encoder_decoder else 0
        self.caches = M.init_cache(cfg, self.plan, max_batch, max_seq,
                                   self.enc_len, device=self.device)
        self.pos = torch.zeros((max_batch,), dtype=torch.int32, device=self.device)
        self.last_tok = torch.zeros((max_batch, 1), dtype=torch.int32,
                                    device=self.device)
        self.live = [False] * max_batch
        self.slots: List[Optional[Request]] = [None] * max_batch
        self.queue: deque[Request] = deque()
        self.finished: Dict[int, Request] = {}
        self._rid = 0

    # ------------------------------------------------------------------
    # request lifecycle
    # ------------------------------------------------------------------

    def submit(self, prompt: List[int], max_new_tokens: int = 32) -> int:
        rid = self._rid
        self._rid += 1
        self.queue.append(Request(rid, list(prompt), max_new_tokens))
        return rid

    def _admit(self):
        with tracing.span("serve.admit"):
            while self.queue and not all(self.live):
                slot = self.live.index(False)
                req = self.queue.popleft()
                tok0, sub = self._prefill_one(req.prompt)
                with tracing.span("serve.insert"):
                    kvcache.insert_slot(self.caches, sub, slot)
                self.pos[slot] = len(req.prompt)
                self.last_tok[slot] = tok0[0]
                req.generated = [int(tok0[0, 0])]
                self.slots[slot] = req
                self.live[slot] = True
                if req.generated[-1] == self.eos_id:
                    self._retire(slot)

    def _retire(self, slot: int):
        req = self.slots[slot]
        if req.generated and req.generated[-1] == self.eos_id:
            req.generated = req.generated[:-1]
        req.done = True
        self.finished[req.rid] = req
        self.slots[slot] = None
        self.live[slot] = False

    # ------------------------------------------------------------------
    # prefill
    # ------------------------------------------------------------------

    def _prefill_one(self, prompt: List[int]):
        """Prefill a single request; returns (first generated token [1, 1],
        capacity-padded cache with batch dim 1)."""
        L = len(prompt)
        if not 0 < L < self.max_seq:
            raise ValueError(f"prompt length {L} not in (0, {self.max_seq})")
        with tracing.span("serve.prefill"):
            tokens = torch.tensor([prompt], dtype=torch.int32, device=self.device)
            batch = {"tokens": tokens}
            if self.cfg.frontend == "audio_frames":
                batch["frames"] = torch.zeros((1, L, self.cfg.d_model),
                                              dtype=dtype_of(self.cfg),
                                              device=self.device)
            pplan = dataclasses.replace(self.plan, kind="prefill")
            tok, sub = M.prefill(self.params, batch, self.cfg, pplan, self.dist)
            tracing.count("serve.prefill_tokens", L)
            return tok, kvcache.pad_to_capacity(self.cfg, sub, L, self.max_seq)

    # ------------------------------------------------------------------
    # decode wave
    # ------------------------------------------------------------------

    def step(self) -> int:
        """One engine iteration: admit waiting requests, advance all slots
        one token. Returns the number of live slots stepped."""
        with tracing.span("serve.step"):
            self._admit()
            n_live = sum(self.live)
            if n_live == 0:
                return 0
            with tracing.span("serve.wave"):
                toks, self.caches = M.decode_step(self.params, self.caches,
                                                  self.last_tok, self.pos, self.cfg,
                                                  self.plan, self.dist,
                                                  enc_len=self.enc_len)
                self.last_tok = toks
                self.pos = self.pos + 1
            with tracing.span("serve.readback"):
                toks_host, pos_host = toks[:, 0].tolist(), self.pos.tolist()
            with tracing.span("serve.retire"):
                for slot, req in enumerate(self.slots):
                    if req is None:
                        continue
                    t = toks_host[slot]
                    req.generated.append(t)
                    ntok = len(req.generated) - 1       # first came from prefill
                    if (t == self.eos_id or ntok >= req.max_new_tokens
                            or pos_host[slot] >= self.max_seq - 1):
                        self._retire(slot)
            return n_live

    def run(self, max_steps: int = 10_000) -> Dict[int, List[int]]:
        """Drive until every submitted request completes."""
        for _ in range(max_steps):
            if not self.queue and not any(self.live):
                break
            self.step()
        return {rid: r.generated for rid, r in self.finished.items()}
