"""Tiny configurations and mixes for the CPU tests: the cells' own
files with the widths cut to a size a test run holds (only here)."""
from __future__ import annotations

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from perfbench.harness import card, spec
from perfbench.harness.result import Context

TINY = {
    "deepseek-v3": dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4,
                        qk_nope_head_dim=16, v_head_dim=16, qk_rope_head_dim=8,
                        kv_lora_rank=32, q_lora_rank=32, n_routed_experts=8,
                        num_experts_per_tok=2, moe_intermediate_size=32,
                        intermediate_size=128, vocab_size=512),
    "ai21-jamba2-mini": dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
                             intermediate_size=96, num_experts=4, mamba_dt_rank=4,
                             vocab_size=512, num_hidden_layers=8),
}
TINY_MIX = {"clients": 4, "max_batch": 4, "max_seq": 64, "levels": 8, "check_requests": 4,
            "prompt": {"dist": "lognormal", "median": 16, "sigma": 0.4, "min": 8, "max": 24},
            "output": {"dist": "uniform", "min": 4, "max": 12}}


def bench():
    return spec.Bench()


def context(cell_name: str, seed: int = 7, seconds: float = 1.0, trace: bool = False,
            **kw) -> Context:
    b = bench()
    cell = b.cell(cell_name)
    cfg = b.config_file(cell["config"])
    run = spec.run_values(cfg)
    run.update(TINY[cfg["name"]])
    mix = dict(spec.traffic(cell["traffic"]), **TINY_MIX)
    return Context(cell=cell, config=cfg, run=run, traffic=mix, seed=seed,
                   seconds=seconds, trace=trace, t_start=time.perf_counter(), **kw)


def run(cell_name: str, **kw):
    """One run of the cell's driver at tiny widths, on the CPU in place of
    the card: the driver's one look-up of the card is replaced here."""
    ctx = context(cell_name, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(card, "DEVICE", torch.device("cpu"))
        mp.setattr(card, "sync", lambda: None)
        mp.setattr(card, "peak_bytes", lambda: 0)
        mp.setattr(card, "name", lambda: "cpu")
        mp.setattr(card, "release", lambda: None)
        mp.setattr(card, "profiler", lambda: profile(activities=[ProfilerActivity.CPU]))
        return spec.driver(ctx.traffic["driver"]).run(ctx)
