"""The weights of a run, made by the benchmark from the seed, in the
layout ``repro_torch`` takes (``models.model.init_model``'s tree: matmul
weights [in, out], a dict per layer). They are the benchmark's inputs:
the engine is handed them, and the plain reference reads the same
tensors. Each layer's weights of one dtype are drawn on the device into
one flat buffer, in calls of at most 2**30 values of one
``torch.Generator``, and then scaled leaf by leaf in place.

Scales keep every activation near unit size at any width: a matmul
weight N(0, 1/fan_in), the embedding N(0, 1), the head N(0, 1/D) (so the
logits are near N(0, 1)), norm scales N(0, 0.1^2) around the stored
``1 + scale``, the router N(0, 1/D) in float32. Mamba's A is the S4D-real
start (log 1..d_state, float32), its skip D ones, its step sizes'
bias softplus^-1 of exp(U(log 1e-3, log 1e-1)) (Mamba's start)."""
from __future__ import annotations

import math

import torch

CHUNK = 1 << 30
ALIGN = 64          # elements: every leaf starts 16-byte aligned


def leaves(cfg, spec) -> dict:
    """{group: {name: (shape, dtype, init)}} of one layer of the port, with
    init ("normal", std) | ("ones",) | ("log_a",) | ("dt_bias",)."""
    dt = getattr(torch, cfg.dtype)
    f32 = torch.float32
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    n = lambda fan: ("normal", fan ** -0.5)
    out = {"norm1": {"scale": ((d,), f32, ("normal", 0.1))},
           "norm2": {"scale": ((d,), f32, ("normal", 0.1))}}
    if spec.mixer == "mamba":
        mc = cfg.mamba
        di, ds, dc = mc.expand * d, mc.d_state, mc.d_conv
        dtr = mc.dt_rank or -(-d // 16)
        out["mixer"] = {
            "w_x": ((d, di), dt, n(d)), "w_z": ((d, di), dt, n(d)),
            "conv_w": ((dc, di), dt, n(dc)), "conv_b": ((di,), dt, ("normal", 0.1)),
            "w_bc": ((di, 2 * ds), dt, n(di)), "w_dt_in": ((di, dtr), dt, n(di)),
            "w_dt": ((dtr, di), dt, n(dtr)), "dt_bias": ((di,), dt, ("dt_bias",)),
            "log_a": ((di, ds), f32, ("log_a",)), "d_skip": ((di,), f32, ("ones",)),
            "w_out": ((di, d), dt, n(di))}
    elif cfg.attn_kind == "mla":
        r, qr, rp = cfg.mla_kv_lora_rank, cfg.mla_q_lora_rank, cfg.mla_rope_head_dim
        out["mixer"] = {
            "w_dq": ((d, qr), dt, n(d)), "w_uq": ((qr, H * (hd + rp)), dt, n(qr)),
            "w_dkv": ((d, r), dt, n(d)), "w_kr": ((d, rp), dt, n(d)),
            "w_uk": ((r, H * hd), dt, n(r)), "w_uv": ((r, H * hd), dt, n(r)),
            "w_o": ((H * hd, d), dt, n(H * hd)),
            "q_norm": ((qr,), dt, ("normal", 0.1)), "kv_norm": ((r,), dt, ("normal", 0.1))}
    else:
        kv = cfg.num_kv_heads
        out["mixer"] = {"w_q": ((d, H * hd), dt, n(d)), "w_k": ((d, kv, hd), dt, n(d)),
                        "w_v": ((d, kv, hd), dt, n(d)), "w_o": ((H * hd, d), dt, n(H * hd))}
    if spec.ffn == "moe":
        m = cfg.moe
        e, f = m.num_experts, m.d_expert
        ffn = {"router": ((d, e), f32, n(d)), "w_gate": ((e, d, f), dt, n(d)),
               "w_up": ((e, d, f), dt, n(d)), "w_down": ((e, f, d), dt, n(f))}
        if m.num_shared_experts:
            fs = m.d_shared_expert * m.num_shared_experts
            ffn.update({"w_shared_gate": ((d, fs), dt, n(d)),
                        "w_shared_up": ((d, fs), dt, n(d)),
                        "w_shared_down": ((fs, d), dt, n(fs))})
        out["ffn"] = ffn
    else:
        out["ffn"] = {"w_gate": ((d, cfg.d_ff), dt, n(d)), "w_up": ((d, cfg.d_ff), dt, n(d)),
                      "w_out": ((cfg.d_ff, d), dt, n(cfg.d_ff))}
    return {g: out[g] for g in ("norm1", "mixer", "norm2", "ffn")}


def padded_vocab(cfg) -> int:
    return -(-cfg.vocab_size // 256) * 256


def _draw(tree: dict, gen: torch.Generator) -> dict:
    """Materialise one piece's leaves: a flat buffer per dtype, normal
    draws in chunks, then each leaf's scale or constant in place."""
    flat = [(g, k, *spec) for g, grp in tree.items() for k, spec in grp.items()]
    dev = gen.device
    bufs, offs = {}, {}
    for dtype in sorted({dt for *_, dt, _ in flat}, key=str):
        size = 0
        for g, k, shape, dt, _ in flat:
            if dt == dtype:
                offs[(g, k)] = size
                size += -(-math.prod(shape) // ALIGN) * ALIGN
        buf = torch.empty(size, dtype=dtype, device=dev)
        for a in range(0, size, CHUNK):
            buf[a:a + CHUNK].normal_(generator=gen)
        bufs[dtype] = buf
    out = {}
    for g, k, shape, dt, init in flat:
        o = offs[(g, k)]
        t = bufs[dt][o:o + math.prod(shape)].view(shape)
        if init[0] == "normal":
            t.mul_(init[1])
        elif init[0] == "ones":
            t.fill_(1.0)
        elif init[0] == "log_a":
            t.copy_(torch.log(torch.arange(1, shape[1] + 1, dtype=torch.float32,
                                           device=dev)).expand(shape))
        elif init[0] == "dt_bias":
            u = torch.rand(shape, generator=gen, device=dev, dtype=torch.float32)
            step = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
            t.copy_(step + torch.log(-torch.expm1(-step)))
        out.setdefault(g, {})[k] = t
    return out


def draw(cfg, seed: int, device) -> dict:
    """The params tree of ``cfg`` (a repro_torch ModelConfig, no encoder)
    from `seed`, on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    dt = getattr(torch, cfg.dtype)
    v, d = padded_vocab(cfg), cfg.d_model
    embed = {"embed": {"table": ((v, d), dt, ("normal", 1.0))}}
    if not cfg.tie_embeddings:
        embed["embed"]["head"] = ((d, v), dt, ("normal", d ** -0.5))
    params = {"embed": _draw(embed, gen)["embed"]}
    params["stack"] = [_draw(leaves(cfg, spec), gen) for spec in cfg.layer_specs]
    params["final_norm"] = _draw({"n": {"scale": ((d,), torch.float32,
                                                  ("normal", 0.1))}}, gen)["n"]
    return params
