"""Plain reference of a DeepSeek-V3 configuration as repro_torch runs it:
the file's run values, departures included (softmax top-k routing with
renormalised gates and no groups, every layer MoE, plain RoPE, static
capacity in prefill). Float32, one sequence at a time; imports nothing
of the program."""
from __future__ import annotations

import torch

from perfbench.harness import work
from perfbench.reference import common as C


def mla(x, p, run, pos, W):
    """Multi-head latent attention over x [S, D], causal."""
    S = x.shape[0]
    H, hd, rp, vd = (run["num_attention_heads"], run["qk_nope_head_dim"],
                     run["qk_rope_head_dim"], run["v_head_dim"])
    eps, theta = run["rms_norm_eps"], float(run["rope_theta"])
    cq = C.rms_norm(x @ W(p["w_dq"]), p["q_norm"], eps)
    q = (cq @ W(p["w_uq"])).view(S, H, hd + rp)
    q = torch.cat([q[..., :hd], C.rope(q[..., hd:], pos, theta)], dim=-1)
    c = C.rms_norm(x @ W(p["w_dkv"]), p["kv_norm"], eps)
    k_rope = C.rope((x @ W(p["w_kr"]))[:, None, :], pos, theta)
    k = torch.cat([(c @ W(p["w_uk"])).view(S, H, hd), k_rope.expand(S, H, rp)], dim=-1)
    v = (c @ W(p["w_uv"])).view(S, H, vd)
    o = C.causal_attention(q, k, v, (hd + rp) ** -0.5)
    return o.reshape(S, H * vd) @ W(p["w_o"])


def forward(weights, tokens, prompt_len: int, run: dict, *, fp8: bool = False):
    """f32 logits [S - prompt_len + 1, vocab] of positions prompt_len - 1
    .. S - 1 of `tokens` [S]: the prompt is one capacity group, each later
    token one of its own."""
    W = C.Weights(fp8)
    eps = run["rms_norm_eps"]
    x = weights["embed"]["table"][tokens].float()
    pos = torch.arange(x.shape[0], device=x.device)
    for p in weights["stack"]:
        x = x + mla(C.rms_norm(x, p["norm1"]["scale"], eps), p["mixer"], run, pos, W)
        x = x + C.moe(C.rms_norm(x, p["norm2"]["scale"], eps), p["ffn"],
                      run["n_routed_experts"], run["num_experts_per_tok"],
                      run["capacity_factor"], [(0, prompt_len)], W)
    return C.logits(x[prompt_len - 1:], weights["final_norm"]["scale"],
                    weights["embed"]["head"], eps, run["vocab_size"], W)


def model_flops(run: dict) -> "work.ModelFlops":
    """The FLOP count of a token (``work.ModelFlops``) from the run values."""
    d, H = run["hidden_size"], run["num_attention_heads"]
    hd, rp, vd = run["qk_nope_head_dim"], run["qk_rope_head_dim"], run["v_head_dim"]
    r, qr = run["kv_lora_rank"], run["q_lora_rank"]
    f, e, k = run["moe_intermediate_size"], run["n_routed_experts"], run["num_experts_per_tok"]
    mla = d * qr + qr * H * (hd + rp) + d * r + d * rp + 2 * r * H * hd + H * vd * d
    moe = d * e + k * 3 * d * f + run["n_shared_experts"] * 3 * d * f
    layer = (mla + moe, 2.0 * H * (hd + rp) + 2.0 * H * vd, 0.0)
    return work.ModelFlops([layer] * run["num_hidden_layers"], d, run["vocab_size"])
