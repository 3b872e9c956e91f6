"""Plain reference of a Jamba configuration as repro_torch runs it: the
file's run values and departures (RoPE on the attention layers, no norms
on dt, B and C, renormalised top-2 gates, static capacity in prefill).
Float32, one sequence at a time; the selective scan in closed form over
chunks of 16 steps (a different algorithm from the program's doubling
scan). Imports nothing of the program."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.harness import work
from perfbench.reference import common as C

SCAN_CHUNK = 16


def kinds(run: dict, i: int):
    mixer = "attn" if i % run["attn_layer_period"] == run["attn_layer_offset"] else "mamba"
    ffn = "moe" if i % run["expert_layer_period"] == run["expert_layer_offset"] else "dense"
    return mixer, ffn


def attention(x, p, run, pos, W):
    S = x.shape[0]
    H, KV = run["num_attention_heads"], run["num_key_value_heads"]
    hd = run["hidden_size"] // H
    theta = float(run["rope_theta"])
    q = C.rope((x @ W(p["w_q"])).view(S, H, hd), pos, theta)
    k = C.rope(torch.einsum("sd,dkh->skh", x, W(p["w_k"])), pos, theta)
    v = torch.einsum("sd,dkh->skh", x, W(p["w_v"]))
    o = C.causal_attention(q, k, v, hd ** -0.5)
    return o.reshape(S, H * hd) @ W(p["w_o"])


def ssm_scan(u, dt, b, c, a):
    """y_t = C_t . h_t with h_t = exp(dt_t A) h_{t-1} + dt_t u_t B_t, h_0 = 0.
    u, dt [S, di]; b, c [S, ds]; a [di, ds]. Within a chunk of n steps
    h_t = exp(L_t) h_in + sum_{s <= t} exp(L_t - L_s) dt_s u_s B_s, with
    L_t the cumulative sum of dt A over the chunk."""
    S, di = u.shape
    h = torch.zeros((di, a.shape[1]), dtype=torch.float32, device=u.device)
    ys = []
    for c0 in range(0, S, SCAN_CHUNK):
        sl = slice(c0, min(S, c0 + SCAN_CHUNK))
        n = sl.stop - sl.start
        la = torch.cumsum(dt[sl, :, None] * a, dim=0)                   # [n, di, ds]
        dbu = (dt[sl] * u[sl])[:, :, None] * b[sl, None, :]            # [n, di, ds]
        later = torch.arange(n, device=u.device)[None, :] > torch.arange(n, device=u.device)[:, None]
        decay = (la[:, None] - la[None, :]).masked_fill(later[:, :, None, None], -torch.inf)
        hs = torch.einsum("tsdn,sdn->tdn", decay.exp(), dbu) + la.exp() * h
        ys.append(torch.einsum("tdn,tn->td", hs, c[sl]))
        h = hs[-1]
    return torch.cat(ys, dim=0)


def mamba(x, p, run, W):
    S = x.shape[0]
    ds, dc = run["mamba_d_state"], run["mamba_d_conv"]
    u, z = x @ W(p["w_x"]), x @ W(p["w_z"])
    up = F.pad(u, (0, 0, dc - 1, 0))
    conv_w = p["conv_w"].float()
    conv = sum(up[i:i + S] * conv_w[i] for i in range(dc)) + p["conv_b"].float()
    uc = F.silu(conv)
    bc = uc @ W(p["w_bc"])
    dt = F.softplus(uc @ W(p["w_dt_in"]) @ W(p["w_dt"]) + p["dt_bias"].float())
    y = ssm_scan(uc, dt, bc[:, :ds], bc[:, ds:], -torch.exp(p["log_a"].float()))
    y = (y + uc * p["d_skip"].float()) * F.silu(z)
    return y @ W(p["w_out"])


def forward(weights, tokens, prompt_len: int, run: dict, *, fp8: bool = False):
    """f32 logits [S - prompt_len + 1, vocab] of positions prompt_len - 1
    .. S - 1 of `tokens` [S]."""
    W = C.Weights(fp8)
    eps = run["rms_norm_eps"]
    x = weights["embed"]["table"][tokens].float()
    pos = torch.arange(x.shape[0], device=x.device)
    for i, p in enumerate(weights["stack"]):
        mixer, ffn = kinds(run, i)
        h = C.rms_norm(x, p["norm1"]["scale"], eps)
        x = x + (attention(h, p["mixer"], run, pos, W) if mixer == "attn"
                 else mamba(h, p["mixer"], run, W))
        h = C.rms_norm(x, p["norm2"]["scale"], eps)
        if ffn == "moe":
            x = x + C.moe(h, p["ffn"], run["num_experts"], run["num_experts_per_tok"],
                          run["capacity_factor"], [(0, prompt_len)], W)
        else:
            f = p["ffn"]
            x = x + C.swiglu(h, W(f["w_gate"]), W(f["w_up"]), W(f["w_out"]))
    return C.logits(x[prompt_len - 1:], weights["final_norm"]["scale"],
                    weights["embed"]["head"], eps, run["vocab_size"], W)


def model_flops(run: dict) -> "work.ModelFlops":
    """The FLOP count of a token (``work.ModelFlops``) from the run values."""
    d, H, kv = run["hidden_size"], run["num_attention_heads"], run["num_key_value_heads"]
    hd = d // H
    di, ds = run["mamba_expand"] * d, run["mamba_d_state"]
    dtr, dc = run["mamba_dt_rank"], run["mamba_d_conv"]
    f, e, k = run["intermediate_size"], run["num_experts"], run["num_experts_per_tok"]
    layers = []
    for i in range(run["num_hidden_layers"]):
        mixer, ffn = kinds(run, i)
        if mixer == "attn":
            w, a, o = d * H * hd + 2 * d * kv * hd + H * hd * d, 4.0 * H * hd, 0.0
        else:
            # the conv (dc MACs a channel) and the scan: exp(dt A) h, dt u B,
            # their sum and the contraction with C, about 6 a state
            w = 2 * d * di + di * 2 * ds + di * dtr + dtr * di + di * d
            a, o = 0.0, 2.0 * dc * di + 6.0 * di * ds
        w += d * e + k * 3 * d * f if ffn == "moe" else 3 * d * f
        layers.append((w, a, o))
    return work.ModelFlops(layers, d, run["vocab_size"])
