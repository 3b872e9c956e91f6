"""Each configuration file against the ModelConfig the harness builds,
key for key: every source key is held, every key run at another value
is listed under ``reduced`` (and in BENCHMARK.json), no width changes,
and the port's own registered configuration agrees on every width."""
import importlib
import json

import pytest

from perfbench.harness import spec
from perfbench.tests import tiny

META = ("name", "source", "reduced", "departures", "assumed", "deployment", "dtype")
# source key -> ModelConfig field, per model type
FIELDS = {
    "deepseek_v3": {
        "hidden_size": "d_model", "num_attention_heads": "num_heads",
        "num_key_value_heads": "num_kv_heads", "intermediate_size": "d_ff",
        "vocab_size": "vocab_size", "qk_nope_head_dim": "d_head", "v_head_dim": "d_head",
        "kv_lora_rank": "mla_kv_lora_rank", "q_lora_rank": "mla_q_lora_rank",
        "qk_rope_head_dim": "mla_rope_head_dim", "num_hidden_layers": "num_layers",
        "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
        "tie_word_embeddings": "tie_embeddings", "n_routed_experts": "moe.num_experts",
        "num_experts_per_tok": "moe.experts_per_token",
        "moe_intermediate_size": "moe.d_expert", "n_shared_experts": "moe.num_shared_experts"},
    "jamba": {
        "hidden_size": "d_model", "num_attention_heads": "num_heads",
        "num_key_value_heads": "num_kv_heads", "intermediate_size": "d_ff",
        "vocab_size": "vocab_size", "num_hidden_layers": "num_layers",
        "rms_norm_eps": "norm_eps", "tie_word_embeddings": "tie_embeddings",
        "num_experts": "moe.num_experts", "num_experts_per_tok": "moe.experts_per_token",
        "mamba_d_state": "mamba.d_state", "mamba_d_conv": "mamba.d_conv",
        "mamba_expand": "mamba.expand", "mamba_dt_rank": "mamba.dt_rank"},
}
WIDTHS = ("hidden_size", "intermediate_size", "moe_intermediate_size", "kv_lora_rank",
          "q_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim",
          "num_attention_heads", "num_key_value_heads", "num_experts_per_tok",
          "mamba_d_state", "mamba_expand", "mamba_dt_rank", "mamba_d_conv",
          "n_routed_experts", "num_experts", "vocab_size")
PORT_NAMES = {"deepseek-v3": "deepseek-v3", "ai21-jamba2-mini": "jamba-v0.1-52b"}
CONFIGS = [c["name"] for c in json.loads((spec.ROOT / "BENCHMARK.json").read_text())["configs"]]


def field(cfg, path):
    for part in path.split("."):
        cfg = getattr(cfg, part)
    return cfg


def built(name):
    f = tiny.bench().config_file(name)
    run = spec.run_values(f)
    port = importlib.import_module(f"perfbench.ports.{run['model_type']}")
    return f, run, port.model_config(run, name=name)


@pytest.mark.parametrize("name", CONFIGS)
def test_file_against_the_built_config_key_for_key(name):
    f, run, cfg = built(name)
    for key, path in FIELDS[run["model_type"]].items():
        assert field(cfg, path) == run[key], key
    changed = {k for k in f if k not in META and run[k] != f[k]}
    assert changed <= set(f["reduced"]), changed
    entry = tiny.bench().config_entry(name)
    assert set(entry["reduced"]) == set(f["reduced"])
    assert entry["source"] == f["source"]


@pytest.mark.parametrize("name", CONFIGS)
def test_no_width_is_reduced_and_cuts_are_marked(name):
    f, run, _ = built(name)
    for key, r in f["reduced"].items():
        assert key not in WIDTHS and not key.endswith(("_dim", "_rank")), key
        assert r["kind"] in ("cut", "departure") and r["why"]
    assert f["dtype"] == "bfloat16"


@pytest.mark.parametrize("name", CONFIGS)
def test_widths_equal_the_ports_registered_config(name):
    from repro_torch.configs import get_arch
    _, _, cfg = built(name)
    reg = get_arch(PORT_NAMES[name])
    for path in ("d_model", "num_heads", "num_kv_heads", "head_dim", "vocab_size",
                 "attn_kind", "mla_kv_lora_rank", "mla_q_lora_rank", "mla_rope_head_dim",
                 "moe", "period", "rope_theta", "tie_embeddings"):
        assert field(cfg, path) == field(reg, path), path
    if reg.mamba is not None:       # dt_rank 0 is ceil(d_model / 16)
        dtr = reg.mamba.dt_rank or -(-reg.d_model // 16)
        assert cfg.mamba == reg.mamba.__class__(**{**vars(reg.mamba), "dt_rank": dtr})
