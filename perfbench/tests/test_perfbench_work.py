"""The yardstick's arithmetic against hand counts: the interval union,
the needed work of the kernels, the model FLOPs, the trace reading."""
import math

import torch

from perfbench.harness import peaks, work
from perfbench.harness import trace as tr
from perfbench.reference import deepseek_v3 as R_ds


def test_interval_union_by_hand():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (10, 10)]
    assert tr.intervals_len(iv) == 4.0
    assert tr.union(iv) == [[0, 3], [5, 6], [10, 10]]


def test_moe_gmm_needs_only_the_reached_experts():
    e, t, d, f = 4, 5, 8, 6
    x = torch.zeros(e, t, d, dtype=torch.bfloat16)
    x[0, 0] = 1.0
    x[0, 3, 2] = -2.0
    x[2, 1] = 0.5                     # 3 rows hold a token, in experts 0 and 2
    n_bytes, flops = work.moe_gmm_work(x, torch.zeros(e, d, f, dtype=torch.bfloat16))
    assert float(n_bytes) == 2 * 3 * d * f * 2 + 3 * 2 * d * 2
    assert float(flops) == 3 * 6 * d * f


def test_flash_decode_reads_the_rows_below_each_length():
    q = torch.zeros(2, 4, 8, dtype=torch.bfloat16)
    k = torch.zeros(2, 2, 10, 8, dtype=torch.bfloat16)
    n_bytes, flops = work.flash_decode_work(q, k, torch.tensor([3, 7]))
    assert float(n_bytes) == 10 * 2 * 2 * 8 * 2 + 2 * 2 * 4 * 8 * 2
    assert float(flops) == 10 * 4 * 4 * 8
    n_bytes, _ = work.flash_decode_work(q, k, 20)      # clamped to the cache
    assert float(n_bytes) == 20 * 2 * 2 * 8 * 2 + 2 * 2 * 4 * 8 * 2


def test_model_flops_by_hand():
    run = dict(hidden_size=4, num_attention_heads=2, qk_nope_head_dim=3, qk_rope_head_dim=1,
               v_head_dim=3, kv_lora_rank=2, q_lora_rank=5, moe_intermediate_size=7,
               n_routed_experts=6, num_experts_per_tok=2, n_shared_experts=1,
               num_hidden_layers=2, vocab_size=10)
    mf = R_ds.model_flops(run)
    mla = 4 * 5 + 5 * 2 * 4 + 4 * 2 + 4 * 1 + 2 * 2 * 2 * 3 + 2 * 3 * 4
    moe = 4 * 6 + 2 * 3 * 4 * 7 + 3 * 4 * 7
    assert mf.body == 2 * 2 * (mla + moe)
    assert mf.per_key == 2 * (2 * 2 * 4 + 2 * 2 * 3)
    assert mf.decode(5) == mf.body + 5 * mf.per_key + 2 * 4 * 10
    assert mf.prompt(3) == 3 * mf.body + mf.per_key * 6


def test_bound_is_the_larger_of_bytes_and_operations():
    assert peaks.bound_s(3.35e12, 0) == 1.0
    assert math.isclose(peaks.bound_s(0, 989e12), 1.0)
    assert peaks.bound_s(3.35e12, 2 * 989e12) == 2.0


def test_trace_busy_top_and_idle_gaps():
    ev = [
        {"cat": "kernel", "name": "k_a", "ts": 0, "dur": 10},
        {"cat": "kernel", "name": "k_b", "ts": 5, "dur": 10},
        {"cat": "gpu_memcpy", "name": "copy", "ts": 30, "dur": 5},
        {"cat": "kernel", "name": "k_a", "ts": 50, "dur": 10},
        {"cat": "user_annotation", "name": "model.decode_step", "ts": 0, "dur": 60, "tid": 1},
        {"cat": "cpu_op", "name": "aten::item", "ts": 16, "dur": 12, "tid": 1},
        {"cat": "cpu_op", "name": "other_thread", "ts": 36, "dur": 12, "tid": 2},
    ]
    t = tr.Trace(ev)
    assert t.busy_us() == 15 + 5 + 10
    assert t.kernel_us(("k_a",)) == 20
    assert t.top_ops()[0] == ["k_a", 20e-6]
    gaps = dict(t.idle_gaps())
    assert gaps == {"aten::item": 15e-6, "model.decode_step": 15e-6}
