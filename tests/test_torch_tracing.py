"""``repro_torch.tracing``: spans that cost nothing with no profiler, the
table's spans where the work happens (a tiny MLA + MoE engine and a tiny
Mamba + attention + MoE engine on the CPU), nested as the module says,
tokens and host reads unchanged by a profiler, the engine's counter
against a hand count, and a scan of the source: no profiler call outside
``tracing.py``, every span and counter named in its set and used, no
device read in a counter's argument."""
import ast
import collections
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import tracing  # noqa: E402
from repro_torch.configs import get_arch, reduced_config  # noqa: E402
from repro_torch.kernels import flash_decode as kfd  # noqa: E402
from repro_torch.kernels import moe_gmm as kmoe  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving.engine import Engine  # noqa: E402

PORT = Path(__file__).resolve().parent.parent / "src" / "repro_torch"
ARCHS = ("deepseek-v3", "jamba-v0.1-52b")
# a scripted run: 2 slots, three requests of 5, 7 and 3 prompt tokens and
# 3 new tokens each (no end-of-text id): steps 1-3 serve the first two,
# steps 4-6 the third
PROMPTS = ([3, 1, 4, 1, 5], [9, 2, 6, 5, 3, 5, 8], [9, 7, 9])
NEW = 3
STEPS = 6                                           # each runs a decode wave
HAND = {"serve.prefill_tokens": 5 + 7 + 3}
# each span's parent among the program's spans
PARENTS = {"serve.admit": {"serve.step"}, "serve.wave": {"serve.step"},
           "serve.readback": {"serve.step"}, "serve.retire": {"serve.step"},
           "serve.prefill": {"serve.admit"}, "serve.insert": {"serve.admit"}}
LAYER_PARENTS = {"serve.prefill", "serve.wave"}


def engine(arch):
    cfg = reduced_config(get_arch(arch))
    params = M.init_model(cfg, seed=0, device="cpu")
    return cfg, Engine(cfg, params, max_batch=2, max_seq=32, eos_id=-1, device="cpu")


def scripted(arch):
    """(config, {rid: tokens}) of the scripted run."""
    cfg, eng = engine(arch)
    for p in PROMPTS:
        eng.submit(p, max_new_tokens=NEW)
    return cfg, eng.run()


def per_wave(cfg):
    """{span: count} a decode wave, or a prefill, opens in each layer."""
    want = collections.Counter({"lm.embed": 1, "lm.head": 1})
    for s in cfg.layer_specs:
        if s.mixer == "mamba":
            want.update(["mamba.project", "mamba.scan", "mamba.out"])
        elif cfg.attn_kind == "mla":
            want.update(["mla.project", "mla.decompress", "mla.attend", "mla.out"])
        else:
            want.update(["attn"])
        if s.ffn == "dense":
            want.update(["ffn.dense"])
        else:
            want.update(["moe.route", "moe.dispatch", "moe.experts", "moe.combine"])
            if cfg.moe.num_shared_experts:
                want.update(["moe.shared"])
    return want


@pytest.fixture(scope="module", params=ARCHS)
def profiled(request):
    """The scripted run under the profiler: (config, tokens, spans as
    (start, end, name), sorted)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cfg, toks = scripted(request.param)
    spans = sorted(((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                    if e.name in tracing.SPANS), key=lambda s: (s[0], -s[1]))
    return request.param, cfg, toks, spans


def parent(spans, s):
    """The innermost span that holds `s`."""
    outer = [o for o in spans if o is not s and o[0] <= s[0] and s[1] <= o[1]]
    return min(outer, key=lambda o: o[1] - o[0])[2] if outer else None


def test_with_no_profiler_a_span_is_the_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("serve.wave") is tracing.span("mla.attend")
    with tracing.span("serve.step") as got:
        assert got is None
    scripted("deepseek-v3")


def test_unknown_names_are_refused():
    with pytest.raises(ValueError):
        tracing.span("serve.waves")
    with pytest.raises(ValueError):
        tracing.count("serve.wave")


def test_each_wave_and_prefill_opens_the_layers_spans(profiled):
    _, cfg, _, spans = profiled
    want = per_wave(cfg)
    for phase, n in (("serve.wave", STEPS), ("serve.prefill", len(PROMPTS))):
        outer = [s for s in spans if s[2] == phase]
        assert len(outer) == n
        for a, b, _ in outer:
            got = collections.Counter(name for s0, s1, name in spans
                                      if a < s0 and s1 < b and name not in PARENTS)
            assert got == want, phase


def test_each_step_enqueues_then_reads_back(profiled):
    _, _, _, spans = profiled
    steps = [s for s in spans if s[2] == "serve.step"]
    assert len(steps) == STEPS
    for a, b, _ in steps:
        inner = {name: (s0, s1) for s0, s1, name in spans
                 if a < s0 and s1 < b and name.startswith("serve.")}
        assert {"serve.admit", "serve.wave", "serve.readback", "serve.retire"} <= set(inner)
        assert inner["serve.admit"][1] <= inner["serve.wave"][0]
        assert inner["serve.wave"][1] <= inner["serve.readback"][0]
        assert inner["serve.readback"][1] <= inner["serve.retire"][0]


def test_each_span_nests_in_its_parent(profiled):
    _, _, _, spans = profiled
    for s in spans:
        got = parent(spans, s)
        if s[2] == "serve.step":
            assert got is None
        else:
            assert got in PARENTS.get(s[2], LAYER_PARENTS), s


@pytest.mark.parametrize("arch", ARCHS)
def test_the_profiler_changes_no_token_and_no_host_read(arch, monkeypatch):
    """Greedy tokens equal with the profiler on and off, and the engine
    reads the device (``item``, ``tolist``, ``cpu``, ``int``) as often."""
    reads = collections.Counter()
    for name in ("item", "tolist", "cpu", "__int__"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, _name=name, **kw):
            reads[_name] += 1
            return _orig(self, *a, **kw)
        monkeypatch.setattr(torch.Tensor, name, counted)
    _, off = scripted(arch)
    reads_off = dict(reads)
    reads.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        _, on = scripted(arch)
    assert on == off
    assert dict(reads) == reads_off and reads_off


def test_counters_equal_hand_counts_and_reset_zeroes_all():
    tracing.reset()
    scripted("jamba-v0.1-52b")
    got = tracing.counters()
    assert {k: got[k] for k in tracing.COUNTERS} == HAND
    got["serve.prefill_tokens"] = -1                     # a snapshot, not the counters
    assert tracing.counters()["serve.prefill_tokens"] == HAND["serve.prefill_tokens"]
    kmoe.launches, kmoe.variant_launches["cuda_core"] = 4, 4
    kfd.launches, kfd.lse_launches = 3, 2
    got = tracing.counters()
    assert (got["moe_gmm.launches"], got["moe_gmm.launches.cuda_core"],
            got["flash_decode.launches"], got["flash_decode_lse.launches"]) == (4, 4, 3, 2)
    tracing.reset()
    assert set(tracing.counters().values()) == {0}
    assert (kmoe.launches, kfd.launches, kfd.lse_launches) == (0, 0, 0)
    assert set(kmoe.variant_launches.values()) == {0}


def calls(tree, fn):
    """The calls ``tracing.<fn>(...)`` in `tree`."""
    return [n for n in ast.walk(tree) if isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute) and n.func.attr == fn
            and isinstance(n.func.value, ast.Name) and n.func.value.id == "tracing"]


DEVICE_READS = {"item", "tolist", "cpu", "numpy"}


def reads_device(node) -> bool:
    return any(isinstance(n, ast.Call) and (
        isinstance(n.func, ast.Attribute) and n.func.attr in DEVICE_READS
        or isinstance(n.func, ast.Name) and n.func.id in ("int", "float", "bool"))
        for n in ast.walk(node))


def test_the_source_uses_spans_and_counters_as_named():
    used = {"span": set(), "count": set()}
    for path in sorted(PORT.rglob("*.py")):
        text = path.read_text()
        if path.name == "tracing.py" and path.parent == PORT:
            assert not reads_device(ast.parse(text)), path
            continue
        assert "record_function" not in text and "torch.profiler" not in text, path
        tree = ast.parse(text)
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module == "torch":
                assert "profiler" not in {a.name for a in node.names}, path
        for fn in used:
            for c in calls(tree, fn):
                assert isinstance(c.args[0], ast.Constant), (path, c.lineno)
                used[fn].add(c.args[0].value)
                assert not any(reads_device(a) for a in c.args), (path, c.lineno)
    assert used["span"] == tracing.SPANS
    assert used["count"] == tracing.COUNTERS
