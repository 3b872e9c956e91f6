"""The program's spans in the trace: device time attributed at each item's
launch to the innermost of the program's spans open there, and idle gaps
by the spans open at their middle, against hand counts on a hand-built
chrome trace."""
import json

import pytest

from perfbench.harness import spans as sp
from perfbench.harness import trace as tr

PROGRAM = frozenset({"serve.step", "serve.admit", "serve.prefill", "serve.wave",
                     "serve.readback", "mla.project", "mla.attend", "moe.route",
                     "moe.combine", "mamba.scan"})
MAIN, OTHER = 1, 2


def span(name, a, b, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": a, "dur": b - a,
            "tid": tid}


def launch(corr, ts, tid=MAIN, cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "ts": ts, "dur": 0.5,
            "tid": tid, "args": {"correlation": corr}}


def item(corr, a, b, cat="kernel", name="k"):
    return {"ph": "X", "cat": cat, "name": name, "ts": a, "dur": b - a, "tid": 7,
            "args": {"correlation": corr}}


# one step: an admission whose prefill runs two layers' stages, inside the
# benchmark's own wrappers (engine.admit, model.prefill), then a wave, its
# read-back; a launch on another thread, one after the step, one item
# whose launch the trace lacks
EVENTS = [
    span("serve.step", 0, 100),
    span("engine.admit", 1, 40), span("serve.admit", 2, 39),
    span("model.prefill", 3, 31), span("serve.prefill", 4, 30),
    span("mla.project", 5, 10), span("moe.route", 12, 20),
    span("serve.wave", 41, 80), span("mla.attend", 43, 60), span("moe.combine", 62, 70),
    span("serve.readback", 81, 95),
    {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 6, "dur": 1, "tid": MAIN},
    launch(1, 6), item(1, 10, 20),
    launch(2, 15), item(2, 20, 23),
    launch(3, 35), item(3, 36, 38, cat="gpu_memcpy", name="Memcpy HtoD"),
    launch(4, 45), item(4, 46, 56),
    launch(5, 65, cat="cuda_driver"), item(5, 66, 70),
    launch(6, 50, tid=OTHER), item(6, 71, 72),
    launch(7, 82), item(7, 85, 86, cat="gpu_memcpy", name="Memcpy DtoH"),
    launch(8, 120), item(8, 121, 122, cat="gpu_memset", name="Memset"),
    item(9, 130, 131),
]

DEVICE_US = {
    "serve.step/serve.admit/serve.prefill/mla.project": 10,
    "serve.step/serve.admit/serve.prefill/moe.route": 3,
    "serve.step/serve.admit": 2,
    "serve.step/serve.wave/mla.attend": 10,
    "serve.step/serve.wave/moe.combine": 4,
    "serve.step/serve.readback": 1,
    sp.NO_SPAN: 2,                  # the other thread's launch, the one after the step
    sp.NO_LAUNCH: 1,
}
# gaps between the busy intervals, by the spans open at their middle:
# 23-36 (prefill), 38-46, 56-66, 70-71, 72-85 (the wave between its
# stages), 86-121 and 122-130 (after the step)
IDLE_US = {"serve.step/serve.admit/serve.prefill": 13,
           "serve.step/serve.wave": 8 + 10 + 1 + 13,
           sp.NO_SPAN: 35 + 8}


@pytest.fixture(scope="module")
def by_span():
    return sp.by_span(EVENTS, PROGRAM)


def test_device_time_goes_to_the_innermost_program_span_at_launch(by_span):
    assert by_span["device_us"] == pytest.approx(DEVICE_US)
    t = tr.Trace(EVENTS)
    assert sum(by_span["device_us"].values()) == pytest.approx(
        sum(b - a for a, b, *_ in t.device))


def test_span_counts(by_span):
    assert by_span["counts"] == {n: 1 for n in PROGRAM - {"mamba.scan"}}


def test_idle_gaps_by_the_spans_open_at_their_middle():
    got = sp.idle_by_span(EVENTS, PROGRAM)
    assert [p for p, _ in got] == sorted(IDLE_US, key=lambda p: -IDLE_US[p])
    assert dict(got) == pytest.approx({p: us / 1e6 for p, us in IDLE_US.items()})


def test_without_program_spans_everything_is_outside_them():
    """A program with no spans of its own (the benchmark's wrappers are not
    the program's): every launched item and every gap is NO_SPAN."""
    got = sp.by_span(EVENTS, frozenset())
    assert got["device_us"] == pytest.approx({sp.NO_SPAN: 32, sp.NO_LAUNCH: 1})
    assert got["counts"] == {}
    assert [p for p, _ in sp.idle_by_span(EVENTS, frozenset())] == [sp.NO_SPAN]


@pytest.mark.parametrize("times,want", [
    ([4.5, 5, 9, 10, 11, 19, 19.7, 50], ["a", "a/b", "a/b", "a/b", "a", "a/c/d", "a",
                                          sp.NO_SPAN]),
    ([], []),
])
def test_open_paths_by_hand(times, want):
    spans = [(4, 20, "a"), (5, 10, "b"), (12, 19.5, "c"), (18, 19, "d")]
    assert sp.open_paths(spans, times) == want


def test_the_command_reads_an_exported_trace(tmp_path, capsys, monkeypatch):
    """``python3 -m perfbench.harness.spans <trace.json>`` on the hand trace,
    with the program's span names narrowed to the hand trace's."""
    import repro_torch.tracing
    monkeypatch.setattr(repro_torch.tracing, "SPANS", PROGRAM)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    assert sp.main([str(path), "--top", "3"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["device_s"] == pytest.approx(33 / 1e6)
    assert got["counts"] == {n: 1 for n in PROGRAM - {"mamba.scan"}}
    top = sorted(DEVICE_US.items(), key=lambda kv: -kv[1])[:3]
    assert dict(got["device_by_span"]) == pytest.approx({p: us / 1e6 for p, us in top})
    assert len(got["idle_by_span"]) == 3
