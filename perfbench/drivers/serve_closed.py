"""Closed-loop serving through ``repro_torch.serving.engine.Engine``.

A fixed number of clients each send their next request the moment the
last one completes (callers that each wait for a reply, no think time).
The engine runs on the card with the benchmark's weights; every output
token is greedy and requests run to their token budget (no end-of-text
id). A server built on ``Engine.step`` hands out tokens when a step
returns, so that is when a token reaches its client: a request's first
token comes at the end of the step that admitted it, together with its
first decoded token.

Set-up: the weights from the seed, the engine, and the first step, which
admits every client's first request (one prefill each, at the mix's
lengths) and runs one decode wave: every kernel is built and every path
run before the window. The first requests' budgets are spread over
(0, budget] so that they complete at a steady pace from the window's
start, as in a loop that has run for a while.

The window: steps until ``--seconds`` have passed; the last step ends
it. ``tokens_per_s``: output tokens that reached a client in the window
over its seconds. ``itl_p95_ms``: 95th percentile of the gaps between a
request's consecutive tokens, over every token that reached its client
in the window. ``ttft_p95_ms``: 95th percentile, over the requests sent
in the window, of the time from sending to the first token (steps past
the window are run, without sending, until each has it).
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import math
import os
import statistics
import tempfile
import time

import torch

from perfbench.harness import card, judge, peaks, spec, work
from perfbench.harness import trace as tr
from perfbench.harness import weights as wts
from perfbench.harness.result import Outcome
from perfbench.harness.traffic import Requests

MOE_KERNELS = ("moe_gmm", "moe_gemm")
FLASH_DECODE_KERNELS = ("flash_decode",)
HEAD_STEPS = 50


def pct(values, q: int) -> float:
    """The q-th percentile (``statistics.quantiles``, inclusive)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[q - 1]


class Track:
    __slots__ = ("sent", "prompt_len", "budget", "served", "arrivals", "done")

    def __init__(self, sent, prompt_len, budget):
        self.sent, self.prompt_len, self.budget = sent, prompt_len, budget
        self.served, self.arrivals, self.done = 0, [], None


@contextlib.contextmanager
def patched(obj, name, fn):
    old = getattr(obj, name)
    setattr(obj, name, fn)
    try:
        yield
    finally:
        setattr(obj, name, old)


class Instruments:
    """The traced run's own spans around the engine's calls into each
    layer, and the needed work of every kernel call, read at the call
    (``work.moe_gmm_work`` / ``flash_decode_work``)."""

    def __init__(self):
        self.moe, self.fd = [], []

    @contextlib.contextmanager
    def installed(self, engine_cls):
        from torch.profiler import record_function

        from repro_torch.kernels import ops
        from repro_torch.models import model as M
        moe_gmm, flash_decode = ops.moe_gmm, ops.flash_decode

        def moe_call(x, w_gate, w_up, w_down):
            self.moe.append(work.moe_gmm_work(x, w_gate))
            return moe_gmm(x, w_gate, w_up, w_down)

        def fd_call(q, k, v, length):
            self.fd.append(work.flash_decode_work(q, k, length))
            return flash_decode(q, k, v, length)

        def span(name, fn):
            def wrapped(*a, **kw):
                with record_function(name):
                    return fn(*a, **kw)
            return wrapped

        with contextlib.ExitStack() as st:
            st.enter_context(patched(ops, "moe_gmm", moe_call))
            st.enter_context(patched(ops, "flash_decode", fd_call))
            for obj, name, label in ((engine_cls, "_admit", "engine.admit"),
                                     (engine_cls, "_prefill_one", "model.prefill"),
                                     (engine_cls, "_retire", "engine.retire"),
                                     (M, "decode_step", "model.decode_step")):
                st.enter_context(patched(obj, name, span(label, getattr(obj, name))))
            yield

    @staticmethod
    def bound_s(calls) -> float:
        if not calls:
            return 0.0
        b = torch.stack([torch.stack(c) for c in calls]).cpu()
        return sum(peaks.bound_s(float(n), float(f)) for n, f in b)


def run(ctx) -> Outcome:
    dev = card.DEVICE
    mix, run_v = ctx.traffic, ctx.run
    model_type = run_v["model_type"]
    port = importlib.import_module(f"perfbench.ports.{model_type}")
    cfg = port.model_config(run_v, name=ctx.config["name"])
    from repro_torch.serving.engine import Engine

    reqs = Requests(mix, cfg.vocab_size, ctx.seed)
    if reqs.longest() > mix["max_seq"] - 1:
        raise ValueError(f"the mix's longest request, {reqs.longest()} tokens, does "
                         f"not fit max_seq {mix['max_seq']}")
    params = wts.draw(cfg, ctx.seed, dev)
    eng = Engine(cfg, params, max_batch=mix["max_batch"], max_seq=mix["max_seq"],
                 eos_id=-1, device=dev)
    flops = judge.reference(model_type).model_flops(run_v)

    tracks, inflight = {}, {}
    window = {"open": False, "flops": 0.0, "tokens": 0}

    def send(now, frac=1.0):
        prompt, n_out = next(reqs)
        n_out = max(2, math.ceil(n_out * frac))
        rid = eng.submit(prompt, max_new_tokens=n_out - 1)
        inflight[rid] = eng.queue[-1]
        tracks[rid] = Track(now, len(prompt), n_out)

    def observe(now, sending: bool):
        for rid, req in list(inflight.items()):
            t = tracks[rid]
            n = len(req.generated)
            if n > t.served:
                t.arrivals.append((now, n - t.served))
                if window["open"]:
                    window["tokens"] += n - t.served
                    f = 0.0
                    for j in range(t.served, n):
                        f += (flops.prompt(t.prompt_len) + flops.head if j == 0
                              else flops.decode(t.prompt_len + j))
                    window["flops"] += f
                t.served = n
            if req.done:
                del inflight[rid]
                t.done = now
                if sending:
                    send(now)

    # set-up: every client's first request admitted, one wave
    n_clients = mix["clients"]
    for i in range(n_clients):
        send(time.perf_counter(), (i + 0.5) / n_clients)
    eng.step()
    observe(time.perf_counter(), sending=True)
    card.sync()

    inst = Instruments() if ctx.trace else None
    prof = None
    with contextlib.ExitStack() as st:
        if ctx.trace:
            st.enter_context(inst.installed(Engine))
            prof = st.enter_context(card.profiler())
        setup_s = time.perf_counter() - ctx.t_start
        t0 = time.perf_counter()
        end = t0 + ctx.seconds
        window["open"] = True
        steps = []
        while True:
            tb = time.perf_counter()
            if tb >= end and steps:
                break
            queued = len(eng.queue)
            eng.step()
            ta = time.perf_counter()
            steps.append((tb, ta, queued - len(eng.queue)))
            observe(ta, sending=ta < end)
        window["open"] = False
        t_end = steps[-1][1]
        card.sync()
    peak = card.peak_bytes()

    # the first tokens of the requests sent in the window
    late = [t for t in tracks.values() if t0 <= t.sent and not t.arrivals]
    while late:
        eng.step()
        observe(time.perf_counter(), sending=False)
        late = [t for t in late if not t.arrivals]

    window_s = t_end - t0
    sent = [t for t in tracks.values() if t0 <= t.sent < end]
    itl = []
    for t in tracks.values():
        prev = None
        for at, k in t.arrivals:
            if t0 < at <= t_end:
                if prev is not None:
                    itl.append(at - prev)
                itl.extend([0.0] * (k - 1))
            prev = at
    ttft = [t.arrivals[0][0] - t.sent for t in sent]
    end_to_end = {
        "tokens_per_s": window["tokens"] / window_s,
        "itl_p95_ms": pct(itl, 95) * 1e3 if itl else None,
        "ttft_p95_ms": pct(ttft, 95) * 1e3 if ttft else None,
        "setup_s": setup_s,
    }

    # the requests finished in the window, then the engine's state freed
    done = [(r.prompt, r.generated, tracks[rid].budget)
            for rid, r in eng.finished.items()
            if tracks[rid].done is not None and t0 < tracks[rid].done <= t_end]
    miscounted = sum(len(g) != b for _, g, b in done)
    del eng, inflight
    gc.collect()
    card.release()

    readings, breakdown, device = None, None, {
        "platform": "gpu", "kind": card.name(), "count": 1, "memory_peak_bytes": peak}
    if ctx.trace:
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            trc = tr.Trace.load(path)
        device.update(busy_s=trc.busy_us() / 1e6, window_s=window_s)
        breakdown = {"device_ops": trc.top_ops(), "idle_gaps": trc.idle_gaps()}
        readings = {
            "steps": steps, "window_s": window_s, "busy_s": trc.busy_us() / 1e6,
            "model_flops": window["flops"], "peak_flops": peaks.PEAK_FLOPS[cfg.dtype],
            "moe_gmm": {"bound_s": Instruments.bound_s(inst.moe), "calls": len(inst.moe),
                        "kernel_s": trc.kernel_us(MOE_KERNELS) / 1e6},
            "flash_decode": {"bound_s": Instruments.bound_s(inst.fd), "calls": len(inst.fd),
                             "kernel_s": trc.kernel_us(FLASH_DECODE_KERNELS) / 1e6},
        }
        del prof, trc

    lim = spec.limits(ctx.cell["name"])
    picked = judge.sample([(p, g) for p, g, _ in done], mix["check_requests"], ctx.seed)
    g = judge.gaps(model_type, params, run_v, picked, dev, fp8_control=ctx.fp8_control)
    seen = judge.summary(g["served"])
    checks = {"mean_logit_gap": {"value": seen.get("mean", float("inf")),
                                 "limit": lim["mean_logit_gap"]},
              "requests_unjudged": {"value": mix["check_requests"] - len(picked), "limit": 0},
              "miscounted_requests": {"value": miscounted, "limit": 0}}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    # a seed fixes the whole sequence of steps (each request runs to its
    # budget), so two runs of one seed differ only in how fast they go:
    # the seconds of the window's first HEAD_STEPS steps compare that
    head = steps[:HEAD_STEPS]
    extra = {"gaps": seen, "window_s": window_s, "steps": len(steps),
             "requests_sent": len(sent), "requests_done": len(done),
             "admitted": sum(k for _, _, k in steps),
             "head_steps_s": head[-1][1] - t0 if len(head) == HEAD_STEPS else None}
    if ctx.fp8_control:
        extra["control_gaps"] = judge.summary(g["control"])
    return Outcome(correct=correct, attempted=len(sent), failed=0, end_to_end=end_to_end,
                   readings=readings, checks=checks, device=device,
                   breakdown=breakdown, extra=extra)
