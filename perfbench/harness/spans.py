"""The program's own spans (``repro_torch.tracing``) in the profiler's
chrome trace: each device item (kernel, copy, set) attributed to the
spans that were open on the host when it was launched, and the device's
idle gaps to the spans open at their middle.

    python3 -m perfbench.harness.spans <trace.json> [--top N]

From the root of a checkout: prints both as one JSON object, for a trace
that ``torch.profiler`` (CPU and CUDA activities) exported of a run of
the program. An item is tied to its launch by the ``correlation`` id that
the item and the runtime or driver call that launched it both carry; the
spans are the ``record_function`` ranges the program opens while a
profiler records. The benchmark's traced run does not call this: its
driver keeps no trace once the window is read.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict

from perfbench.harness.trace import DEVICE_CATS, union

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NO_SPAN = "(no program span)"
NO_LAUNCH = "(launch not traced)"


def program_spans(events, names) -> dict:
    """{host thread: [(start, end, name)]} of the ``record_function``
    spans named in `names`, sorted by start, the outer of two equal starts
    first."""
    by_tid = defaultdict(list)
    for e in events:
        if e.get("cat") == "user_annotation" and "dur" in e and e["name"] in names:
            by_tid[e.get("tid")].append((e["ts"], e["ts"] + e["dur"], e["name"]))
    return {tid: sorted(s, key=lambda h: (h[0], -h[1])) for tid, s in by_tid.items()}


def open_paths(spans, times) -> list:
    """For each of the sorted `times`, the path of the `spans` ((start, end,
    name), properly nested, sorted as ``program_spans`` sorts them) open at
    it: their names, outermost first, joined by "/", or ``NO_SPAN``."""
    out, stack, i = [], [], 0          # stack: (end, path) of the open spans
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            a, b, name = spans[i]
            while stack and stack[-1][0] < a:
                stack.pop()
            stack.append((b, f"{stack[-1][1]}/{name}" if stack else name))
            i += 1
        while stack and stack[-1][0] < t:
            stack.pop()
        out.append(stack[-1][1] if stack else NO_SPAN)
    return out


def by_span(events, names) -> dict:
    """{"device_us": {path: us}, "counts": {name: spans}}: each device item's
    time under the path (as ``open_paths``) of the spans named in `names`
    open at its launch, on the launching call's thread; an item launched
    under none of them is ``NO_SPAN``, one whose launch is not in the trace
    ``NO_LAUNCH``. "counts" counts the spans of each name."""
    spans = program_spans(events, names)
    launches = {e["args"]["correlation"]: (e.get("tid"), e["ts"]) for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    items = [(e["dur"], e.get("args", {}).get("correlation")) for e in events
             if e.get("cat") in DEVICE_CATS and "dur" in e]
    at = defaultdict(list)              # thread -> [(launch time, item)]
    for i, (_, c) in enumerate(items):
        launch = launches.get(c)
        if launch is not None:
            at[launch[0]].append((launch[1], i))
    path = [NO_LAUNCH] * len(items)
    for tid, launched in at.items():
        launched.sort()
        for (_, i), p in zip(launched, open_paths(spans.get(tid, []),
                                                  [t for t, _ in launched])):
            path[i] = p
    device_us = defaultdict(float)
    for (dur, _), p in zip(items, path):
        device_us[p] += dur
    counts = defaultdict(int)
    for s in spans.values():
        for *_, name in s:
            counts[name] += 1
    return {"device_us": dict(device_us), "counts": dict(counts)}


def idle_by_span(events, names) -> list:
    """[[path, seconds]]: the device's idle time between its first and last
    item, each gap labelled by the path (as ``by_span``) of the spans named
    in `names` open at the gap's middle on the thread that opened most of
    them, summed by path, largest first."""
    spans = program_spans(events, names)
    main = max(spans, key=lambda t: len(spans[t])) if spans else None
    busy = union([(e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") in DEVICE_CATS and "dur" in e])
    gaps = sorted(((b0 + a1) / 2, a1 - b0) for (_, b0), (a1, _) in zip(busy, busy[1:]))
    by = defaultdict(float)
    for (_, length), p in zip(gaps, open_paths(spans.get(main, []), [m for m, _ in gaps])):
        by[p] += length / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace", help="a chrome trace that torch.profiler exported")
    ap.add_argument("--top", type=int, default=40, help="paths printed of each list")
    args = ap.parse_args(argv)
    from perfbench.harness.spec import ROOT
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.tracing import SPANS
    with open(args.trace) as f:
        events = json.load(f).get("traceEvents", [])
    got = by_span(events, SPANS)
    device = sorted(got["device_us"].items(), key=lambda kv: -kv[1])
    print(json.dumps({
        "device_s": sum(got["device_us"].values()) / 1e6,
        "counts": got["counts"],
        "device_by_span": [[p, us / 1e6] for p, us in device[:args.top]],
        "idle_by_span": idle_by_span(events, SPANS)[:args.top]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
