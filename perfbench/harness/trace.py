"""Reading the profiler's chrome trace: device intervals and their union
(copied from ``chip_smoke.py``'s ``_intervals_len`` and the busy rule of
its ``device_split``), time by kernel name, and the idle gaps labelled by
the host operation that was running in them."""
from __future__ import annotations

import json
import math
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


def intervals_len(iv) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -math.inf
    for a, b in sorted(iv):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def union(iv) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """A chrome trace's device items (kernels, copies, sets) and host
    operations, times in microseconds on the trace's clock."""

    def __init__(self, events):
        self.device = [(e["ts"], e["ts"] + e["dur"], e["name"], e["cat"])
                       for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
        host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e]
        # the thread that runs the step: the one with most host operations
        per_tid = defaultdict(int)
        for e in host:
            per_tid[e.get("tid")] += 1
        main = max(per_tid, key=per_tid.get) if per_tid else None
        self.host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in host
                            if e.get("tid") == main), key=lambda h: (h[0], -h[1]))

    @classmethod
    def load(cls, path) -> "Trace":
        with open(path) as f:
            return cls(json.load(f).get("traceEvents", []))

    def busy_us(self) -> float:
        return intervals_len([(a, b) for a, b, *_ in self.device])

    def kernel_us(self, patterns) -> float:
        """Summed time of the kernels whose name holds any of `patterns`."""
        return sum(b - a for a, b, name, cat in self.device
                   if cat == "kernel" and any(p in name for p in patterns))

    def top_ops(self, n: int = 10) -> list:
        """[[name, seconds]] of the device items that took most time."""
        by = defaultdict(float)
        for a, b, name, _ in self.device:
            by[name[:160]] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """[[host operation, seconds]]: the device's idle time between its
        first and last item, each gap labelled by the innermost host
        operation of the step's thread running at the gap's middle, summed
        by label, the largest `n`."""
        busy = union([(a, b) for a, b, *_ in self.device])
        gaps = sorted(((b0 + a1) / 2, a1 - b0) for (_, b0), (a1, _) in zip(busy, busy[1:]))
        by = defaultdict(float)
        stack, i = [], 0
        for mid, length in gaps:
            while i < len(self.host) and self.host[i][0] <= mid:
                while stack and stack[-1][1] < self.host[i][0]:
                    stack.pop()
                stack.append(self.host[i])
                i += 1
            while stack and stack[-1][1] < mid:
                stack.pop()
            by[stack[-1][2] if stack else "(no host operation)"] += length / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]
