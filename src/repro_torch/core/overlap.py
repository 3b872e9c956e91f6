"""Dual-batch overlap (DBO) modeling on a THREE-lane fixed-order schedule
(paper sections 2.3, 3.3; MixServe/MixNet-style overlap-aware scheduling).

The paper models DBO'd TPOT as

  TPOT_dbo = compute(B/2) * 2 + exposed_comm

where exposed_comm comes from a fixed-order multi-lane schedule. The lanes
are the hardware resources an op occupies exclusively:

  compute    the XPU's SIMD/tensor cores (GEMMs, attention, router)
  comm       the collective fabric (expert A2A, TP all-reduce)
  sendrecv   the point-to-point pipeline channel (`pp_sendrecv` hops)

Each op of each microbatch is scheduled as soon as (a) its predecessor
within its own microbatch is done and (b) its lane is free. Communication
time not hidden under compute is the exposed communication time (ECT).

The dedicated send/recv lane is what models 1F1B-style decode pipelining:
a pp hidden-state hop occupies neither the compute units nor the
collective fabric, so it overlaps BOTH the other microbatch's GEMMs and
its collectives — folding it into the comm lane (the old two-lane model)
would serialize hops behind A2As that ride different wires. At pp = 1 the
sendrecv lane is empty and the schedule degenerates to the original
two-lane model exactly.

`simulate_lanes` is the scheduler; `dbo_best` picks the best static
stagger; `dbo_tpot` applies both to a decode op list. The same machinery
times DBO'd prefill chunks (`optimizer.prefill_iteration_dbo` splits a
chunk into two causal half-chunk microbatches) and is vectorized exactly
over sweep grids by `sweep.GridEval.dbo_makespan`.

Layer: schedule math over per-op duration lists from `core.workload` +
`core.compute_model`; `dbo_best` is the scalar REFERENCE the batched
(max,+) vectorizations (`sweep._lane_makespan`, `sweep_jax`) are held to
at 1e-9 / 1e-6 respectively.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Sequence, Tuple

from repro_torch.core.compute_model import Op
from repro_torch.core.workload import op_lane

# scheduler lanes, in (max,+) recurrence order; index = the integer lane
# code used by the vectorized engine (`optable.OpTable.lane`)
LANES = ("compute", "comm", "sendrecv")


@dataclass(frozen=True)
class TimedOp:
    name: str
    lane: str          # "compute" | "comm" | "sendrecv"
    duration: float
    mb: int            # microbatch id (0 or 1)


@dataclass
class ScheduleResult:
    makespan: float
    compute_busy: float
    comm_busy: float
    exposed_comm: float            # makespan - compute_busy (comm not hidden)
    timeline: List[Tuple[str, int, float, float]]   # (name, mb, start, end)
    sendrecv_busy: float = 0.0


def simulate_lanes(ops_a: Sequence[TimedOp],
                   ops_b: Sequence[TimedOp],
                   stagger: int = 0) -> ScheduleResult:
    """Fixed-order schedule of two microbatches on the `LANES` resources —
    the structure real DBO implementations pin statically: microbatch B
    runs `stagger` ops behind microbatch A, so A's collective phase lines
    up with B's compute phase (DeepSeek's DBO staggers by the attention
    block; `dbo_best` picks the best static stagger).

    Within a microbatch, ops execute strictly in order (the dependency
    chain of a transformer stack); each lane serves one op at a time in the
    merged (op-index [+ stagger for B], microbatch) order; an op starts as
    soon as its predecessor is done AND its lane is free.

    A fixed per-lane order makes every start time a (max, +) expression of
    the durations, so the makespan is MONOTONE in each duration — a greedy
    earliest-start scheduler is not (Graham anomalies let a slower network
    beat a faster one, which would corrupt every topology comparison).
    The argument generalizes to any lane count: an op's start is
    max(end of mb predecessor, end of lane predecessor), and both
    predecessors come earlier in the merged order.
    """
    streams = [list(ops_a), list(ops_b)]
    # per-lane FIFO queues in merged (k [+stagger], mb) order
    order = sorted(
        [(k, mb) for mb in (0, 1) for k in range(len(streams[mb]))],
        key=lambda km: (km[0] + (stagger if km[1] == 1 else 0), km[1]))
    queues: Dict[str, List[Tuple[int, int]]] = {lane: [] for lane in LANES}
    for k, mb in order:
        queues[streams[mb][k].lane].append((mb, k))

    ready_at = [0.0, 0.0]            # time the mb's previous op finished
    done_idx = [0, 0]                # next op index to finish per mb
    lane_free = {lane: 0.0 for lane in LANES}
    head = {lane: 0 for lane in LANES}
    timeline: List[Tuple[str, int, float, float]] = []
    busy = {lane: 0.0 for lane in LANES}

    def head_ready(lane):
        """Head op of `lane` is dependency-ready iff it is the mb's next op."""
        if head[lane] >= len(queues[lane]):
            return None
        mb, k = queues[lane][head[lane]]
        if k != done_idx[mb]:
            return None
        return mb, k

    n_total = len(streams[0]) + len(streams[1])
    while len(timeline) < n_total:
        best = None
        for lane in LANES:
            hr = head_ready(lane)
            if hr is None:
                continue
            mb, k = hr
            start = max(ready_at[mb], lane_free[lane])
            if best is None or start < best[0]:
                best = (start, lane, mb, k)
        assert best is not None, "deadlock: cyclic lane order"
        start, lane, mb, k = best
        op = streams[mb][k]
        end = start + op.duration
        lane_free[lane] = end
        ready_at[mb] = end
        done_idx[mb] += 1
        head[lane] += 1
        busy[lane] += op.duration
        timeline.append((op.name, mb, start, end))

    makespan = max(ready_at)
    return ScheduleResult(
        makespan=makespan,
        compute_busy=busy["compute"],
        comm_busy=busy["comm"],
        exposed_comm=max(makespan - busy["compute"], 0.0),
        timeline=timeline,
        sendrecv_busy=busy["sendrecv"],
    )


# ---------------------------------------------------------------------------
# glue: op list -> timed ops -> TPOT
# ---------------------------------------------------------------------------

def to_timed(ops: Sequence[Op], compute_time: Callable[[Op], float],
             comm_time: Callable[[Op], float], mb: int) -> List[TimedOp]:
    out = []
    for o in ops:
        if o.kind == "compute":
            out.append(TimedOp(o.name, "compute", compute_time(o), mb))
        else:
            out.append(TimedOp(o.name, op_lane(o.kind), comm_time(o), mb))
    return out


def sequential_tpot(ops: Sequence[Op], compute_time, comm_time) -> float:
    """No-overlap baseline: straight sum over the op list."""
    return sum((compute_time(o) if o.kind == "compute" else comm_time(o))
               for o in ops)


MAX_STAGGER = 9        # ~ops per MoE layer; staggers 0..MAX_STAGGER tried


def dbo_best(ops_a: Sequence[TimedOp],
             ops_b: Sequence[TimedOp]) -> ScheduleResult:
    """Best static stagger of microbatch B over the fixed-order schedules
    (min over fixed-order schedules: each is monotone, so the min is too).
    The microbatches may differ — DBO'd prefill chunks split causally into
    a leading ceil- and a trailing floor-half, which are not the same ops.

    A <= 1-op leading microbatch admits exactly one merged order, so the
    stagger loop would re-simulate the identical schedule MAX_STAGGER
    times; it is simulated once instead.
    """
    if len(ops_a) <= 1:
        return simulate_lanes(ops_a, ops_b, stagger=0)
    best = None
    for s in range(0, min(MAX_STAGGER, len(ops_a) - 1) + 1):
        res = simulate_lanes(ops_a, ops_b, stagger=s)
        if best is None or res.makespan < best.makespan:
            best = res
    assert best is not None, (
        f"dbo_best: no stagger schedule evaluated for microbatches of "
        f"{len(ops_a)}/{len(ops_b)} ops")
    return best


def dbo_tpot(ops_half: Sequence[Op], compute_time, comm_time) -> Tuple[float, float]:
    """(TPOT with DBO, exposed_comm). `ops_half` is the op list at B/2 —
    the caller re-derives it at half batch (compute does NOT halve at small
    batch; that is the point of paper Fig. 6)."""
    a = to_timed(ops_half, compute_time, comm_time, 0)
    b = to_timed(ops_half, compute_time, comm_time, 1)
    res = dbo_best(a, b)
    return res.makespan, res.exposed_comm
