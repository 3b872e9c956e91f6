"""What a driver is given and what it hands back to ``run.py``."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass
class Context:
    cell: dict                 # the workload's entry in BENCHMARK.json
    config: dict               # the configuration file
    run: dict                  # its run values (``spec.run_values``)
    traffic: dict              # the traffic file
    seed: int
    seconds: float
    trace: bool
    t_start: float             # process start, ``time.perf_counter()``'s clock
    fp8_control: bool = False  # also read the control (tests and limit runs)


@dataclasses.dataclass
class Outcome:
    correct: bool
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    readings: Any              # what the per-layer readers read (trace runs)
    checks: Dict[str, Dict[str, float]]   # name -> {"value", "limit"}
    device: Dict[str, Any]
    breakdown: Optional[dict] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
