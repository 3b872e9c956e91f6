"""Failure injection for the training drills.

The port's own copy of ``WorkerFailure`` and ``FailureInjector`` from
``repro.faults``. The serving-side ``sample_faultset`` stays behind: it
draws from the cost model's component inventory, which the port does not
carry. Everything here is deterministic given its seed: the injector takes
explicit step indices or a seed, never the clock or global random state.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np


class WorkerFailure(RuntimeError):
    """A worker (or its host / link) died during a step."""


@dataclass
class FailureInjector:
    """Raise WorkerFailure at the configured step indices (once each)."""
    fail_at: List[int] = field(default_factory=list)
    fired: List[int] = field(default_factory=list)

    def check(self, step: int):
        if step in self.fail_at and step not in self.fired:
            self.fired.append(step)
            raise WorkerFailure(f"injected failure at step {step}")

    @classmethod
    def seeded(cls, n_steps: int, rate: float,
               seed: int = 0) -> "FailureInjector":
        """Deterministic Bernoulli(rate)-per-step failure plan over
        `n_steps` (the JAX package's draws for the same seed)."""
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {rate}")
        rng = np.random.default_rng(seed)
        hits = np.nonzero(rng.random(n_steps) < rate)[0]
        return cls(fail_at=[int(s) for s in hits])
