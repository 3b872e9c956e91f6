"""Failure injection for the training drills and the serving-side fault
sweeps.

The port's own copy of ``repro.faults``: ``WorkerFailure`` and
``FailureInjector`` drive the training recovery loop, and
``sample_faultset`` draws seeded random ``FaultSet``s from the component
inventory that ``core.availability`` prices (the fault plans of
``core.traffic``). Everything here is deterministic given its seed: the
injector takes explicit step indices or a seed, never the clock or global
random state.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import numpy as np

# annotations only: a run-time import would cycle (core imports traffic,
# which imports this module)
if TYPE_CHECKING:
    from repro_torch.core.topology import Cluster, FaultSet


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


def sample_faultset(cluster: Cluster, *, exposure_h: float,
                    seed: int = 0,
                    mtbf_mttr: Optional[Dict[str, Tuple[float, float]]]
                    = None) -> FaultSet:
    """Draw one seeded random `FaultSet` for `cluster`: each component
    class fails Poisson(count x exposure_h / MTBF) times over the exposure
    window, mapped onto the serving model's fault axes by the same
    blast-radius rules the availability enumeration uses
    (`availability.faultset_for_counts`). Deterministic per seed."""
    from repro_torch.core.availability import (component_inventory,
                                               faultset_for_counts)
    if exposure_h < 0:
        raise ValueError(f"exposure_h must be >= 0, got {exposure_h}")
    rng = np.random.default_rng(seed)
    counts = {c.name: int(rng.poisson(c.count * exposure_h / c.mtbf_h))
              for c in component_inventory(cluster, mtbf_mttr)}
    return faultset_for_counts(cluster, counts)
