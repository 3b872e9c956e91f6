"""Speculative decoding TPOT model (paper section 3.3).

Multi-head (Medusa-style) SD:

  TPOT = (t_draft + t_verify) / (spec_m * spec_p)

t_draft  = one normal decode iteration (the target model step that also
           produces the draft heads' proposals).
t_verify = one iteration where attention q_len = spec_m and every other op
           sees batch * spec_m rows.

Defaults (spec_m, spec_p) = (4, 0.8) per the paper.

Layer: a combinator over iteration times — the scalar path feeds it
`optimizer.iteration_time`, the batched engines feed it
`GridEval.best_iteration(q)`; the 1e-9 parity contract covers the
combined TPOT because both sides evaluate this same formula.
"""
from __future__ import annotations

from dataclasses import dataclass

SPEC_M_DEFAULT = 4
SPEC_P_DEFAULT = 0.8


@dataclass(frozen=True)
class SpecDecConfig:
    spec_m: int = SPEC_M_DEFAULT
    spec_p: float = SPEC_P_DEFAULT

    @property
    def tokens_per_iteration(self) -> float:
        return self.spec_m * self.spec_p


def sd_tpot(t_draft: float, t_verify: float,
            sd: SpecDecConfig = SpecDecConfig()) -> float:
    return (t_draft + t_verify) / sd.tokens_per_iteration
