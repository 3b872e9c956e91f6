"""Failure handling: the checkpoint-backed recovery loop.

Port of ``repro.training.fault_tolerance``. A failure is detected at a
step boundary; the trainer restores the last atomic checkpoint and the
(deterministic, seekable) data stream resumes at the restored step, until
the target step, bounded by `max_restarts` (a crash-looping job must page
a human, not spin). ``WorkerFailure`` and ``FailureInjector`` come from
``repro_torch.faults``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from repro_torch.faults import FailureInjector, WorkerFailure
from repro_torch.training.data import SyntheticLM
from repro_torch.training.train_loop import Trainer

__all__ = ["WorkerFailure", "FailureInjector", "RecoveryReport",
           "run_with_recovery"]


@dataclass
class RecoveryReport:
    restarts: int
    completed_steps: int
    losses: List[float]
    recovery_log: List[str]


def run_with_recovery(trainer: Trainer, data: SyntheticLM, n_steps: int, *,
                      injector: Optional[FailureInjector] = None,
                      max_restarts: int = 5) -> RecoveryReport:
    """Drive training to `n_steps`, recovering from WorkerFailure by
    restoring the latest checkpoint. Needs ``trainer.tc.ckpt_every > 0``."""
    if not (trainer.tc.ckpt_every > 0 and trainer.tc.ckpt_dir):
        raise ValueError("recovery needs periodic checkpoints")
    restarts = 0
    log: List[str] = []
    trainer.save()              # so that a failure at step 0 is recoverable
    while trainer.step_idx < n_steps:
        try:
            tokens = data.batch(trainer.step_idx)
            if injector is not None:
                injector.check(trainer.step_idx)
            trainer.train_step(tokens)
        except WorkerFailure as e:
            restarts += 1
            if restarts > max_restarts:
                raise RuntimeError(
                    f"exceeded {max_restarts} restarts; aborting") from e
            at = trainer.restore()
            log.append(f"{e} -> restored step {at} (restart {restarts})")
    return RecoveryReport(restarts=restarts, completed_steps=trainer.step_idx,
                          losses=trainer.losses, recovery_log=log)
