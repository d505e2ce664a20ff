"""Fault tolerance for the single-device trainer, ported from
``repro/distributed/fault_tolerance.py``: the failure-injection hook and
the straggler watchdog.

Recovery is "restart from the latest checkpoint"
(:mod:`repro_torch.checkpoint.checkpointer` writes them atomically).  The
:class:`StragglerWatchdog` flags slow steps from an EWMA baseline, the hook
a deployment wires to its scheduler.  Elastic re-meshing (``plan_mesh``,
``MeshPlan``) comes with the multi-device slice of the port.
"""
from __future__ import annotations

import dataclasses
import time


class SimulatedFailure(RuntimeError):
    """Raised by the failure-injection hook in tests/examples."""


def failure_injector(fail_at_steps: set[int]):
    def hook(step: int) -> None:
        if step in fail_at_steps:
            fail_at_steps.discard(step)
            raise SimulatedFailure(f"injected failure at step {step}")
    return hook


@dataclasses.dataclass
class StragglerWatchdog:
    """EWMA step-time monitor.  ``check`` returns True when the last step
    exceeded ``threshold`` x the smoothed baseline (straggler signal)."""
    alpha: float = 0.1
    threshold: float = 2.0
    warmup_steps: int = 5
    _ewma: float = 0.0
    _count: int = 0
    _last_start: float = 0.0
    slow_steps: int = 0

    def start(self) -> None:
        self._last_start = time.monotonic()

    def stop(self) -> bool:
        dt = time.monotonic() - self._last_start
        self._count += 1
        if self._count <= self.warmup_steps:
            self._ewma = dt if self._ewma == 0 else \
                (1 - self.alpha) * self._ewma + self.alpha * dt
            return False
        is_slow = dt > self.threshold * self._ewma
        if is_slow:
            self.slow_steps += 1
        else:
            self._ewma = (1 - self.alpha) * self._ewma + self.alpha * dt
        return is_slow
