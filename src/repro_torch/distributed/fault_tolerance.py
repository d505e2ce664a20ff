"""Fault tolerance, ported from ``repro/distributed/fault_tolerance.py``:
elastic re-meshing, the failure-injection hook and the straggler watchdog.

1. Recovery is "restart from the latest checkpoint"
   (:mod:`repro_torch.checkpoint.checkpointer` writes them atomically).
2. On a restart with fewer healthy ranks, :func:`plan_mesh` picks the
   largest usable (data, model) grid for the survivors, keeping the model
   axis at the largest size that still divides; checkpoints hold whole
   tensors, so a new grid reads them as they are.
3. The :class:`StragglerWatchdog` flags slow steps from an EWMA baseline,
   the hook a deployment wires to its scheduler.
"""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def plan_mesh(n_devices: int, *, model_parallel: int = 16,
              min_model_parallel: int = 1, pods: int = 1) -> MeshPlan:
    """Largest usable (data, model) grid for ``n_devices`` survivors.

    Keeps the requested model-parallel degree if possible, halving it
    until the count divides; ranks that do not fit the grid stay idle
    (cheaper than a smaller power-of-two grid)."""
    per_pod = n_devices // pods
    best: tuple[int, int, int] | None = None    # (used, mp, data)
    mp = model_parallel
    while mp >= max(min_model_parallel, 1):
        data = per_pod // mp
        if data >= 1:
            used = data * mp
            # maximise the ranks used; ties go to the higher degree
            if best is None or used > best[0]:
                best = (used, mp, data)
        mp //= 2
    if best is None:
        raise ValueError(f"cannot build a mesh from {n_devices} devices")
    _, mp, data = best
    if pods > 1:
        return MeshPlan((pods, data, mp), ("pod", "data", "model"))
    return MeshPlan((data, mp), ("data", "model"))


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
