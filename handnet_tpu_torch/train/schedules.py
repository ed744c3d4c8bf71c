"""Learning-rate schedules of ``handnet_tpu/train/schedules.py``, as plain
functions of the update count.

The JAX package builds them from optax, which evaluates a schedule at the
count of updates made *before* the current one: the first update uses
``schedule(0)``, which is ``lr * 1e-3`` under the warmup. ``TrainState``
(``train/trainer.py``) calls the schedule the same way. Values are computed
in float32 in optax's order of operations, so they are optax's own bits:

* ``optax.piecewise_constant_schedule`` scales by each boundary's factor
  from the count equal to the boundary on;
* ``optax.linear_schedule`` is ``(init - end) * (1 - count / steps) + end``
  with the count clipped to ``[0, steps]``.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import numpy as np

Schedule = Callable[[int], float]


def _piecewise_constant(base_lr: float, boundaries: Dict[int, float]) -> Schedule:
    def schedule(count: int) -> float:
        v = np.float32(base_lr)
        for threshold, scale in sorted(boundaries.items()):
            if count >= threshold:
                v = np.float32(scale) * v
        return float(v)

    return schedule


def _linear(init_value: float, end_value: float, steps: int) -> Schedule:
    def schedule(count: int) -> float:
        frac = np.float32(1) - np.float32(min(max(count, 0), steps)) / np.float32(steps)
        return float(np.float32(init_value - end_value) * frac + np.float32(end_value))

    return schedule


def step_decay(base_lr: float, steps_per_epoch: int, step_size_epochs: int = 10,
               gamma: float = 0.2) -> Schedule:
    """torch's StepLR: ``gamma`` every ``step_size_epochs`` epochs (A2J,
    config/a2j.yaml:8-30), over 49 boundaries as in the JAX package."""
    return _piecewise_constant(base_lr, {i * step_size_epochs * steps_per_epoch: gamma
                                         for i in range(1, 50)})


def multistep_with_warmup(base_lr: float, steps_per_epoch: int,
                          milestones_epochs: Sequence[int] = (20, 35), gamma: float = 0.1,
                          warmup_epochs: float = 1.0,
                          warmup_start_factor: float = 1e-3) -> Schedule:
    """MultiStepLR with the reference's linear warmup from ``lr *
    warmup_start_factor`` over the first ``warmup_epochs`` epochs
    (trainval_net_fcos.py:33-39)."""
    warmup_steps = max(int(warmup_epochs * steps_per_epoch), 1)
    warmup = _linear(base_lr * warmup_start_factor, base_lr, warmup_steps)
    main = _piecewise_constant(base_lr, {m * steps_per_epoch: gamma
                                         for m in milestones_epochs})
    return lambda count: warmup(count) if count < warmup_steps else main(count)
