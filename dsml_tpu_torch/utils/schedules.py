"""Learning-rate schedules, the counterpart of ``dsml_tpu/utils/schedules.py``.

:func:`make_schedule` returns a plain function of the update count that
gives optax's values for the same arguments. Like optax, a caller evaluates
it at the count BEFORE the update: the first update of a warmup run uses
``schedule(0)``, which is 0. The trainers set each optimizer group's ``lr``
to ``schedule(count)`` right before ``step()``.

The loss-reactive ``plateau`` schedule (optax.contrib's reduce-on-plateau)
is not ported yet.
"""

from __future__ import annotations

import math
from typing import Callable

__all__ = ["make_schedule"]

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule: init → end over ``steps`` counts, then end."""
    if steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    """optax.cosine_decay_schedule."""

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        return init * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps)) + alpha)

    return schedule


def _join(schedules: list[Schedule], boundaries: list[int]) -> Schedule:
    """optax.join_schedules: each later schedule counts from its boundary."""

    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out

    return schedule


def make_schedule(
    name: str,
    base_lr: float,
    total_steps: int,
    warmup_steps: int = 0,
    *,
    step_every: int = 0,
    step_gamma: float = 0.1,
    end_lr_frac: float = 0.0,
) -> Schedule:
    """A schedule by name: ``constant | cosine | linear | step``, each with
    ``warmup_steps`` of linear warmup from 0. ``step`` decays by
    ``step_gamma`` every ``step_every`` updates (default: thirds of the
    run)."""
    if name == "plateau":
        raise NotImplementedError(
            "the plateau schedule (optax.contrib.reduce_on_plateau) is not ported yet; "
            "see ROADMAP.md"
        )
    total_steps = max(total_steps, 1)
    warmup_steps = min(max(warmup_steps, 0), total_steps - 1)  # leave >= 1 decay step
    if name == "constant":
        body: Schedule = lambda count: base_lr  # noqa: E731
    elif name == "cosine":
        # optax needs warmup >= 1 and a decay span > warmup
        warmup = max(warmup_steps, 1)
        decay = max(total_steps, warmup + 1)
        alpha = 0.0 if base_lr == 0.0 else end_lr_frac
        return _join([_linear(0.0, base_lr, warmup), _cosine(base_lr, decay - warmup, alpha)],
                     [warmup])
    elif name == "linear":
        body = _linear(base_lr, base_lr * end_lr_frac, total_steps - warmup_steps)
    elif name == "step":
        every = step_every or max(total_steps // 3, 1)
        boundaries = list(range(every, total_steps, every))

        def body(count: int) -> float:
            return base_lr * step_gamma ** sum(count >= b for b in boundaries)
    else:
        raise ValueError(f"unknown lr schedule {name!r}")
    if warmup_steps > 0:
        return _join([_linear(0.0, base_lr, warmup_steps), body], [warmup_steps])
    return body
