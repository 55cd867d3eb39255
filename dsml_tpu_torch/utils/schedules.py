"""Learning-rate schedules, the counterpart of ``dsml_tpu/utils/schedules.py``.

:func:`make_schedule` returns a plain function of the update count that
gives optax's values for the same arguments. Like optax, a caller evaluates
it at the count BEFORE the update: the first update of a warmup run uses
``schedule(0)``, which is 0. The trainers set each optimizer group's ``lr``
to ``schedule(count)`` right before ``step()``.

``plateau`` is the constant base of the loss-reactive scheduler, as in the
JAX package: :func:`adaptive_plateau` (optax.contrib's
``reduce_on_plateau``) keeps its state and rule, and the dp step multiplies
each update's learning rate by the scale it returns for that update's loss
(``parallel.dp.make_dp_train_step(plateau=...)``). The port's optimizers
are linear in the learning rate — SGD, momentum (the trace does not see
it), Adam, and AdamW, whose decoupled decay ``p·(1 - lr·wd)`` scales with
it as optax's ``scale · lr · (adam + wd·p)`` does — so a scaled learning
rate is optax's scaled update.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = ["PlateauState", "ReduceOnPlateau", "adaptive_plateau", "make_schedule",
           "wrap_with_plateau"]

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
    """A schedule by name: ``constant | cosine | linear | step | plateau``
    (``plateau``: constant; :func:`adaptive_plateau` scales it), each with
    ``warmup_steps`` of linear warmup from 0. ``step`` decays by
    ``step_gamma`` every ``step_every`` updates (default: thirds of the
    run)."""
    total_steps = max(total_steps, 1)
    warmup_steps = min(max(warmup_steps, 0), total_steps - 1)  # leave >= 1 decay step
    if name in ("constant", "plateau"):  # plateau = a constant base times the reactive scale
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


# ---------------------------------------------------------------------------
# reduce on plateau: the adaptive scheduler
# ---------------------------------------------------------------------------


class PlateauState(NamedTuple):
    """optax's ``ReduceLROnPlateauState``, field for field and in its order
    (a checkpoint names each leaf ``<path>/<field>``): 0-d CPU tensors,
    ``scale`` in the parameters' lowest dtype, ``best_value`` and
    ``avg_value`` float32, the counts int32."""

    scale: torch.Tensor
    best_value: torch.Tensor
    plateau_count: torch.Tensor
    cooldown_count: torch.Tensor
    count: torch.Tensor
    avg_value: torch.Tensor


_I32_MAX = 2**31 - 1
_MAX_PENDING = 4096  # device scalars held before an early fold


def _f32(v) -> float:
    return float(np.float32(v))


class ReduceOnPlateau:
    """``optax.contrib.reduce_on_plateau``'s state and rule, on the host.

    :meth:`update` takes each update's monitored value (a device scalar is
    read only when its window closes: one host read per
    ``accumulation_size`` updates) and returns the scale of that same
    update, which optax applies after the window's logic ran. The running
    mean ``(count·avg + v) / (count + 1)`` is float32 with ``count·avg + v``
    rounded once (XLA fuses it into one FMA); the improvement test, the
    patience, cooldown and ``min_scale`` rules are optax's, in the scale's
    dtype."""

    def __init__(self, factor: float = 0.1, patience: int = 10, rtol: float = 1e-4,
                 atol: float = 0.0, cooldown: int = 0, accumulation_size: int = 1,
                 min_scale: float = 0.0, dtype=torch.float32):
        if not 0.0 < factor < 1.0:
            raise ValueError(f"Factor must be in the range (0, 1), got factor = {factor}.")
        if rtol < 0.0 or atol < 0.0:
            raise ValueError(f"Both rtol and atol must be non-negative, got rtol = {rtol} "
                             f"and atol = {atol}.")
        if rtol == 0.0 and atol == 0.0:
            raise ValueError(f"At least one of rtol or atol must be positive, got rtol = {rtol} "
                             f"and atol = {atol}.")
        if rtol > 1.0:
            raise ValueError(f"rtol must be less than or equal to 1.0, got rtol = {rtol}.")
        self.factor, self.patience, self.rtol, self.atol = factor, patience, rtol, atol
        self.cooldown, self.accumulation_size, self.min_scale = cooldown, accumulation_size, min_scale
        self.dtype = dtype
        self._scale = torch.tensor(1.0, dtype=dtype)
        self._best, self._avg = _f32(math.inf), 0.0
        self._plateau = self._cooldown = self._count = 0
        self._pending: list = []  # values of the open window not yet folded into _avg

    def state(self) -> PlateauState:
        """The state after every value fed so far (reads pending values)."""
        self._fold()
        i32 = torch.int32
        return PlateauState(self._scale.clone(), torch.tensor(self._best, dtype=torch.float32),
                            torch.tensor(self._plateau, dtype=i32),
                            torch.tensor(self._cooldown, dtype=i32),
                            torch.tensor(self._count, dtype=i32),
                            torch.tensor(self._avg, dtype=torch.float32))

    def load_state(self, state) -> None:
        """Set the state from a :class:`PlateauState` (or a tree with its
        fields, e.g. a restored checkpoint's)."""
        get = (lambda k: getattr(state, k)) if hasattr(state, "_fields") else state.__getitem__
        self._scale = torch.as_tensor(get("scale")).detach().to("cpu", self.dtype).reshape(())
        self._best = _f32(get("best_value"))
        self._plateau, self._cooldown = int(get("plateau_count")), int(get("cooldown_count"))
        self._count, self._avg = int(get("count")), _f32(get("avg_value"))
        self._pending = []

    def update(self, value) -> float:
        """Feed one update's value; returns the scale that update takes."""
        self._pending.append(value)
        if self._count + len(self._pending) == self.accumulation_size:
            self._fold()
            self._update_scale()
        elif len(self._pending) >= _MAX_PENDING:  # a window that never closes (optax's ==)
            self._fold()
        return float(self._scale)

    def _fold(self) -> None:
        if not self._pending:
            return
        vals = [v.detach().float().reshape(()) if torch.is_tensor(v) else torch.tensor(float(v))
                for v in self._pending]
        self._pending = []
        for v in torch.stack([t.to(vals[0].device) for t in vals]).tolist():  # one read
            c = self._count
            num = _f32(_f32(c) * self._avg + v)  # exact product, one rounding: the FMA
            self._avg = float(np.float32(num) / np.float32(min(c + 1, _I32_MAX)))
            self._count = min(c + 1, _I32_MAX)

    def _update_scale(self) -> None:
        threshold = _f32(_f32(1 - self.rtol) * self._best - _f32(self.atol))
        improved = self._avg < threshold
        if improved:
            self._best = self._avg
        plateau = 0 if improved else min(self._plateau + 1, _I32_MAX)
        dt = self.dtype
        if self._cooldown > 0:
            self._plateau, self._cooldown = 0, self._cooldown - 1
        else:
            hit = plateau == self.patience
            scale = self._scale * torch.tensor(self.factor, dtype=dt) if hit else self._scale
            self._scale = torch.maximum(scale, torch.tensor(self.min_scale, dtype=dt))
            self._plateau = 0 if hit else plateau
            self._cooldown = self.cooldown if hit else 0
        self._count, self._avg = 0, 0.0


def adaptive_plateau(factor: float = 0.5, patience: int = 5, rtol: float = 1e-4,
                     cooldown: int = 0, accumulation_size: int = 1, min_scale: float = 1e-3,
                     dtype=torch.float32) -> ReduceOnPlateau:
    """The reduce-on-plateau scheduler with the JAX package's defaults: a
    scale on every update that shrinks by ``factor`` after ``patience``
    non-improving window means of the loss. ``dtype`` is the scale's (optax
    takes the parameters' lowest)."""
    return ReduceOnPlateau(factor=factor, patience=patience, rtol=rtol, cooldown=cooldown,
                           accumulation_size=accumulation_size, min_scale=min_scale, dtype=dtype)


def wrap_with_plateau(optimizer: torch.optim.Optimizer, **kwargs) -> ReduceOnPlateau:
    """:func:`adaptive_plateau` for ``optimizer``'s parameters (the scale in
    their lowest float dtype, as optax's ``init``): pass it to the dp step,
    which scales each update's learning rate by it."""
    dtypes = {p.dtype for g in optimizer.param_groups for p in g["params"]}
    lowest = min(dtypes, key=lambda d: torch.finfo(d).bits) if dtypes else torch.float32
    return adaptive_plateau(dtype=lowest, **kwargs)
