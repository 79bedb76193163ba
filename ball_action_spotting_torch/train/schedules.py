"""Learning-rate schedules (port of the JAX package's
``train/schedules.py``): the warmup and train stages fold into one schedule,
a linear warmup from 0 then a cosine decay to ``min_lr``; ``get_lr`` scales
the base rate linearly with the batch size. A schedule maps the count of
optimizer updates made so far (0 for the first) to the rate of the next."""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def get_lr(base_lr: float, batch_size: int, base_batch_size: int = 4) -> float:
    return base_lr * (batch_size / base_batch_size)


def warmup_cosine(lr: float, min_lr: float, warmup_steps: int, cosine_steps: int) -> Schedule:
    """Linear 0→lr over ``warmup_steps``, then cosine lr→min_lr over
    ``cosine_steps`` (flat at min_lr afterwards): optax's
    ``join_schedules([linear_schedule, cosine_decay_schedule])``."""
    if cosine_steps <= 0:
        raise ValueError(f"cosine_steps must be positive, got {cosine_steps}")
    alpha = min_lr / lr

    def schedule(count: int) -> float:
        if warmup_steps > 0:
            if count < warmup_steps:
                frac = 1.0 - count / warmup_steps
                return (0.0 - lr) * frac + lr
            count -= warmup_steps
        count = min(count, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / cosine_steps))
        return lr * ((1.0 - alpha) * cosine + alpha)

    return schedule
