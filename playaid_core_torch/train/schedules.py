"""Learning-rate schedules of optax, as plain functions of the update
count (0 at the first update): the action trainer's warmup and cosine
decay (:func:`make_schedule`) and the digit net's cosine decay
(:func:`cosine_decay_schedule`)."""

from __future__ import annotations

import math


def _linear_schedule(init_value, end_value, transition_steps):
    """``optax.linear_schedule``."""
    def schedule(count):
        if transition_steps <= 0:
            return init_value
        frac = 1.0 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def cosine_decay_schedule(init_value, decay_steps, alpha=0.0):
    """``optax.cosine_decay_schedule``: ``init_value * ((1 - alpha) * 0.5 *
    (1 + cos(pi * min(count, decay_steps) / decay_steps)) + alpha)``."""
    def schedule(count):
        if decay_steps <= 0:
            return init_value
        cosine = 0.5 * (1 + math.cos(math.pi * min(count, decay_steps) / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)
    return schedule


def make_schedule(learning_rate, warmup_steps=200, decay_steps=None):
    """The JAX trainer's learning rate at update count ``count`` (from 0):
    ``optax.warmup_cosine_decay_schedule(0.05 lr, lr, warmup_steps or 1,
    decay_steps, 0.1 lr)`` when ``decay_steps``, else
    ``optax.linear_schedule(0.05 lr, lr, warmup_steps)`` when
    ``warmup_steps``, else ``lr``."""
    init_value = learning_rate * 0.05
    if decay_steps:
        warmup = warmup_steps or 1
        if not decay_steps - warmup > 0:
            raise ValueError(f"decay_steps {decay_steps} must exceed the warmup {warmup}")
        end_value = learning_rate * 0.1
        alpha = 0.0 if learning_rate == 0.0 else end_value / learning_rate
        ramp = _linear_schedule(init_value, learning_rate, warmup)
        decay = cosine_decay_schedule(learning_rate, decay_steps - warmup, alpha)

        def schedule(count):
            return ramp(count) if count < warmup else decay(count - warmup)
        return schedule
    if warmup_steps:
        return _linear_schedule(init_value, learning_rate, warmup_steps)
    return lambda count: learning_rate
