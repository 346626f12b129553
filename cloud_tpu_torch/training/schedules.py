"""Learning-rate schedules: step -> learning rate callables.

The port of `cloud_tpu/training/schedules.py`, with the optax
schedules it names written out (`linear_schedule`,
`cosine_decay_schedule`, `join_schedules`), so each value equals the
JAX package's at every step. Pass one as the learning rate of a
Trainer optimizer (`trainer.make_optimizer(name, schedule)`): it is read
at the optimizer's update count, 0 for the first update, as optax reads
it.
"""

import math


def _linear(init_value, end_value, transition_steps):
    def schedule(step):
        if transition_steps <= 0:
            return float(init_value)
        count = min(max(step, 0), transition_steps)
        frac = 1.0 - count / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def _cosine(init_value, decay_steps, alpha):
    if not decay_steps > 0:
        raise ValueError("The cosine decay requires positive decay_steps, "
                         "got decay_steps={}.".format(decay_steps))

    def schedule(step):
        count = min(step, decay_steps)
        decay = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1.0 - alpha) * decay + alpha)
    return schedule


def _join(schedules, boundaries):
    def schedule(step):
        value = schedules[0](step)
        for boundary, s in zip(boundaries, schedules[1:]):
            if step >= boundary:
                value = s(step - boundary)
        return value
    return schedule


def warmup_cosine(peak_lr, total_steps, warmup_steps=None, end_lr=0.0):
    """Linear warmup to `peak_lr`, cosine decay to `end_lr` at
    `total_steps`. `warmup_steps` defaults to 10% of `total_steps`."""
    if warmup_steps is None:
        warmup_steps = max(total_steps // 10, 1)
    alpha = 0.0 if peak_lr == 0.0 else end_lr / peak_lr
    return _join([_linear(0.0, peak_lr, warmup_steps),
                  _cosine(peak_lr, total_steps - warmup_steps, alpha)],
                 [warmup_steps])


def warmup_linear(peak_lr, total_steps, warmup_steps=None, end_lr=0.0):
    """Linear warmup then linear decay (the BERT fine-tuning shape)."""
    if warmup_steps is None:
        warmup_steps = max(total_steps // 10, 1)
    return _join([_linear(0.0, peak_lr, warmup_steps),
                  _linear(peak_lr, end_lr,
                          max(total_steps - warmup_steps, 1))],
                 [warmup_steps])


def inverse_sqrt(peak_lr, warmup_steps=1000):
    """Noam/Transformer schedule: linear warmup, then 1/sqrt(step)."""

    def schedule(step):
        s = float(step) + 1.0
        return min(peak_lr * s / warmup_steps,
                   peak_lr * (warmup_steps ** 0.5) / math.sqrt(s))
    return schedule


def constant(lr):
    """A constant schedule (symmetry with the named shapes)."""
    return lambda step: float(lr)


__all__ = ["constant", "inverse_sqrt", "warmup_cosine", "warmup_linear"]
