"""Learning-rate schedules matching diffusers ``get_scheduler`` names.

Port of ``prompt_tts_tpu/train/lr.py``: every schedule is a function of the
optimizer update count (micro-steps of gradient accumulation do not count),
evaluated on the host in float64 and handed to the optimizer as a float.
"""

import math
from typing import Callable


def get_schedule(
    name: str,
    learning_rate: float,
    num_warmup_steps: int = 0,
    num_training_steps: int = 0,
    num_cycles: float = 0.5,
    power: float = 1.0,
) -> Callable[[int], float]:
    """Schedule by diffusers name: constant, constant_with_warmup, linear,
    cosine, cosine_with_restarts, polynomial."""
    warm = max(num_warmup_steps, 0)

    def warmup_frac(step):
        return min(1.0, step / max(warm, 1))

    def progress(step):
        return min(max((step - warm) / max(num_training_steps - warm, 1),
                       0.0), 1.0)

    if name == "constant":
        return lambda step: learning_rate

    if name == "constant_with_warmup":
        # the `step < warm` guard matters at warm=0: diffusers returns 1.0
        # there, while a bare min(1, step/max(warm,1)) yields 0 at step 0
        # and makes the first optimizer update a no-op
        return lambda step: learning_rate * (
            warmup_frac(step) if step < warm else 1.0)

    if name == "linear":
        def sched(step):
            decay = max(0.0, (num_training_steps - step)
                        / max(num_training_steps - warm, 1))
            return learning_rate * (warmup_frac(step) if step < warm
                                    else decay)
        return sched

    if name == "cosine":
        def sched(step):
            cos = 0.5 * (1.0 + math.cos(math.pi * 2.0 * num_cycles
                                        * progress(step)))
            return learning_rate * (warmup_frac(step) if step < warm
                                    else max(0.0, cos))
        return sched

    if name == "cosine_with_restarts":
        def sched(step):
            prog = progress(step)
            cos = 0.5 * (1.0 + math.cos(math.pi * ((prog * num_cycles)
                                                   % 1.0)))
            if step < warm:
                return learning_rate * warmup_frac(step)
            return learning_rate * (0.0 if prog >= 1.0 else max(0.0, cos))
        return sched

    if name == "polynomial":
        lr_end = 1e-7

        def sched(step):
            if step < warm:
                return learning_rate * warmup_frac(step)
            return ((learning_rate - lr_end) * (1 - progress(step)) ** power
                    + lr_end)
        return sched

    raise ValueError(f"unknown lr scheduler: {name}")
