"""Debugging aids: finite checks on the metrics the trainer pulls.

Port of ``finite_or_warn`` from ``prompt_tts_tpu/utils/debug.py``.
"""

import math


def finite_or_warn(metrics: dict, step: int, log) -> bool:
    """Cheap per-step guard on scalar metrics; returns False on NaN/Inf."""
    for k, v in metrics.items():
        v = float(v)
        if not math.isfinite(v):
            log.error("non-finite metric %s=%s at step %d", k, v, step)
            return False
    return True
