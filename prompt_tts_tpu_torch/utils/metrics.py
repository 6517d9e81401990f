"""Metrics writer: one JSON line per scalar.

Port of ``prompt_tts_tpu/utils/metrics.py``, JSONL mirror only: the port
writes no TensorBoard event files, so it needs no tensorboard package.
``NullMetricsWriter`` is what the ranks other than 0 write with under data
parallelism: nothing.
"""

import json
import os
import time


class MetricsWriter:
    def __init__(self, log_dir: str, jsonl_name: str = "metrics.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self._log_dir = log_dir
        self.path = os.path.join(log_dir, jsonl_name)
        self._jsonl = open(self.path, "a")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value),
                                      "step": int(step),
                                      "ts": time.time()}) + "\n")

    def flush(self) -> None:
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()


class NullMetricsWriter:
    """A writer with :class:`MetricsWriter`'s interface that writes
    nothing: the ranks other than 0 take it, so only rank 0 writes files
    (the reference's ``is_main_process`` gating, reference
    train.py:75,140)."""

    def __init__(self, log_dir: str):
        self._log_dir = log_dir

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass
