"""Metrics writer: one JSON line per scalar.

Port of ``prompt_tts_tpu/utils/metrics.py``, JSONL mirror only: the port
writes no TensorBoard event files, so it needs no tensorboard package.
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
