"""Datasets over processed code tars + synthetic data for smoke tests.

Port of ``prompt_tts_tpu/data/dataset.py`` for the single-speaker model.
Corpus format (reference data_preparation/generate_code.py:54-86): an
uncompressed tar holding, per utterance, ``<id>.npy`` (EnCodec codes
``[8, T]`` int), ``<id>.len.txt`` (true frame count), ``<id>.txt`` and
optionally ``<id>.normalized.txt``.  Codes stay int16 in RAM; batches come
out channels-last ``[B, T, 8]`` float32 in [-1, 1] (``c * 2/1023 - 1``),
collated with numpy alone; text is phonemized once at load by the
static-shape tokenizer.  Prompt crops, streaming and per-process sharding
are not ported.
"""

import io
import queue
import tarfile
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from prompt_tts_tpu_torch.frontend.tokenizer import Tokenizer

_CODE_SCALE = 2.0 / 1023.0  # c/1023 then (x-0.5)/0.5


def collate_codes(codes: np.ndarray) -> np.ndarray:
    """int ``[B, n_q, T]`` -> float32 latents ``[B, T, n_q]`` in [-1, 1]."""
    out = codes.astype(np.float32) * _CODE_SCALE - 1.0
    return np.ascontiguousarray(out.transpose(0, 2, 1))


def prefetch(iterator: Iterator, depth: int = 2) -> Iterator:
    """Run ``iterator`` in a background thread, ``depth`` items ahead, so
    batch collation overlaps device work."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()
    errors = []

    def worker():
        try:
            for item in iterator:
                if stop.is_set():
                    break
                q.put(item)
        except Exception as e:   # raised again in the consumer
            errors.append(e)
        finally:
            # the consumer waits for the sentinel, so it must arrive even
            # when the queue is full; only a consumer that has gone
            # (stop set) no longer needs it
            while not stop.is_set():
                try:
                    q.put(sentinel, timeout=0.1)
                    break
                except queue.Full:
                    pass

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if errors:
                    raise errors[0]
                break
            yield item
    finally:
        # a consumer that abandons the generator must not leak the worker:
        # signal stop, then drain so a worker blocked in q.put() wakes
        stop.set()
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break


def _batch_order(n: int, batch_size: int, shuffle: bool, seed: int,
                 drop_last: bool) -> Iterator[np.ndarray]:
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    stop = n - batch_size + 1 if drop_last else n
    for start in range(0, max(stop, 0), batch_size):
        yield order[start: start + batch_size]


class CodeDataset:
    """In-RAM dataset over a processed code tar (LJSpeech-scale)."""

    def __init__(self, tar_path: str, max_seq_length: int = 550,
                 tokenizer: Optional[Tokenizer] = None):
        self.max_seq_length = max_seq_length
        tok = tokenizer or Tokenizer(max_len=max_seq_length)
        self.codes: List[np.ndarray] = []
        self.text_ids: List[np.ndarray] = []
        self.text_mask: List[np.ndarray] = []
        self.code_len: List[int] = []
        self.texts: List[str] = []
        with tarfile.open(tar_path, "r") as tf:
            names = set(tf.getnames())
            for name in sorted(n for n in names if n.endswith(".npy")):
                stem = name[: -len(".npy")]
                code = np.load(io.BytesIO(tf.extractfile(name).read()))
                if code.ndim != 2:
                    raise ValueError(f"{name}: expected [n_q, T] codes")
                text = tf.extractfile(stem + ".txt").read().decode()
                norm_name = stem + ".normalized.txt"
                text_norm = (tf.extractfile(norm_name).read().decode()
                             if norm_name in names else text)
                length = float(
                    tf.extractfile(stem + ".len.txt").read().decode())
                ids, mask = tok.encode(text_norm)
                self.codes.append(code.astype(np.int16))
                self.text_ids.append(ids)
                self.text_mask.append(mask)
                self.code_len.append(int(length))
                self.texts.append(text)

    def __len__(self) -> int:
        return len(self.codes)

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0,
                drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        """Fixed-shape numpy batches."""
        for idx in _batch_order(len(self), batch_size, shuffle, seed,
                                drop_last):
            yield {
                "codes": collate_codes(np.stack([self.codes[i]
                                                 for i in idx])),
                "text_ids": np.stack([self.text_ids[i] for i in idx]),
                "text_mask": np.stack([self.text_mask[i] for i in idx]),
                "code_len": np.asarray([self.code_len[i] for i in idx],
                                       np.int32),
            }


class SyntheticDataset:
    """Deterministic fake corpus for smoke tests and compile checks."""

    def __init__(self, n: int = 64, frames: int = 900, n_q: int = 8,
                 max_seq_length: int = 550, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.codes = rng.integers(
            0, 1024, size=(n, n_q, frames)).astype(np.int16)
        lens = rng.integers(8, max_seq_length // 2, size=n)
        self.text_ids = np.zeros((n, max_seq_length), np.int32)
        self.text_mask = np.zeros((n, max_seq_length), np.int32)
        for i, ln in enumerate(lens):
            self.text_ids[i, :ln] = rng.integers(1, 149, size=ln)
            self.text_mask[i, :ln] = 1
        self.code_len = np.full((n,), frames, np.int32)

    def __len__(self) -> int:
        return self.codes.shape[0]

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0,
                drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        # always whole batches, as in the JAX package
        for idx in _batch_order(len(self), batch_size, shuffle, seed, True):
            yield {
                "codes": collate_codes(self.codes[idx]),
                "text_ids": self.text_ids[idx],
                "text_mask": self.text_mask[idx],
                "code_len": self.code_len[idx],
            }
