"""Static-shape tokenizer: text -> fixed-length id/mask arrays.

This is the TPU-facing edge of the frontend.  It combines the reference's
phonemize + intersperse + pad/mask steps (reference tts/dataloader.py:12-15,
52-55, 123-137, tts/get_cmu.py:8-11) into one host-side call that always
produces arrays of a static shape, so downstream jitted functions never see
a dynamic dimension.

Encoding per utterance:
  1. ``text_to_sequence(text, ["english_cleaners"], cmudict)``
  2. intersperse with the separator id ``len(SYMBOLS)`` == 148
     (so vocab size must be >= 149)
  3. right-pad with 0 (the pad symbol id) to ``max_len`` and emit a 0/1 mask.
"""

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from prompt_tts_tpu_torch.frontend import text_to_sequence
from prompt_tts_tpu_torch.frontend.cmudict import CMUDict, default_cmudict
from prompt_tts_tpu_torch.frontend.symbols import SYMBOLS

# Separator id used between every symbol (reference tts/dataloader.py:52-55).
SEP_ID = len(SYMBOLS)  # == 148
# Minimum vocabulary a model must allocate to cover all emitted ids.
MIN_VOCAB = SEP_ID + 1  # == 149
# Reference CLI default for the padded sequence length (reference train.py:164-165).
DEFAULT_MAX_LEN = 550

PAD_ID = 0


def intersperse(seq: Sequence[int], item: int) -> List[int]:
    """[a, b] -> [item, a, item, b, item] (reference tts/dataloader.py:12-15)."""
    result = [item] * (len(seq) * 2 + 1)
    result[1::2] = list(seq)
    return result


@dataclass
class Tokenizer:
    """Host-side text encoder producing fixed-shape numpy batches."""

    max_len: int = DEFAULT_MAX_LEN
    cleaner_names: Sequence[str] = ("english_cleaners",)
    cmudict: Optional[CMUDict] = None

    def __post_init__(self):
        if self.cmudict is None:
            self.cmudict = default_cmudict()
        import threading
        self._cache: dict = {}
        self._cache_max = 4096
        self._cache_lock = threading.Lock()  # serve tokenizes from threads

    def ids(self, text: str) -> List[int]:
        """Variable-length interspersed id sequence for one utterance.

        Results are memoized (serving re-tokenizes repeated texts —
        warmups, retries, popular phrases; phonemization is the only
        ms-scale host step on the request path)."""
        with self._cache_lock:
            cached = self._cache.get(text)
        if cached is None:
            cached = intersperse(
                text_to_sequence(text, list(self.cleaner_names),
                                 self.cmudict),
                SEP_ID,
            )
            with self._cache_lock:
                if len(self._cache) >= self._cache_max:
                    self._cache.pop(next(iter(self._cache)))  # FIFO evict
                self._cache[text] = cached
        return list(cached)

    def encode(self, text: str):
        """One utterance -> (ids[max_len] int32, mask[max_len] int32)."""
        ids_arr, mask = self.encode_batch([text])
        return ids_arr[0], mask[0]

    def encode_batch(self, texts: Sequence[str]):
        """Batch of texts -> (ids[B, max_len], mask[B, max_len]) int32.

        Sequences longer than ``max_len`` are truncated, matching the
        reference collate (reference tts/dataloader.py:123-137).
        """
        batch = np.full((len(texts), self.max_len), PAD_ID, dtype=np.int32)
        mask = np.zeros((len(texts), self.max_len), dtype=np.int32)
        for i, text in enumerate(texts):
            seq = self.ids(text)[: self.max_len]
            batch[i, : len(seq)] = seq
            mask[i, : len(seq)] = 1
        return batch, mask
