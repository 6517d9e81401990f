"""Streaming dataset: batches read lazily from the tar through the native
index.

Port of ``prompt_tts_tpu/data/streaming.py``.  The in-RAM
:class:`~prompt_tts_tpu_torch.data.dataset.CodeDataset` holds every code
matrix; this dataset keeps only the tar's index and the tokenized text in
memory and reads each batch's codes when it is made (a native ``pread``
when :mod:`~prompt_tts_tpu_torch.data.native` is built), collated by the
native library in a background thread (:func:`prefetch`) while the device
runs the step before.  Its batches are the in-RAM dataset's, prompt crops
included (the same crop seed).  ``process_shard=(rank, count)`` yields
one process's rows of each global batch, and the rows of the other
processes are never read from the tar.
"""

from typing import Dict, Iterator, Optional

import numpy as np

from prompt_tts_tpu_torch.data import native
from prompt_tts_tpu_torch.data.dataset import (
    _batch_order, _crop_prompts, crop_seed, local_rows, prefetch,
)
from prompt_tts_tpu_torch.frontend.tokenizer import Tokenizer


class StreamingCodeDataset:
    """Lazy-reading dataset over a processed code tar."""

    def __init__(self, tar_path: str, max_seq_length: int = 550,
                 tokenizer: Optional[Tokenizer] = None,
                 prompt_frames: Optional[int] = None,
                 prefetch_depth: int = 2):
        self.tar_path = tar_path
        self.max_seq_length = max_seq_length
        self.prompt_frames = prompt_frames
        self.prefetch_depth = prefetch_depth
        tok = tokenizer or Tokenizer(max_len=max_seq_length)

        index = {name: (off, size)
                 for name, off, size in native.tar_index(tar_path)}
        self._items = []  # (npy_off, npy_size, ids, mask, code_len)
        for name, (off, size) in sorted(index.items()):
            if not name.endswith(".npy"):
                continue
            stem = name[: -len(".npy")]
            txt_key = (stem + ".normalized.txt"
                       if stem + ".normalized.txt" in index
                       else stem + ".txt")
            if txt_key not in index or stem + ".len.txt" not in index:
                continue
            text = native.read_at(tar_path, *index[txt_key]).decode()
            length = float(native.read_at(
                tar_path, *index[stem + ".len.txt"]).decode())
            ids, mask = tok.encode(text)
            self._items.append((off, size, ids, mask, int(length)))

    def __len__(self) -> int:
        return len(self._items)

    def _load_codes(self, i: int) -> np.ndarray:
        off, size, _, _, _ = self._items[i]
        return native.npy_to_i16(native.read_at(self.tar_path, off, size))

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0,
                drop_last: bool = True,
                process_shard=None) -> Iterator[Dict[str, np.ndarray]]:
        """Whole batches (``drop_last`` is accepted for the interface and,
        as in the JAX package, always holds), made ``prefetch_depth`` ahead
        in a background thread.  Close the returned generator to stop that
        thread early.  ``process_shard=(rank, count)``: only this
        process's rows of each global batch, the only rows read."""
        def gen():
            for start, idx in _batch_order(len(self), batch_size, shuffle,
                                           seed, True):
                idx = local_rows(idx, process_shard)
                latents = native.collate_codes(
                    np.stack([self._load_codes(i) for i in idx]))
                batch = {
                    "codes": latents,
                    "text_ids": np.stack([self._items[i][2] for i in idx]),
                    "text_mask": np.stack([self._items[i][3] for i in idx]),
                    "code_len": np.asarray([self._items[i][4] for i in idx],
                                           np.int32),
                }
                if self.prompt_frames:
                    batch["prompt"] = _crop_prompts(
                        latents, batch["code_len"], self.prompt_frames,
                        seed=crop_seed(seed, start, process_shard))
                yield batch

        return prefetch(gen(), depth=self.prefetch_depth)
