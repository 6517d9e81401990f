"""Decode-only unigram (sentencepiece-style) tokenizer shim for ASR.

The port's copy of ``prompt_tts_tpu/data/unigram.py`` (the port imports
nothing of the JAX package); the same code.

The reference's pseudo-labeling path decodes Speech2Text ``generate``
output with a sentencepiece-backed tokenizer
(reference data_preparation/asr/generate_transcript.py:13-18,59) — but
this tool only ever DECODES (ids -> text); the sentencepiece dependency
is needed for encoding, which the ASR path never does.  This shim
reimplements exactly the decode half from the checkpoint's
``vocab.json``: drop special ids, map ids to tokens, join, and apply the
sentencepiece whitespace convention (``▁`` word-boundary marker ->
space).  It lets the seq2seq Speech2Text branch run in environments
without the sentencepiece wheel.
"""

import json
import os
from typing import List, Sequence

_SPM_SPACE = "▁"  # sentencepiece word-boundary marker


class UnigramDecoder:
    """ids -> text via the checkpoint's ``vocab.json``.

    Matches ``Speech2TextTokenizer.batch_decode(..., skip_special_tokens=
    True)`` semantics for the decode direction: special tokens (from
    ``special_tokens_map.json`` when present, else the conventional
    ``<s> </s> <pad> <unk>``) are dropped, remaining tokens are joined
    and the SPM space marker becomes a real space.
    """

    def __init__(self, model_dir: str):
        with open(os.path.join(model_dir, "vocab.json")) as f:
            vocab = json.load(f)
        self.id_to_token = {int(i): t for t, i in vocab.items()}
        special = {"<s>", "</s>", "<pad>", "<unk>"}
        sp_path = os.path.join(model_dir, "special_tokens_map.json")
        if os.path.exists(sp_path):
            with open(sp_path) as f:
                for v in json.load(f).values():
                    # values are strings, {"content": ...} dicts, or LISTS
                    # of either (additional_special_tokens)
                    items = v if isinstance(v, list) else [v]
                    for item in items:
                        special.add(item["content"]
                                    if isinstance(item, dict) else item)
        self.special_ids = {i for i, t in self.id_to_token.items()
                            if t in special}

    def decode(self, ids: Sequence[int]) -> str:
        toks = [self.id_to_token.get(int(i), "")
                for i in ids if int(i) not in self.special_ids]
        return "".join(toks).replace(_SPM_SPACE, " ").strip()

    def batch_decode(self, batch_ids, skip_special_tokens: bool = True
                     ) -> List[str]:
        # skip_special_tokens accepted for interface parity; this decoder
        # always skips them (the only mode the ASR tool uses)
        return [self.decode(ids) for ids in batch_ids]


class UnigramProcessor:
    """Feature-extractor + decode-only tokenizer, quacking like
    ``Speech2TextProcessor`` for the two calls the ASR tool makes
    (``__call__`` on raw audio, ``batch_decode`` on generated ids)."""

    def __init__(self, feature_extractor, model_dir: str):
        self.feature_extractor = feature_extractor
        self.tokenizer = UnigramDecoder(model_dir)

    def __call__(self, *args, **kwargs):
        return self.feature_extractor(*args, **kwargs)

    def batch_decode(self, ids, **kwargs) -> List[str]:
        return self.tokenizer.batch_decode(ids, **kwargs)
