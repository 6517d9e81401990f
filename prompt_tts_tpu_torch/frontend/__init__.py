"""Text frontend: normalization, phonemization, and symbol-id encoding.

Public surface mirrors the reference frontend
(reference tts/process_text/__init__.py:23-100):

* :func:`text_to_sequence` — text -> list of symbol ids, with optional CMU
  phonemization and inline ``{ARPAbet}`` spans.
* :func:`sequence_to_text` — inverse mapping for debugging.
* :class:`prompt_tts_tpu_torch.frontend.tokenizer.Tokenizer` — the static-shape
  batch encoder used by the data/model layers (ids + mask, fixed length).

Behavioral quirks kept for parity with the reference:

* a word found in CMUdict uses its FIRST pronunciation
  (reference __init__.py:15-20);
* out-of-vocabulary words fall back to character symbols;
* the pad symbol ``_`` (and ``~``) are never emitted
  (reference __init__.py:99-100);
* each word (or phone span) is followed by a space id, and one trailing
  space is stripped (reference __init__.py:46-65).
"""

import re

from prompt_tts_tpu_torch.frontend import cleaners as _cleaners_mod
from prompt_tts_tpu_torch.frontend.cmudict import CMUDict, default_cmudict
from prompt_tts_tpu_torch.frontend.symbols import SYMBOLS, SYMBOL_TO_ID, ID_TO_SYMBOL

__all__ = [
    "text_to_sequence", "sequence_to_text", "CMUDict", "default_cmudict",
    "SYMBOLS",
]

# Text enclosed in curly braces is treated as an inline ARPAbet span.
_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")

_SPACE_ID = SYMBOL_TO_ID[" "]


def _get_arpabet(word: str, dictionary) -> str:
    prons = dictionary.lookup(word)
    if prons is not None:
        return "{" + prons[0] + "}"
    return word


def text_to_sequence(text, cleaner_names, dictionary=None):
    """Convert text to a list of symbol ids.

    Args:
      text: input string; may embed ``{HH AW1 S}``-style ARPAbet spans.
      cleaner_names: names of cleaner functions in
        :mod:`prompt_tts_tpu_torch.frontend.cleaners` to apply, in order.
      dictionary: optional :class:`CMUDict`; when given, each cleaned word is
        phonemized (first pronunciation) with character fallback.
    """
    sequence = []
    space = [_SPACE_ID]
    while len(text):
        m = _curly_re.match(text)
        if not m:
            clean_text = _clean_text(text, cleaner_names)
            if dictionary is not None:
                words = [_get_arpabet(w, dictionary)
                         for w in clean_text.split(" ")]
                for t in words:
                    if t.startswith("{"):
                        sequence += _arpabet_to_sequence(t[1:-1])
                    else:
                        sequence += _symbols_to_sequence(t)
                    sequence += space
            else:
                sequence += _symbols_to_sequence(clean_text)
            break
        sequence += _symbols_to_sequence(_clean_text(m.group(1), cleaner_names))
        sequence += _arpabet_to_sequence(m.group(2))
        text = m.group(3)

    # strip the single trailing word-separator space
    if dictionary is not None and sequence and sequence[-1] == _SPACE_ID:
        sequence = sequence[:-1]
    return sequence


def sequence_to_text(sequence) -> str:
    """Inverse of :func:`text_to_sequence` (ARPAbet re-braced)."""
    result = ""
    for symbol_id in sequence:
        s = ID_TO_SYMBOL.get(int(symbol_id))
        if s is None:
            continue
        if len(s) > 1 and s[0] == "@":
            s = "{%s}" % s[1:]
        result += s
    return result.replace("}{", " ")


def _clean_text(text, cleaner_names):
    for name in cleaner_names:
        cleaner = getattr(_cleaners_mod, name, None)
        if cleaner is None:
            raise ValueError(f"Unknown cleaner: {name}")
        text = cleaner(text)
    return text


def _symbols_to_sequence(symbols):
    return [SYMBOL_TO_ID[s] for s in symbols if _should_keep_symbol(s)]


def _arpabet_to_sequence(text):
    return _symbols_to_sequence(["@" + s for s in text.split()])


def _should_keep_symbol(s):
    return s in SYMBOL_TO_ID and s not in ("_", "~")
