"""Text cleaners — normalization passes run before phonemization.

Behavioral re-implementation of the reference's Tacotron-derived cleaner
stack (reference tts/process_text/cleaners.py:23-89), with the unidecode
dependency replaced by :mod:`prompt_tts_tpu_torch.frontend.ascii_fold`.

The only cleaner used on the training path is ``english_cleaners``
(reference tts/dataloader.py:52-55): ascii-fold -> lowercase -> number
expansion -> abbreviation expansion -> whitespace collapse.
"""

import re

from prompt_tts_tpu_torch.frontend.ascii_fold import ascii_fold
from prompt_tts_tpu_torch.frontend.numbers import normalize_numbers

_whitespace_re = re.compile(r"\s+")

# (pattern, replacement) pairs; patterns match the abbreviation followed by a
# period, case-insensitively, on a word boundary (reference cleaners.py:23-42).
_abbreviations = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), expansion)
    for abbr, expansion in [
        ("mrs", "misess"),
        ("mr", "mister"),
        ("dr", "doctor"),
        ("st", "saint"),
        ("co", "company"),
        ("jr", "junior"),
        ("maj", "major"),
        ("gen", "general"),
        ("drs", "doctors"),
        ("rev", "reverend"),
        ("lt", "lieutenant"),
        ("hon", "honorable"),
        ("sgt", "sergeant"),
        ("capt", "captain"),
        ("esq", "esquire"),
        ("ltd", "limited"),
        ("col", "colonel"),
        ("ft", "fort"),
    ]
]


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _abbreviations:
        text = re.sub(regex, replacement, text)
    return text


def expand_numbers(text: str) -> str:
    return normalize_numbers(text)


def lowercase(text: str) -> str:
    return text.lower()


def collapse_whitespace(text: str) -> str:
    return re.sub(_whitespace_re, " ", text)


def convert_to_ascii(text: str) -> str:
    return ascii_fold(text)


def basic_cleaners(text: str) -> str:
    """Lowercase + whitespace collapse, no transliteration."""
    text = lowercase(text)
    text = collapse_whitespace(text)
    return text


def transliteration_cleaners(text: str) -> str:
    """ASCII transliteration for non-English text."""
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = collapse_whitespace(text)
    return text


def english_cleaners(text: str) -> str:
    """Full English pipeline: ascii, lowercase, numbers, abbreviations."""
    text = convert_to_ascii(text)
    text = lowercase(text)
    text = expand_numbers(text)
    text = expand_abbreviations(text)
    text = collapse_whitespace(text)
    return text
