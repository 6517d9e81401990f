"""CMU pronouncing dictionary loader.

Parses the CMUdict-0.7b text format the same way the reference does
(reference tts/process_text/cmudict.py:19-64): keep lines whose first
character is A-Z or an apostrophe, split the word from the pronunciation on
a double space, strip "(N)" alternate markers, and drop pronunciations
containing any symbol outside the 84-symbol ARPAbet set.

The dictionary data ships gzipped at ``frontend/data/cmu_dictionary.gz``
(public-domain CMUdict 0.07, the same corpus the reference vendors as
tts/process_text/cmu_dictionary).
"""

import gzip
import os
import re

from prompt_tts_tpu_torch.frontend.symbols import ARPABET_SET

_ALT_RE = re.compile(r"\([0-9]+\)")

_DEFAULT_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "data", "cmu_dictionary.gz"
)


class CMUDict:
    """Word -> list of ARPAbet pronunciation strings."""

    def __init__(self, file_or_path=None, keep_ambiguous: bool = True):
        if file_or_path is None:
            file_or_path = _DEFAULT_PATH
        if isinstance(file_or_path, str):
            opener = gzip.open if file_or_path.endswith(".gz") else open
            with opener(file_or_path, "rt", encoding="latin-1") as f:
                entries = _parse_cmudict(f)
        else:
            entries = _parse_cmudict(file_or_path)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self._entries = entries

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, word: str):
        """All ARPAbet pronunciations of ``word`` (uppercased), or None."""
        return self._entries.get(word.upper())


def _parse_cmudict(file) -> dict:
    entries = {}
    for line in file:
        if len(line) and ("A" <= line[0] <= "Z" or line[0] == "'"):
            parts = line.split("  ")
            word = _ALT_RE.sub("", parts[0])
            pronunciation = _get_pronunciation(parts[1])
            if pronunciation:
                entries.setdefault(word, []).append(pronunciation)
    return entries


def _get_pronunciation(s: str):
    parts = s.strip().split(" ")
    for part in parts:
        if part not in ARPABET_SET:
            return None
    return " ".join(parts)


_default_dict = None


def default_cmudict() -> CMUDict:
    """The bundled CMUdict, loaded once per process."""
    global _default_dict
    if _default_dict is None:
        _default_dict = CMUDict(_DEFAULT_PATH)
    return _default_dict
