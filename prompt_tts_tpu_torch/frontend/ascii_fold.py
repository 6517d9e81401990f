"""ASCII transliteration without external dependencies.

The reference pipeline runs ``unidecode`` as the first cleaner stage
(reference tts/process_text/cleaners.py:63-64, 82-85).  unidecode is not a
declared dependency of this framework, so we implement the subset of its
behavior that matters for English TTS corpora: Unicode NFKD decomposition
with combining-mark stripping, plus an explicit table for characters that do
not decompose (ligatures, quotes/dashes, currency).

The table entries mirror unidecode's outputs (e.g. ``£`` → ``PS``) so that
downstream number expansion sees the same text the reference saw.
"""

import unicodedata

# Characters NFKD cannot fold, mapped to unidecode-compatible replacements.
_FOLD_TABLE = {
    # ligatures / special latin letters
    "Æ": "AE", "æ": "ae",       # Æ æ
    "Œ": "OE", "œ": "oe",       # Œ œ
    "ß": "ss",                        # ß
    "Ð": "D", "ð": "d",         # Ð ð
    "Þ": "Th", "þ": "th",       # Þ þ
    "Ø": "O", "ø": "o",         # Ø ø
    "Ł": "L", "ł": "l",         # Ł ł
    "Đ": "D", "đ": "d",         # Đ đ
    # quotes and dashes
    "‘": "'", "’": "'", "‚": "'", "‛": "'",
    "“": '"', "”": '"', "„": '"', "‟": '"',
    "‹": "<", "›": ">",
    "«": '"', "»": '"',
    "–": "-", "—": "--", "―": "--", "−": "-",
    "…": "...",
    " ": " ", " ": " ", " ": " ", " ": " ",
    " ": " ", " ": " ", " ": " ", " ": " ",
    " ": " ", " ": " ", " ": " ", " ": " ",
    # currency / signs (values match unidecode)
    "£": "PS",                        # £  (so `£123` never hits _pounds_re,
    #                                        matching reference behavior where
    #                                        unidecode runs before numbers.py)
    "¢": "C/", "¥": "Y=", "€": "EU",
    "©": "(c)", "®": "(r)", "°": "deg",
    "·": "*", "•": "*",
    "¼": " 1/4", "½": " 1/2", "¾": " 3/4",
    "×": "x", "÷": "/",
    "¡": "!", "¿": "?",
}


def ascii_fold(text: str) -> str:
    """Transliterate ``text`` to pure ASCII."""
    out = []
    for ch in text:
        if ord(ch) < 128:
            out.append(ch)
            continue
        mapped = _FOLD_TABLE.get(ch)
        if mapped is not None:
            out.append(mapped)
            continue
        # Decompose and keep the ASCII skeleton (é → e, ü → u, ñ → n, ...).
        decomp = unicodedata.normalize("NFKD", ch)
        kept = "".join(c for c in decomp if ord(c) < 128
                       and not unicodedata.combining(c))
        out.append(kept)
    return "".join(out)
