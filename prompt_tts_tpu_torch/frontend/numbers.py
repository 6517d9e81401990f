"""Number verbalization for English text normalization.

Reproduces the behavior of the reference's Tacotron-derived number expander
(reference tts/process_text/numbers.py:1-71), which delegates word rendering
to the ``inflect`` package.  inflect is not available in this framework, so
the required subset is implemented here:

* cardinal rendering with per-group "and" (inflect's ``andword``), hyphenated
  tens ("twenty-three"), and comma-separated scale groups
  ("one million, two hundred thirty-four thousand, ...").
* ordinal rendering ("53rd" -> "fifty-third") used by the reference's
  ``_expand_ordinal`` (reference numbers.py:45-46).
* two-digit grouping with an "oh" zero used for year-like numbers
  (reference numbers.py:49-61: 1873 -> "eighteen seventy-three",
  1906 -> "nineteen oh six").

The public surface mirrors the reference: ``normalize_numbers(text)``.
"""

import re

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [
    "", "thousand", "million", "billion", "trillion", "quadrillion",
    "quintillion", "sextillion", "septillion", "octillion", "nonillion",
    "decillion",
]

_ORDINAL_IRREGULAR = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def _two_digits(n: int) -> str:
    """Words for 1..99 (hyphenating 21..99 non-multiples of ten)."""
    if n < 20:
        return _ONES[n]
    tens, ones = divmod(n, 10)
    if ones == 0:
        return _TENS[tens]
    return f"{_TENS[tens]}-{_ONES[ones]}"


def _three_digits(n: int, andword: str) -> str:
    """Words for 1..999 with inflect-style within-group ``andword``."""
    hundreds, rem = divmod(n, 100)
    if hundreds == 0:
        return _two_digits(rem)
    words = f"{_ONES[hundreds]} hundred"
    if rem:
        joiner = f" {andword} " if andword else " "
        words += joiner + _two_digits(rem)
    return words


def _group2(digits: str, zero: str) -> str:
    """inflect's ``group=2`` mode: render 2-digit chunks left to right.

    Used by the reference only for 4-digit year-like numbers
    (reference numbers.py:49-61), where chunks are joined with ", " and the
    caller then replaces ", " with " ".
    """
    chunks = []
    i = len(digits) % 2
    if i:
        chunks.append(digits[:1])
    while i < len(digits):
        chunks.append(digits[i:i + 2])
        i += 2
    words = []
    for chunk in chunks:
        n = int(chunk)
        if len(chunk) == 2 and chunk[0] == "0":
            # "06" -> "oh six"; "00" -> "oh oh"
            words.append(f"{zero} {zero}" if n == 0 else f"{zero} {_ONES[n]}")
        elif n == 0:
            words.append(zero)
        else:
            words.append(_two_digits(n) if n < 100 else _three_digits(n, ""))
    return ", ".join(words)


def number_to_words(num, andword: str = "and", zero: str = "zero",
                    group: int = 0) -> str:
    """Render an integer (or digit string, optionally with ordinal suffix).

    Mirrors the inflect calls made by the reference expander. Strings with an
    ordinal suffix ("53rd") are rendered as ordinals, matching
    ``inflect.number_to_words("53rd")`` (reference numbers.py:45-46).
    """
    if isinstance(num, str):
        m = re.fullmatch(r"([0-9]+)(st|nd|rd|th)?", num.strip())
        if not m:
            raise ValueError(f"not a number: {num!r}")
        if m.group(2):
            return _ordinalize(number_to_words(int(m.group(1)), andword=andword))
        num = int(m.group(1))

    if group == 2:
        return _group2(str(num), zero)
    if num == 0:
        return zero
    if num < 0:
        return "minus " + number_to_words(-num, andword=andword, zero=zero)

    # Split into 3-digit scale groups, most significant first.
    groups = []
    digits = str(num)
    i = len(digits) % 3
    if i:
        groups.append(int(digits[:i]))
    while i < len(digits):
        groups.append(int(digits[i:i + 3]))
        i += 3

    nscales = len(groups)
    if nscales > len(_SCALES):
        # Beyond supported scales: read digit-by-digit (rare in corpora).
        return " ".join(_ONES[int(d)] for d in digits)

    parts = []
    for gi, g in enumerate(groups):
        if g == 0:
            continue
        scale = _SCALES[nscales - 1 - gi]
        words = _three_digits(g, andword)
        parts.append(f"{words} {scale}".strip())
    return ", ".join(parts)


def _ordinalize(words: str) -> str:
    """Cardinal words -> ordinal words ("twenty-three" -> "twenty-third")."""
    head, sep, last = words.rpartition("-")
    if not sep:
        head, sep, last = words.rpartition(" ")
    if last in _ORDINAL_IRREGULAR:
        last = _ORDINAL_IRREGULAR[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    else:
        last = last + "th"
    return head + sep + last


# --- the reference's regex pipeline (reference numbers.py:7-71) -------------

_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")


def _remove_commas(m):
    return m.group(1).replace(",", "")


def _expand_decimal_point(m):
    return m.group(1).replace(".", " point ")


def _expand_dollars(m):
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"  # unexpected format
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        cent_unit = "cent" if cents == 1 else "cents"
        return f"{dollars} {dollar_unit}, {cents} {cent_unit}"
    if dollars:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        return f"{dollars} {dollar_unit}"
    if cents:
        cent_unit = "cent" if cents == 1 else "cents"
        return f"{cents} {cent_unit}"
    return "zero dollars"


def _expand_ordinal(m):
    return number_to_words(m.group(0))


def _expand_number(m):
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + number_to_words(num % 100)
        if num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        return number_to_words(
            num, andword="", zero="oh", group=2).replace(", ", " ")
    return number_to_words(num, andword="")


def normalize_numbers(text: str) -> str:
    """Expand digits, currency, decimals, and ordinals into words."""
    text = re.sub(_comma_number_re, _remove_commas, text)
    text = re.sub(_pounds_re, r"\1 pounds", text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(_decimal_number_re, _expand_decimal_point, text)
    text = re.sub(_ordinal_re, _expand_ordinal, text)
    text = re.sub(_number_re, _expand_number, text)
    return text
