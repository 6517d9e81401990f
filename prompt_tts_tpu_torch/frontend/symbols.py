"""Symbol inventory for the text frontend.

Reproduces the reference symbol table exactly (148 symbols, ids 0..147) so
token ids are interchangeable with the reference pipeline:
reference tts/process_text/symbols.py:9-18 and
tts/process_text/cmudict.py:6-14.

Layout: [pad '_'] + ['-'] + 10 punctuation + 52 ASCII letters + 84 ARPAbet
symbols prefixed with '@'.  The intersperse separator used by the data layer
is ``len(symbols)`` == 148 (reference tts/dataloader.py:52-55), so any model
vocabulary must be at least 149.
"""

# The 39 ARPAbet phones, vowels carrying 0/1/2 stress variants (84 total).
ARPABET = [
    "AA", "AA0", "AA1", "AA2", "AE", "AE0", "AE1", "AE2", "AH", "AH0",
    "AH1", "AH2", "AO", "AO0", "AO1", "AO2", "AW", "AW0", "AW1", "AW2",
    "AY", "AY0", "AY1", "AY2", "B", "CH", "D", "DH", "EH", "EH0", "EH1",
    "EH2", "ER", "ER0", "ER1", "ER2", "EY", "EY0", "EY1", "EY2", "F", "G",
    "HH", "IH", "IH0", "IH1", "IH2", "IY", "IY0", "IY1", "IY2", "JH", "K",
    "L", "M", "N", "NG", "OW", "OW0", "OW1", "OW2", "OY", "OY0", "OY1",
    "OY2", "P", "R", "S", "SH", "T", "TH", "UH", "UH0", "UH1", "UH2", "UW",
    "UW0", "UW1", "UW2", "V", "W", "Y", "Z", "ZH",
]

ARPABET_SET = frozenset(ARPABET)

PAD = "_"
SPECIAL = "-"
PUNCTUATION = "!'(),.:;? "
LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"

# '@'-prefixed ARPAbet keeps phone symbols distinct from uppercase letters.
SYMBOLS = (
    [PAD] + list(SPECIAL) + list(PUNCTUATION) + list(LETTERS)
    + ["@" + s for s in ARPABET]
)

SYMBOL_TO_ID = {s: i for i, s in enumerate(SYMBOLS)}
ID_TO_SYMBOL = {i: s for i, s in enumerate(SYMBOLS)}

NUM_SYMBOLS = len(SYMBOLS)          # 148
SEPARATOR_ID = NUM_SYMBOLS          # 148: intersperse token (dataloader.py:52-55)
PAD_ID = SYMBOL_TO_ID[PAD]          # 0: also the batch padding id
MIN_VOCAB = SEPARATOR_ID + 1        # 149
