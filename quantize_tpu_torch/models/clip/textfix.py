"""Pure-stdlib equivalent of ``ftfy.fix_text`` for the CLIP tokenizer
(a copy of ``quantize_tpu/models/clip/textfix.py``).

The reference tokenizer cleans prompt text with ``ftfy.fix_text`` before
BPE encoding (``modelzoo/clip/simple_tokenizer.py:50-53``). ``ftfy`` is a
third-party package; this module re-implements the behaviors its default
pipeline applies, using only the standard library, so non-ASCII classnames
(mojibake, curly quotes, ligatures, fullwidth forms) tokenize the same way
they would under the reference:

1. **Surrogate repair** — lone/paired UTF-16 surrogates re-combined.
2. **Mojibake repair** (ftfy's ``fix_encoding``) — text that was UTF-8
   bytes misdecoded as Latin-1/Windows-1252 ("caffÃ¨" -> "caffè") is
   detected and re-decoded, iteratively, with a conservative acceptance
   rule (round-trip must succeed AND strictly shrink the text, which is
   always true of real UTF-8 mojibake since multibyte sequences collapse).
3. **Terminal escapes** removed (ANSI color codes).
4. **Control characters** removed (category Cc except ``\\t``/``\\n``).
5. **Latin ligatures** expanded (ﬁ -> fi) — ftfy's explicit table; note
   plain NFC does *not* decompose these.
6. **Character width** — fullwidth forms (ＡＢＣ) folded to ASCII via
   per-character NFKC over the Halfwidth-and-Fullwidth-Forms block only
   (blanket NFKC would also rewrite ² -> 2 etc., which ftfy does not do).
7. **Curly quotes** straightened (’ -> ', “ -> ").
8. **Line breaks** normalized (CRLF/CR/NEL/LS/PS -> ``\\n``).
9. **NFC normalization** (ftfy's default ``normalization='NFC'``).

HTML entity unescaping is NOT done here: the reference calls
``html.unescape`` twice *in addition to* ``ftfy.fix_text`` inside
``basic_clean``, and the tokenizer does the same on top of this function.
"""
from __future__ import annotations

import re
import unicodedata

__all__ = ["fix_text", "fix_encoding"]

# Windows-1252's printable extensions over Latin-1 in the 0x80-0x9F range.
# "Sloppy cp1252" (what ftfy decodes mojibake with) maps the five bytes
# cp1252 leaves undefined (0x81 0x8D 0x8F 0x90 0x9D) to the matching C1
# control characters instead of erroring, so every byte round-trips.
_CP1252_EXTRA = {
    0x80: "€", 0x82: "‚", 0x83: "ƒ", 0x84: "„",
    0x85: "…", 0x86: "†", 0x87: "‡", 0x88: "ˆ",
    0x89: "‰", 0x8a: "Š", 0x8b: "‹", 0x8c: "Œ",
    0x8e: "Ž", 0x91: "‘", 0x92: "’", 0x93: "“",
    0x94: "”", 0x95: "•", 0x96: "–", 0x97: "—",
    0x98: "˜", 0x99: "™", 0x9a: "š", 0x9b: "›",
    0x9c: "œ", 0x9e: "ž", 0x9f: "Ÿ",
}
# char -> byte for re-encoding a mis-decoded string back to its bytes.
_SLOPPY_ENCODE = {v: k for k, v in _CP1252_EXTRA.items()}

_LIGATURES = {
    "Ĳ": "IJ", "ĳ": "ij",           # Ĳ ĳ
    "ﬀ": "ff", "ﬁ": "fi", "ﬂ": "fl",
    # NB ftfy maps U+FB05 (LONG S T ligature) to "ſt" — long s preserved —
    # while NFKC would give "st"; match ftfy, it is the reference behavior
    "ﬃ": "ffi", "ﬄ": "ffl", "ﬅ": "ſt", "ﬆ": "st",
}
_LIGATURE_RE = re.compile("[" + "".join(_LIGATURES) + "]")

_QUOTES = {
    "‘": "'", "’": "'", "‚": "'", "‛": "'",
    "“": '"', "”": '"', "„": '"', "‟": '"',
}
_QUOTE_RE = re.compile("[" + "".join(_QUOTES) + "]")

_ANSI_RE = re.compile(r"\x1b\[[0-9;]*[A-Za-z]|\x1b[@-Z\\-_]")
_LINEBREAK_RE = re.compile("\r\n|[\r  ]")
_SURROGATE_RE = re.compile("[\ud800-\udfff]")
# A quick gate: mojibake of UTF-8 always leaves a lead char in C3 80-C3 BF
# position, i.e. one of Â Ã Ä Å Æ Ç È É Ê Ë Ì Í Î Ï (misdecoded lead bytes
# 0xC2-0xCF) or cp1252 lead artifacts (â ð ñ ò for 0xE2/0xF0...).
_MOJIBAKE_HINT_RE = re.compile("[Â-ßà-ôƒ…ˆ]")


def _encode_sloppy(text: str):
    """Re-encode a (mis)decoded string to the bytes it came from, or None."""
    out = bytearray()
    for ch in text:
        cp = ord(ch)
        if cp < 0x100:
            out.append(cp)  # latin-1 (covers the sloppy C1 positions too)
        else:
            b = _SLOPPY_ENCODE.get(ch)
            if b is None:
                return None
            out.append(b)
    return bytes(out)


def fix_encoding(text: str, max_passes: int = 3) -> str:
    """Undo UTF-8-misdecoded-as-Latin-1/cp1252 mojibake, iteratively.

    Acceptance rule per pass: the candidate bytes must decode as strict
    UTF-8, the decode must use at least one multibyte sequence (otherwise
    the text was plain Latin-1 and is left alone), and the result must be
    strictly shorter than the input (true of any real mojibake).
    """
    for _ in range(max_passes):
        if text.isascii() or not _MOJIBAKE_HINT_RE.search(text):
            return text
        raw = _encode_sloppy(text)
        if raw is None:
            return text
        try:
            fixed = raw.decode("utf-8")
        except UnicodeDecodeError:
            return text
        if len(fixed) >= len(text):
            return text
        text = fixed
    return text


def fix_text(text: str) -> str:
    """ftfy.fix_text-equivalent cleanup (defaults pipeline, stdlib only)."""
    if _SURROGATE_RE.search(text):
        try:
            text = text.encode("utf-16", "surrogatepass").decode("utf-16")
        except UnicodeDecodeError:
            text = _SURROGATE_RE.sub("�", text)
    text = fix_encoding(text)
    text = _ANSI_RE.sub("", text)
    text = _LINEBREAK_RE.sub("\n", text)
    text = "".join(
        ch for ch in text
        if ch in "\t\n" or unicodedata.category(ch) != "Cc"
    )
    text = _LIGATURE_RE.sub(lambda m: _LIGATURES[m.group()], text)
    text = "".join(
        unicodedata.normalize("NFKC", ch) if "！" <= ch <= "￯" else ch
        for ch in text
    )
    text = _QUOTE_RE.sub(lambda m: _QUOTES[m.group()], text)
    return unicodedata.normalize("NFC", text)
