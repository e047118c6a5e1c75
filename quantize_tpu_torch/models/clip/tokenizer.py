"""CLIP byte-pair-encoding tokenizer (a copy of
``quantize_tpu/models/clip/tokenizer.py``; numpy only).

Re-implementation of the reference's vendored tokenizer
(``modelzoo/clip/simple_tokenizer.py``): GPT-2-style byte-to-unicode BPE
with ``</w>`` word-end markers, SOT/EOT specials, and a 77-token context.
The merges vocabulary (``bpe_simple_vocab_16e6.txt.gz``) must be provided by
the user (``CLIP_BPE_PATH`` env var or explicit path) — this environment has
no network egress and vendored data is not copied from the reference. A
deterministic hash tokenizer stands in for tests when no vocab is present.

``ftfy`` (a third-party package) is replaced by :mod:`.textfix`, a
stdlib-only equivalent of ``ftfy.fix_text``'s default pipeline (mojibake
repair, ligatures, fullwidth folding, curly quotes, NFC), so non-ASCII
classnames clean — and therefore tokenize — the same way they would under
the reference's ``basic_clean`` (``simple_tokenizer.py:50-53``).
"""
from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .textfix import fix_text

CONTEXT_LENGTH = 77


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 byte -> printable unicode mapping (reversible, no control chars)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def basic_clean(text: str) -> str:
    text = fix_text(text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def get_pairs(word: Tuple[str, ...]) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


_WORD_RE = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|[^\s\w]+",
    re.IGNORECASE | re.UNICODE,
)


class BPETokenizer:
    """CLIP BPE over a user-provided merges file."""

    def __init__(self, bpe_path: Optional[str] = None):
        bpe_path = bpe_path or os.environ.get("CLIP_BPE_PATH")
        if not bpe_path or not os.path.exists(bpe_path):
            raise FileNotFoundError(
                "CLIP BPE vocab not found; set CLIP_BPE_PATH or pass bpe_path "
                "(bpe_simple_vocab_16e6.txt.gz)"
            )
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1:49152 - 256 - 2 + 1] if m]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.decoder = {i: v for v, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache: Dict[str, str] = {
            "<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>",
        }

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @property
    def sot_token(self) -> int:
        return self.encoder["<|startoftext|>"]

    @property
    def eot_token(self) -> int:
        return self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for tok in _WORD_RE.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self.bpe(tok).split(" "))
        return tokens

    def decode(self, tokens: Sequence[int]) -> str:
        text = "".join(self.decoder[t] for t in tokens)
        return bytearray(self.byte_decoder[c] for c in text).decode(
            "utf-8", errors="replace"
        ).replace("</w>", " ")


class HashTokenizer:
    """Deterministic stand-in tokenizer for tests (no vocab file needed)."""

    def __init__(self, vocab_size: int = 1024):
        self._vocab_size = vocab_size

    @property
    def vocab_size(self) -> int:
        return self._vocab_size

    @property
    def sot_token(self) -> int:
        return self._vocab_size - 2

    @property
    def eot_token(self) -> int:
        return self._vocab_size - 1

    def encode(self, text: str) -> List[int]:
        words = whitespace_clean(basic_clean(text)).lower().split(" ")
        # stable non-cryptographic hash (python hash() is salted per process)
        def h(w: str) -> int:
            v = 2166136261
            for c in w.encode("utf-8"):
                v = ((v ^ c) * 16777619) & 0xFFFFFFFF
            return v % (self._vocab_size - 2)

        return [h(w) for w in words if w]


def tokenize(
    texts: Sequence[str] | str,
    tokenizer=None,
    context_length: int = CONTEXT_LENGTH,
) -> np.ndarray:
    """Tokenize to (N, context_length) int32 with SOT/EOT + zero padding
    (reference ``clip/clip.py:205-245``; over-long inputs are truncated with
    EOT preserved)."""
    if isinstance(texts, str):
        texts = [texts]
    tokenizer = tokenizer or get_default_tokenizer()
    sot, eot = tokenizer.sot_token, tokenizer.eot_token
    out = np.zeros((len(texts), context_length), np.int32)
    for i, text in enumerate(texts):
        toks = [sot] + tokenizer.encode(text) + [eot]
        if len(toks) > context_length:
            toks = toks[:context_length]
            toks[-1] = eot
        out[i, : len(toks)] = toks
    return out


_default_tokenizer = None


def get_default_tokenizer():
    """BPE if a vocab is available, else the test hash tokenizer."""
    global _default_tokenizer
    if _default_tokenizer is None:
        try:
            _default_tokenizer = BPETokenizer()
        except FileNotFoundError:
            _default_tokenizer = HashTokenizer()
    return _default_tokenizer
