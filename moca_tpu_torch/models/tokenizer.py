"""CLIP byte-level BPE tokenizer (host-side, pure Python).

A copy of moca_tpu/models/tokenizer.py (the port imports nothing from the
JAX package); both produce identical token ids.

The reference calls `open_clip.tokenize` (condition.py:205-207). open_clip is
not a dependency here; this is an independent implementation of the standard
CLIP BPE scheme. It needs the public merge table `bpe_simple_vocab_16e6.txt.gz`
(ship it next to the model checkpoint, or point MOCA_TPU_BPE_PATH at it).

For environments without the vocab file (CI), `HashTokenizer` provides a
deterministic stand-in producing valid token ids — NOT semantically
meaningful; only for shape/pipeline tests.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
from typing import List, Sequence

import numpy as np

try:
    import regex as re
except ImportError:  # pragma: no cover
    import re  # type: ignore

_PAT = (
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
    r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"
)

CONTEXT_LENGTH = 77


@functools.lru_cache()
def bytes_to_unicode():
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def _whitespace_clean(text: str) -> str:
    text = re.sub(r"\s+", " ", text)
    return text.strip()


class SimpleTokenizer:
    """CLIP BPE; vocab size 49408 (49152 merges + 256 bytes·2 + 2 specials)."""

    def __init__(self, bpe_path: str | None = None):
        bpe_path = bpe_path or os.environ.get("MOCA_TPU_BPE_PATH")
        if not bpe_path or not os.path.exists(bpe_path):
            raise FileNotFoundError(
                "CLIP BPE merge table not found. Download the public "
                "bpe_simple_vocab_16e6.txt.gz and set MOCA_TPU_BPE_PATH."
            )
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1 : 49152 - 256 - 2 + 1]]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        self.pat = re.compile(_PAT, re.IGNORECASE)
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = _whitespace_clean(html.unescape(html.unescape(text))).lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(
                self.encoder[t] for t in self.bpe(token).split(" ")
            )
        return bpe_tokens

    def __call__(self, texts: Sequence[str] | str,
                 context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        """Tokenize to [B, 77] int32 with SOT/EOT, zero padding, truncation
        (same framing as open_clip.tokenize)."""
        if isinstance(texts, str):
            texts = [texts]
        result = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            toks = [self.sot] + self.encode(text) + [self.eot]
            if len(toks) > context_length:
                toks = toks[:context_length]
                toks[-1] = self.eot
            result[i, : len(toks)] = toks
        return result


class HashTokenizer:
    """Deterministic stand-in for tests: maps words to pseudo-ids.

    Produces valid [B, 77] int32 with SOT=49406/EOT=49407 framing. The ids
    are NOT CLIP's — use only where semantics don't matter.
    """

    sot = 49406
    eot = 49407

    def __init__(self, vocab_size: int = 49408):
        self.vocab_size = vocab_size

    def __call__(self, texts, context_length: int = CONTEXT_LENGTH) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        import hashlib

        result = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            words = _whitespace_clean(text).lower().split(" ") if text.strip() else []
            # stable across processes (python's hash() is seed-randomized)
            ids = [
                int.from_bytes(hashlib.md5(w.encode()).digest()[:4], "little")
                % (self.vocab_size - 2)
                for w in words
            ]
            toks = [self.sot] + ids + [self.eot]
            toks = toks[:context_length]
            result[i, : len(toks)] = toks
        return result


def load_tokenizer(bpe_path: str | None = None, allow_fallback: bool = False):
    try:
        return SimpleTokenizer(bpe_path)
    except FileNotFoundError:
        if allow_fallback:
            return HashTokenizer()
        raise
