"""CLIP BPE tokenizer — pure-Python, host-side (the PyTorch port's own copy).

TPU-native rebuild of the reference CLIP tokenizer
(reference: segmentation/denseclip/utils.py:186-314).  Tokenization runs
exactly once at model-build time (class names are tokenized into a static
buffer), so this stays host code; the resulting int32 array is a constant
handed to the model once.

Behavioural contract with the reference:
  * byte-level BPE over the `bpe_simple_vocab_16e6.txt.gz` merge table
    (utils.py:224-236), greedy lowest-rank merge loop (utils.py:238-277),
  * text cleaning = ftfy.fix_text + double html.unescape + whitespace
    collapse + lowercase (utils.py:203-210).  ftfy is optional here — for
    the ASCII class-name vocabulary it is the identity, and the module
    degrades gracefully when it is absent.
  * `tokenize()` emits [SOT] + bpe(text) + [EOT] zero-padded to
    `context_length`, raising if too long unless truncate (utils.py:295-314).

Returns numpy int32 arrays, exactly as the JAX package's copy does; the
models turn them into tensors on their own device.

Provenance: the merge loop implements the canonical OpenAI CLIP BPE
algorithm (github.com/openai/CLIP simple_tokenizer), which must be
reproduced bit-exactly — any deviation changes token ids and breaks
compatibility with pretrained CLIP text towers (golden tests pin this).
"""

from __future__ import annotations

import gzip
import html
from functools import lru_cache
from pathlib import Path
from typing import Iterable, List, Sequence, Union

import numpy as np

try:  # ftfy is optional; identity for ASCII input.
    import ftfy

    _HAS_FTFY = True
except ImportError:  # pragma: no cover - env dependent
    _HAS_FTFY = False

try:
    import regex as re  # supports \p{L} classes like the reference
except ImportError:  # pragma: no cover - env dependent
    import re  # type: ignore


@lru_cache()
def default_bpe() -> str:
    return str(Path(__file__).parent / "bpe_simple_vocab_16e6.txt.gz")


@lru_cache()
def bytes_to_unicode() -> dict:
    """Reversible byte -> printable-unicode map (GPT-2/CLIP standard)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _pairs_of(word: Sequence[str]) -> set:
    return set(zip(word[:-1], word[1:]))


def _basic_clean(text: str) -> str:
    if _HAS_FTFY:
        text = ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class ClipTokenizer:
    """Byte-pair-encoding tokenizer with CLIP's 49,408-entry vocabulary."""

    SOT = "<|startoftext|>"
    EOT = "<|endoftext|>"

    def __init__(self, bpe_path: str | None = None):
        bpe_path = bpe_path or default_bpe()
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        merges = gzip.open(bpe_path).read().decode("utf-8").split("\n")
        # First line is a version header; vocabulary keeps 48,894 merges so the
        # total size lands on 49,408 = 256 bytes + 256 byte</w> + merges + 2 specials.
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merge_pairs = [tuple(m.split()) for m in merges]

        vocab: List[str] = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(p) for p in merge_pairs]
        vocab += [self.SOT, self.EOT]

        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {pair: i for i, pair in enumerate(merge_pairs)}
        self._cache = {self.SOT: self.SOT, self.EOT: self.EOT}
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
            re.IGNORECASE,
        )

    @property
    def sot_token(self) -> int:
        return self.encoder[self.SOT]

    @property
    def eot_token(self) -> int:
        return self.encoder[self.EOT]

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def bpe(self, token: str) -> str:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _pairs_of(word)
        if not pairs:
            return token + "</w>"

        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            merged: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    merged.extend(word[i:])
                    break
                merged.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
            if len(word) == 1:
                break
            pairs = _pairs_of(word)

        result = " ".join(word)
        self._cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        tokens: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for chunk in re.findall(self.pat, text):
            chunk = "".join(self.byte_encoder[b] for b in chunk.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self.bpe(chunk).split(" "))
        return tokens

    def decode(self, tokens: Iterable[int]) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )


@lru_cache()
def get_tokenizer() -> ClipTokenizer:
    return ClipTokenizer()


def tokenize(
    texts: Union[str, Sequence[str]],
    context_length: int = 77,
    truncate: bool = False,
) -> np.ndarray:
    """Tokenize one or more strings to an int32 array [N, context_length].

    Mirrors the reference `tokenize` contract (utils.py:295-314): SOT + BPE +
    EOT, zero padded; raises when a sequence exceeds `context_length` unless
    `truncate` (then the final token is forced to EOT).
    """
    if isinstance(texts, str):
        texts = [texts]

    tok = get_tokenizer()
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [tok.sot_token] + tok.encode(text) + [tok.eot_token]
        if len(ids) > context_length:
            if truncate:
                ids = ids[:context_length]
                ids[-1] = tok.eot_token
            else:
                raise RuntimeError(
                    f"Input {text!r} is too long for context length {context_length}"
                )
        out[i, : len(ids)] = ids
    return out
