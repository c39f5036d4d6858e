"""Byte-pair-encoding tokenizer compatible with OpenAI CLIP.

The port's own copy of ``protoclip_tpu/tokenizer/bpe.py``: it needs no
framework, and the port imports nothing of the JAX package.

Clean-room implementation of the CLIP text tokenizer.  Behavioral contract
(established by the reference at ``clip/simple_tokenizer.py:10-132`` and
``clip/clip.py:194-230``):

- 49,408-token vocabulary: 256 byte symbols, the same 256 with a ``</w>``
  end-of-word suffix, 48,894 learned merges, and the two specials
  ``<|startoftext|>`` / ``<|endoftext|>``.
- Text is unicode-fixed, HTML-unescaped, whitespace-collapsed and lowercased
  before BPE.
- The pre-tokenizer splits on contractions ('s 't 're 've 'm 'll 'd), letter
  runs, single digits, and runs of other non-space symbols.
- ``tokenize`` wraps ids with SOT/EOT and zero-pads to a fixed context length
  (77 for all CLIP models).

The merge table itself is model data (like the model weights) and is NOT
shipped with this package; point ``vocab_path`` / ``$PROTOCLIP_BPE_PATH`` at
OpenAI's ``bpe_simple_vocab_16e6.txt.gz``.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
from typing import Iterable, List, Sequence, Union

import numpy as np

try:  # ftfy fixes mojibake; optional — prompt templates are plain ASCII.
    import ftfy

    _fix_text = ftfy.fix_text
except ImportError:  # pragma: no cover - environment dependent
    def _fix_text(text: str) -> str:
        return text

try:
    import regex as _re

    # Contractions, letter runs, single digits, punctuation runs (unicode aware).
    _WORD_PATTERN = _re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
        r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        _re.IGNORECASE,
    )

    def _find_words(text: str) -> List[str]:
        return _re.findall(_WORD_PATTERN, text)

except ImportError:  # pragma: no cover - `regex` ships with transformers
    import unicodedata

    def _find_words(text: str) -> List[str]:
        # Pure-stdlib approximation: classify characters via unicodedata.
        words: List[str] = []
        i, n = 0, len(text)

        def cat(ch: str) -> str:
            c = unicodedata.category(ch)
            if c.startswith("L"):
                return "L"
            if c.startswith("N"):
                return "N"
            if ch.isspace():
                return "S"
            return "O"

        contractions = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")
        specials = ("<|startoftext|>", "<|endoftext|>")
        while i < n:
            ch = text[i]
            if ch.isspace():
                i += 1
                continue
            low = text[i:].lower()
            matched = None
            # the specials are alternatives in the regex branch (and the
            # reference pattern): without this, '<|endoftext|>' would split
            # into ordinary tokens here and tokenize differently depending
            # on whether the `regex` package is installed
            for special in specials:
                if low.startswith(special):
                    matched = text[i : i + len(special)]
                    break
            if matched is None:
                for con in contractions:
                    if low.startswith(con):
                        matched = text[i : i + len(con)]
                        break
            if matched is not None:
                words.append(matched)
                i += len(matched)
                continue
            k = cat(ch)
            if k == "N":
                words.append(ch)
                i += 1
                continue
            j = i + 1
            while j < n and cat(text[j]) == k:  # k != "N" here (handled above)
                j += 1
            words.append(text[i:j])
            i = j
        return words


SOT_TEXT = "<|startoftext|>"
EOT_TEXT = "<|endoftext|>"
CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408
# Ids of the two specials in the full 49,408-entry vocabulary: they close the
# vocabulary, so code that only needs them (e.g. EOT-padding a token batch)
# does not have to load the merge table.
SOT_ID = VOCAB_SIZE - 2
EOT_ID = VOCAB_SIZE - 1

_VOCAB_ENV = "PROTOCLIP_BPE_PATH"
_VOCAB_CANDIDATES = (
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "bpe_simple_vocab_16e6.txt.gz"),
    os.path.expanduser("~/.cache/clip/bpe_simple_vocab_16e6.txt.gz"),
)


def default_vocab_path() -> str:
    """Locate the BPE merge table; raises with guidance if absent."""
    env = os.environ.get(_VOCAB_ENV)
    if env:
        if not os.path.exists(env):
            raise FileNotFoundError(f"${_VOCAB_ENV}={env!r} does not exist")
        return env
    for cand in _VOCAB_CANDIDATES:
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(
        "CLIP BPE vocab 'bpe_simple_vocab_16e6.txt.gz' not found. Download it "
        "from the OpenAI CLIP release and set $PROTOCLIP_BPE_PATH or place it "
        "in ~/.cache/clip/."
    )


@functools.lru_cache()
def _byte_unicode_table() -> dict:
    """Invertible byte -> printable-unicode map (GPT-2 convention).

    Printable latin ranges map to themselves; the remaining bytes map to
    256 + k, guaranteeing no whitespace/control characters appear inside BPE
    symbols.
    """
    keep = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    # Insertion order matters: the vocab lists printable bytes first, then the
    # shifted escapes — token ids depend on this ordering.
    table = {b: chr(b) for b in keep}
    shift = 0
    for b in range(256):
        if b not in table:
            table[b] = chr(256 + shift)
            shift += 1
    return table


def _clean_text(text: str) -> str:
    text = _fix_text(text)
    text = html.unescape(html.unescape(text))
    text = " ".join(text.split())
    return text.strip()


class ClipTokenizer:
    """CLIP BPE encoder/decoder.

    Parameters
    ----------
    vocab_path: path to ``bpe_simple_vocab_16e6.txt.gz``.  Defaults to
        :func:`default_vocab_path` discovery.
    """

    def __init__(self, vocab_path: str | None = None):
        vocab_path = vocab_path or default_vocab_path()
        with gzip.open(vocab_path, "rt", encoding="utf-8") as fh:
            lines = fh.read().split("\n")
        # Line 0 is a version header; the usable merge list is truncated so
        # that the final vocab is exactly 49,408 entries
        # (256*2 byte symbols + merges + 2 specials).
        n_merges = VOCAB_SIZE - 256 * 2 - 2
        merges = [tuple(line.split()) for line in lines[1 : 1 + n_merges]]

        self._byte_to_uni = _byte_unicode_table()
        self._uni_to_byte = {u: b for b, u in self._byte_to_uni.items()}

        symbols = list(self._byte_to_uni.values())
        vocab = symbols + [s + "</w>" for s in symbols]
        vocab.extend("".join(m) for m in merges)
        vocab.extend([SOT_TEXT, EOT_TEXT])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self._merge_rank = {pair: i for i, pair in enumerate(merges)}
        self._bpe_cache = {SOT_TEXT: SOT_TEXT, EOT_TEXT: EOT_TEXT}

    # -- properties ---------------------------------------------------------
    @property
    def sot_id(self) -> int:
        return self.encoder[SOT_TEXT]

    @property
    def eot_id(self) -> int:
        return self.encoder[EOT_TEXT]

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    # -- BPE ---------------------------------------------------------------
    def _bpe(self, token: str) -> str:
        """Apply merges to one pre-token; returns space-joined BPE symbols."""
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        if not token:
            return token
        parts: List[str] = list(token[:-1]) + [token[-1] + "</w>"]

        while len(parts) > 1:
            # Find the lowest-ranked adjacent pair.
            best_rank = None
            best_idx = -1
            for i in range(len(parts) - 1):
                rank = self._merge_rank.get((parts[i], parts[i + 1]))
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank, best_idx = rank, i
            if best_rank is None:
                break
            first, second = parts[best_idx], parts[best_idx + 1]
            # Merge every occurrence of (first, second), as BPE does.
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if i < len(parts) - 1 and parts[i] == first and parts[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged

        out = " ".join(parts)
        self._bpe_cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        """Text -> list of BPE token ids (no SOT/EOT)."""
        text = _clean_text(text).lower()
        ids: List[int] = []
        for word in _find_words(text):
            sym = "".join(self._byte_to_uni[b] for b in word.encode("utf-8"))
            ids.extend(self.encoder[s] for s in self._bpe(sym).split(" "))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        text = "".join(self.decoder[i] for i in ids)
        raw = bytearray(self._uni_to_byte[ch] for ch in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


@functools.lru_cache()
def _default_tokenizer() -> ClipTokenizer:
    return ClipTokenizer()


def tokenize(
    texts: Union[str, Sequence[str]],
    context_length: int = CONTEXT_LENGTH,
    truncate: bool = False,
    tokenizer: ClipTokenizer | None = None,
) -> np.ndarray:
    """Tokenize text(s) into a zero-padded ``(B, context_length)`` int32 array.

    Matches the reference front-end ``clip/clip.py:194-230``: SOT + ids + EOT,
    error (or truncate-with-EOT) on overflow, zero padding on the right.
    """
    if isinstance(texts, str):
        texts = [texts]
    tok = tokenizer or _default_tokenizer()

    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [tok.sot_id] + tok.encode(text) + [tok.eot_id]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(
                    f"Input {text!r} is too long for context length {context_length}"
                )
            ids = ids[:context_length]
            ids[-1] = tok.eot_id
        result[i, : len(ids)] = ids
    return result
