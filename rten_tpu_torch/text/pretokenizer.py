"""Pre-tokenizers: split normalized text into word-level pieces with char
offsets (reference: rten-text splits inside tokenizers.rs encode; HF
tokenizer.json pre_tokenizer spec). ByteLevel additionally maps pieces
through the GPT-2 byte↔unicode table.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Any

from rten_tpu_torch.text.models import bytes_to_unicode

# GPT-2's regex (translated to Python re: no \p support → unicode classes
# approximated with str methods where needed).
_GPT2_PATTERN = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\s\W\d_]+| ?\d+| ?[^\s\w]+|\s+(?!\S)|\s+",
    re.UNICODE,
)


class PreTokenizer:
    def split(self, text: str) -> list[tuple[str, int]]:
        """text → [(piece, char_offset), ...]; piece is already in the
        model's input alphabet (byte-level units for ByteLevel)."""
        raise NotImplementedError

    @staticmethod
    def from_json(spec: dict[str, Any] | None) -> "PreTokenizer | None":
        if spec is None:
            return None
        kind = spec.get("type")
        if kind == "Sequence":
            return SequencePreTokenizer(
                [PreTokenizer.from_json(s) for s in spec.get("pretokenizers", [])]
            )
        if kind == "ByteLevel":
            return ByteLevel(add_prefix_space=spec.get("add_prefix_space", True))
        if kind == "BertPreTokenizer":
            return BertPreTokenizer()
        if kind == "Whitespace":
            return Whitespace()
        if kind == "WhitespaceSplit":
            return WhitespaceSplit()
        if kind == "Split":
            pattern = spec.get("pattern", {})
            regex = pattern.get("Regex") or re.escape(pattern.get("String", " "))
            return SplitPattern(regex, invert=spec.get("invert", False))
        if kind == "Metaspace":
            return Metaspace(
                replacement=spec.get("replacement", "▁"),
                prepend=spec.get("prepend_scheme", "always") != "never"
                if "prepend_scheme" in spec
                else spec.get("add_prefix_space", True),
            )
        if kind == "Digits":
            return Digits(spec.get("individual_digits", False))
        raise ValueError(f"unsupported pre-tokenizer type {kind!r}")


class SequencePreTokenizer(PreTokenizer):
    def __init__(self, pres):
        self.pres = [p for p in pres if p is not None]

    def split(self, text):
        pieces = [(text, 0)]
        for p in self.pres:
            next_pieces = []
            for piece, off in pieces:
                for sub, sub_off in p.split(piece):
                    next_pieces.append((sub, off + sub_off))
            pieces = next_pieces
        return pieces


class Whitespace(PreTokenizer):
    _PAT = re.compile(r"\w+|[^\w\s]+")

    def split(self, text):
        return [(m.group(), m.start()) for m in self._PAT.finditer(text)]


class WhitespaceSplit(PreTokenizer):
    _PAT = re.compile(r"\S+")

    def split(self, text):
        return [(m.group(), m.start()) for m in self._PAT.finditer(text)]


class BertPreTokenizer(PreTokenizer):
    """Whitespace split + punctuation isolation (reference: the reference's
    WordPiece path splits the same way)."""

    def split(self, text):
        out = []
        word_start = None
        for i, c in enumerate(text):
            if c.isspace():
                if word_start is not None:
                    out.append((text[word_start:i], word_start))
                    word_start = None
            elif _is_punct(c):
                if word_start is not None:
                    out.append((text[word_start:i], word_start))
                    word_start = None
                out.append((c, i))
            else:
                if word_start is None:
                    word_start = i
        if word_start is not None:
            out.append((text[word_start:], word_start))
        return out


class ByteLevel(PreTokenizer):
    """GPT-2 style: regex word split, then map UTF-8 bytes to printable
    unicode units (reference: bpe.rs byte-level alphabet)."""

    def __init__(self, add_prefix_space: bool = True):
        self.add_prefix_space = add_prefix_space
        self.byte_map = bytes_to_unicode()

    def split(self, text):
        if self.add_prefix_space and text and not text[0].isspace():
            text = " " + text
            shift = -1
        else:
            shift = 0
        out = []
        for m in _GPT2_PATTERN.finditer(text):
            mapped = "".join(self.byte_map[b] for b in m.group().encode("utf-8"))
            out.append((mapped, max(0, m.start() + shift)))
        return out


class SplitPattern(PreTokenizer):
    def __init__(self, regex: str, invert: bool = False):
        self.pat = re.compile(regex)
        self.invert = invert

    def split(self, text):
        if self.invert:
            return [(m.group(), m.start()) for m in self.pat.finditer(text)]
        out = []
        pos = 0
        for m in self.pat.finditer(text):
            if m.start() > pos:
                out.append((text[pos : m.start()], pos))
            pos = m.end()
        if pos < len(text):
            out.append((text[pos:], pos))
        return out


class Metaspace(PreTokenizer):
    """SentencePiece-style: spaces become ▁ (Llama tokenizers)."""

    def __init__(self, replacement: str = "▁", prepend: bool = True):
        self.replacement = replacement
        self.prepend = prepend

    def split(self, text):
        if self.prepend and text and not text.startswith(" "):
            text = " " + text
        pieces = []
        for m in re.finditer(r"\S+", text):
            start = m.start()
            piece = m.group()
            if start > 0 or self.prepend:
                piece = self.replacement + piece
            pieces.append((piece, max(0, m.start() - 1)))
        return pieces


class Digits(PreTokenizer):
    def __init__(self, individual: bool = False):
        self.individual = individual

    def split(self, text):
        pat = re.compile(r"\d|\D+" if self.individual else r"\d+|\D+")
        return [(m.group(), m.start()) for m in pat.finditer(text)]


def _is_punct(c: str) -> bool:
    cp = ord(c)
    if (
        33 <= cp <= 47
        or 58 <= cp <= 64
        or 91 <= cp <= 96
        or 123 <= cp <= 126
    ):
        return True
    return unicodedata.category(c).startswith("P")
