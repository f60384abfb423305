"""Text normalizers (reference: rten-text/src/normalizer.rs:71 — lowercase,
NFD, accent-strip), extended with the HF tokenizer.json normalizer zoo needed
to load real model tokenizers (BertNormalizer, Sequence, Replace, Prepend).
"""

from __future__ import annotations

import unicodedata
from typing import Any


class Normalizer:
    def normalize(self, text: str) -> str:
        raise NotImplementedError

    @staticmethod
    def from_json(spec: dict[str, Any] | None) -> "Normalizer | None":
        if spec is None:
            return None
        kind = spec.get("type")
        if kind == "Sequence":
            return SequenceNormalizer(
                [Normalizer.from_json(s) for s in spec.get("normalizers", [])]
            )
        if kind == "Lowercase":
            return Lowercase()
        if kind == "NFD":
            return NFD()
        if kind == "NFC":
            return NFC()
        if kind == "NFKD":
            return NFKD()
        if kind == "NFKC":
            return NFKC()
        if kind == "StripAccents":
            return StripAccents()
        if kind == "BertNormalizer":
            return BertNormalizer(
                lowercase=spec.get("lowercase", True),
                strip_accents=spec.get("strip_accents"),
                clean_text=spec.get("clean_text", True),
                handle_chinese_chars=spec.get("handle_chinese_chars", True),
            )
        if kind == "Replace":
            pattern = spec.get("pattern", {})
            return Replace(pattern.get("String", ""), spec.get("content", ""))
        if kind == "Prepend":
            return Prepend(spec.get("prepend", ""))
        if kind == "Strip":
            return Strip(spec.get("strip_left", True), spec.get("strip_right", True))
        raise ValueError(f"unsupported normalizer type {kind!r}")


class SequenceNormalizer(Normalizer):
    def __init__(self, normalizers):
        self.normalizers = [n for n in normalizers if n is not None]

    def normalize(self, text):
        for n in self.normalizers:
            text = n.normalize(text)
        return text


class Lowercase(Normalizer):
    def normalize(self, text):
        return text.lower()


class NFD(Normalizer):
    def normalize(self, text):
        return unicodedata.normalize("NFD", text)


class NFC(Normalizer):
    def normalize(self, text):
        return unicodedata.normalize("NFC", text)


class NFKD(Normalizer):
    def normalize(self, text):
        return unicodedata.normalize("NFKD", text)


class NFKC(Normalizer):
    def normalize(self, text):
        return unicodedata.normalize("NFKC", text)


class StripAccents(Normalizer):
    def normalize(self, text):
        decomposed = unicodedata.normalize("NFD", text)
        return "".join(c for c in decomposed if unicodedata.category(c) != "Mn")


class Replace(Normalizer):
    def __init__(self, pattern: str, content: str):
        self.pattern = pattern
        self.content = content

    def normalize(self, text):
        return text.replace(self.pattern, self.content) if self.pattern else text


class Prepend(Normalizer):
    def __init__(self, prefix: str):
        self.prefix = prefix

    def normalize(self, text):
        return self.prefix + text if text else text


class Strip(Normalizer):
    def __init__(self, left: bool = True, right: bool = True):
        self.left = left
        self.right = right

    def normalize(self, text):
        if self.left:
            text = text.lstrip()
        if self.right:
            text = text.rstrip()
        return text


class BertNormalizer(Normalizer):
    """Reference: rten-text normalizer.rs:71 (lowercase + NFD accent strip) —
    plus BERT control-char cleanup and CJK spacing per HF semantics."""

    def __init__(self, lowercase=True, strip_accents=None, clean_text=True,
                 handle_chinese_chars=True):
        self.lowercase = lowercase
        # HF: strip_accents=None → strip only when lowercasing
        self.strip_accents = strip_accents if strip_accents is not None else lowercase
        self.clean_text = clean_text
        self.handle_chinese_chars = handle_chinese_chars

    def normalize(self, text):
        if self.clean_text:
            out = []
            for c in text:
                cp = ord(c)
                if cp == 0 or cp == 0xFFFD or unicodedata.category(c).startswith("C") and c not in "\t\n\r":
                    continue
                out.append(" " if c in "\t\n\r" or unicodedata.category(c) == "Zs" else c)
            text = "".join(out)
        if self.handle_chinese_chars:
            out = []
            for c in text:
                if _is_cjk(ord(c)):
                    out.extend([" ", c, " "])
                else:
                    out.append(c)
            text = "".join(out)
        if self.lowercase:
            text = text.lower()
        if self.strip_accents:
            text = StripAccents().normalize(text)
        return text


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )
