"""Tokenizer: HF tokenizer.json loader + encode/decode.

Reference: rten-text/src/tokenizers.rs — Tokenizer :255, from_json :289,
Encoded (ids + offsets) :62. Supports WordPiece and byte-level BPE models,
the normalizer/pre-tokenizer zoo, added/special tokens, TemplateProcessing
post-processors, and streaming-safe decode.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from rten_tpu_torch.text.models import ByteLevelBPE, SubwordModel, WordPiece, unicode_to_bytes
from rten_tpu_torch.text.normalizer import Normalizer
from rten_tpu_torch.text.pretokenizer import ByteLevel, Metaspace, PreTokenizer


class TokenizerError(ValueError):
    pass


@dataclasses.dataclass
class Encoded:
    """Reference: Encoded, tokenizers.rs:62 — token ids with source offsets."""

    ids: list[int]
    tokens: list[str]
    offsets: list[tuple[int, int]]  # char offsets into the ORIGINAL text


@dataclasses.dataclass
class AddedToken:
    id: int
    content: str
    special: bool = False


class Tokenizer:
    def __init__(
        self,
        model: SubwordModel,
        normalizer: Normalizer | None = None,
        pre_tokenizer: PreTokenizer | None = None,
        added_tokens: list[AddedToken] | None = None,
        post_template: list[Any] | None = None,
        pair_template: list[Any] | None = None,
        byte_level_decode: bool = False,
    ):
        self.model = model
        self.normalizer = normalizer
        self.pre_tokenizer = pre_tokenizer
        self.added_tokens = added_tokens or []
        self._added_by_content = {t.content: t for t in self.added_tokens}
        self.post_template = post_template
        self.pair_template = pair_template
        self.byte_level_decode = byte_level_decode
        self._id_to_token: dict[int, str] = {}
        if hasattr(model, "vocab"):
            self._id_to_token = {v: k for k, v in model.vocab.items()}
        for t in self.added_tokens:
            self._id_to_token[t.id] = t.content

    # ---- loading -----------------------------------------------------------

    @classmethod
    def from_file(cls, path: str) -> "Tokenizer":
        with open(path, encoding="utf-8") as f:
            return cls.from_json(f.read())

    @classmethod
    def from_json(cls, data: str | dict) -> "Tokenizer":
        spec = json.loads(data) if isinstance(data, str) else data
        model_spec = spec.get("model") or {}
        kind = model_spec.get("type")
        if kind == "WordPiece":
            model: SubwordModel = WordPiece(
                vocab=model_spec["vocab"],
                unk_token=model_spec.get("unk_token", "[UNK]"),
                continuing_prefix=model_spec.get("continuing_subword_prefix", "##"),
                max_input_chars_per_word=model_spec.get("max_input_chars_per_word", 100),
            )
        elif kind == "BPE":
            model = ByteLevelBPE(
                vocab=model_spec["vocab"],
                merges=model_spec.get("merges", []),
                unk_token=model_spec.get("unk_token"),
                end_of_word_suffix=model_spec.get("end_of_word_suffix") or "",
            )
        else:
            raise TokenizerError(f"unsupported tokenizer model {kind!r}")

        normalizer = Normalizer.from_json(spec.get("normalizer"))
        pre = PreTokenizer.from_json(spec.get("pre_tokenizer"))
        added = [
            AddedToken(t["id"], t["content"], t.get("special", False))
            for t in spec.get("added_tokens", [])
        ]
        post_template, pair_template = _parse_post_processor(spec.get("post_processor"))
        byte_level_decode = isinstance(pre, ByteLevel) or (
            spec.get("decoder") or {}
        ).get("type") == "ByteLevel"
        return cls(
            model,
            normalizer,
            pre,
            added,
            post_template,
            pair_template,
            byte_level_decode,
        )

    # ---- vocab -------------------------------------------------------------

    def token_to_id(self, token: str) -> int | None:
        t = self._added_by_content.get(token)
        if t is not None:
            return t.id
        return getattr(self.model, "vocab", {}).get(token)

    def id_to_token(self, tid: int) -> str | None:
        return self._id_to_token.get(tid)

    # ---- encode -------------------------------------------------------------

    def encode(
        self,
        text: str,
        pair: str | None = None,
        add_special_tokens: bool = True,
    ) -> Encoded:
        first = self._encode_raw(text)
        second = self._encode_raw(pair) if pair is not None else None
        template = (
            (self.pair_template if second is not None else self.post_template)
            if add_special_tokens
            else None
        )
        if template is None:
            out = first
            if second is not None:
                out = Encoded(
                    first.ids + second.ids,
                    first.tokens + second.tokens,
                    first.offsets + second.offsets,
                )
            return out
        ids: list[int] = []
        tokens: list[str] = []
        offsets: list[tuple[int, int]] = []
        for item in template:
            if item == "$A":
                ids += first.ids
                tokens += first.tokens
                offsets += first.offsets
            elif item == "$B":
                if second is None:
                    raise TokenizerError("template requires a pair input")
                ids += second.ids
                tokens += second.tokens
                offsets += second.offsets
            else:
                tid = self.token_to_id(item)
                if tid is None:
                    raise TokenizerError(f"special token {item!r} not in vocab")
                ids.append(tid)
                tokens.append(item)
                offsets.append((0, 0))
        return Encoded(ids, tokens, offsets)

    def _encode_raw(self, text: str) -> Encoded:
        # Added/special tokens split the text first (they bypass
        # normalization), matching HF semantics.
        segments = self._split_on_added(text)
        ids: list[int] = []
        tokens: list[str] = []
        offsets: list[tuple[int, int]] = []
        for seg, seg_off, added in segments:
            if added is not None:
                ids.append(added.id)
                tokens.append(added.content)
                offsets.append((seg_off, seg_off + len(seg)))
                continue
            norm = self.normalizer.normalize(seg) if self.normalizer else seg
            pieces = (
                self.pre_tokenizer.split(norm)
                if self.pre_tokenizer
                else ([(norm, 0)] if norm else [])
            )
            for piece, off in pieces:
                for tid, tok in self.model.tokenize(piece):
                    ids.append(tid)
                    tokens.append(tok)
                    # offsets are approximate for normalized text (same
                    # policy as the reference: offsets refer to the
                    # pre-tokenized word start)
                    offsets.append((seg_off + off, seg_off + off + len(piece)))
        return Encoded(ids, tokens, offsets)

    def _split_on_added(self, text: str):
        segments: list[tuple[str, int, AddedToken | None]] = []
        pos = 0
        while pos < len(text):
            next_at = None
            next_tok = None
            for t in self.added_tokens:
                i = text.find(t.content, pos)
                if i != -1 and (next_at is None or i < next_at):
                    next_at = i
                    next_tok = t
            if next_tok is None:
                segments.append((text[pos:], pos, None))
                break
            if next_at > pos:
                segments.append((text[pos:next_at], pos, None))
            segments.append((next_tok.content, next_at, next_tok))
            pos = next_at + len(next_tok.content)
        return segments

    # ---- decode -------------------------------------------------------------

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        special = {t.id for t in self.added_tokens if t.special}
        toks = []
        for tid in ids:
            tid = int(tid)
            if skip_special_tokens and tid in special:
                continue
            tok = self._id_to_token.get(tid)
            if tok is not None:
                toks.append(tok)
        if self.byte_level_decode:
            table = unicode_to_bytes()
            data = bytes(table[c] for t in toks for c in t if c in table)
            return data.decode("utf-8", errors="replace")
        if isinstance(self.model, WordPiece):
            out = []
            for t in toks:
                if t.startswith(self.model.continuing_prefix):
                    out.append(t[len(self.model.continuing_prefix) :])
                else:
                    if out:
                        out.append(" ")
                    out.append(t)
            return "".join(out)
        if isinstance(self.pre_tokenizer, Metaspace):
            return "".join(toks).replace(self.pre_tokenizer.replacement, " ").lstrip()
        return " ".join(toks)


def _parse_post_processor(spec: dict | None):
    if spec is None:
        return None, None
    kind = spec.get("type")
    if kind == "TemplateProcessing":
        def parse(template):
            out = []
            for item in template or []:
                if "SpecialToken" in item:
                    out.append(item["SpecialToken"]["id"])
                elif "Sequence" in item:
                    out.append("$" + item["Sequence"]["id"])
            return out or None

        return parse(spec.get("single")), parse(spec.get("pair"))
    if kind in ("BertProcessing", "RobertaProcessing"):
        sep, sep_id = spec.get("sep", ["[SEP]", 102])
        cls_, cls_id = spec.get("cls", ["[CLS]", 101])
        del sep_id, cls_id
        return [cls_, "$A", sep], [cls_, "$A", sep, *(["$B", sep] if kind == "BertProcessing" else [sep, "$B", sep])]
    if kind == "ByteLevel":
        return None, None
    if kind == "Sequence":
        single = pair = None
        for sub in spec.get("processors", []):
            s, p = _parse_post_processor(sub)
            single = s or single
            pair = p or pair
        return single, pair
    return None, None
