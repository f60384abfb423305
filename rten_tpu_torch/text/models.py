"""Subword models: WordPiece and byte-level BPE (a copy of
``rten_tpu/text/models.py``).

Reference: rten-text/src/wordpiece.rs:20 (greedy longest-match-first with
"##" continuation prefix) and rten-text/src/bpe.rs:232 (merge-rank BPE over
the GPT-2 byte↔unicode table).
"""

from __future__ import annotations

import functools
from typing import Iterable


class SubwordModel:
    def tokenize(self, word: str) -> list[tuple[int, str]]:
        """word → [(token_id, token_string), ...]"""
        raise NotImplementedError


class WordPiece(SubwordModel):
    """Greedy longest-prefix tokenization (reference: wordpiece.rs:20)."""

    def __init__(
        self,
        vocab: dict[str, int],
        unk_token: str = "[UNK]",
        continuing_prefix: str = "##",
        max_input_chars_per_word: int = 100,
    ):
        self.vocab = vocab
        self.unk_token = unk_token
        self.continuing_prefix = continuing_prefix
        self.max_chars = max_input_chars_per_word

    def tokenize(self, word: str) -> list[tuple[int, str]]:
        unk = [(self.vocab.get(self.unk_token, 0), self.unk_token)]
        if len(word) > self.max_chars:
            return unk
        out: list[tuple[int, str]] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = self.continuing_prefix + piece
                tid = self.vocab.get(piece)
                if tid is not None:
                    cur = (tid, piece)
                    break
                end -= 1
            if cur is None:
                return unk
            out.append(cur)
            start = end
        return out


@functools.cache
def bytes_to_unicode() -> dict[int, str]:
    """The GPT-2 printable byte↔unicode bijection (reference: bpe.rs
    char_to_byte table)."""
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
    return dict(zip(bs, (chr(c) for c in cs)))


@functools.cache
def unicode_to_bytes() -> dict[str, int]:
    return {v: k for k, v in bytes_to_unicode().items()}


class ByteLevelBPE(SubwordModel):
    """Merge-rank BPE over byte-level units (reference: bpe.rs:232).

    ``merges`` is the ordered merge list; earlier = higher priority. Tokenize
    repeatedly applies the lowest-rank adjacent pair merge.
    """

    def __init__(
        self,
        vocab: dict[str, int],
        merges: Iterable[tuple[str, str] | str],
        unk_token: str | None = None,
        end_of_word_suffix: str = "",
    ):
        self.vocab = vocab
        self.ranks: dict[tuple[str, str], int] = {}
        for i, m in enumerate(merges):
            pair = tuple(m.split(" ")) if isinstance(m, str) else tuple(m)
            if len(pair) == 2:
                self.ranks[pair] = i
        self.unk_token = unk_token
        self.end_of_word_suffix = end_of_word_suffix
        self._cache: dict[str, list[str]] = {}
        self._native = None
        self._native_tried = False

    def _get_native(self):
        """Lazy C++ merge-loop (rten_tpu_torch.native); pieces are interned to
        int ids so the hot loop runs without Python string hashing. None only
        where the library is not available (no C++ compiler)."""
        if self._native_tried:
            return self._native
        self._native_tried = True
        import numpy as np

        from rten_tpu_torch.native.bindings import NativeBpe, available

        if not available():
            return None
        pid: dict[str, int] = {}

        def intern(s: str) -> int:
            if s not in pid:
                pid[s] = len(pid)
            return pid[s]

        left, right, merged, ranks = [], [], [], []
        for (l, r), rank in self.ranks.items():
            left.append(intern(l))
            right.append(intern(r))
            merged.append(intern(l + r))
            ranks.append(rank)
        self._native = (
            NativeBpe(
                np.asarray(left), np.asarray(right),
                np.asarray(merged), np.asarray(ranks),
            ),
            pid,
            {v: k for k, v in pid.items()},
        )
        return self._native

    def _bpe(self, token: str) -> list[str]:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        native = self._get_native()
        if native is not None and not self.end_of_word_suffix:
            import numpy as np

            bpe, pid, rev = native
            ids = []
            for c in token:
                i = pid.get(c)
                if i is None:
                    # Unseen unit: give it a fresh id (it can never merge —
                    # it appears in no merge rule).
                    i = len(pid)
                    pid[c] = i
                    rev[i] = c
                ids.append(i)
            out_ids = bpe.apply(np.asarray(ids, np.int32))
            parts = [rev[int(i)] for i in out_ids]
            if len(self._cache) < (1 << 16):
                self._cache[token] = parts
            return parts
        parts = list(token)
        if self.end_of_word_suffix and parts:
            parts[-1] = parts[-1] + self.end_of_word_suffix
        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank = r
                    best_i = i
            if best_rank is None:
                break
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        if len(self._cache) < (1 << 16):
            self._cache[token] = parts
        return parts

    def tokenize(self, word: str) -> list[tuple[int, str]]:
        out = []
        for piece in self._bpe(word):
            tid = self.vocab.get(piece)
            if tid is None:
                if self.unk_token is not None:
                    out.append((self.vocab[self.unk_token], self.unk_token))
                continue
            out.append((tid, piece))
        return out
