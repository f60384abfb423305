"""The port's tokenizers (rten_tpu_torch.text) against the JAX package's
(rten_tpu.text): every tokenizer of tests/test_text.py, and seeded fuzz
over tokenizers built from README.md's text (byte-level BPE with learned
merges, WordPiece with BertNormalizer, Metaspace), with the port's native
merge loop on and off. Both packages read the same tokenizer JSON; ids,
tokens, offsets and decoded text (of every prefix of the ids, so that
byte-level tokens that split a multi-byte character decode alike) must be
equal."""

import json
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from rten_tpu.text import Tokenizer as JaxTokenizer
from rten_tpu_torch.native import bindings
from rten_tpu_torch.text import Tokenizer
from rten_tpu_torch.text.models import bytes_to_unicode, unicode_to_bytes
from rten_tpu_torch.text.normalizer import BertNormalizer
from rten_tpu_torch.text.pretokenizer import Metaspace
from test_text import bert_tokenizer_json, gpt2_tokenizer_json

README = (Path(__file__).resolve().parent.parent / "README.md").read_text(encoding="utf-8")


def multibyte_json():
    """test_text's byte-level tokenizer with no merges over "héllo"'s bytes."""
    units = bytes_to_unicode()
    vocab = {units[b]: i for i, b in enumerate(sorted(set("héllo".encode("utf-8"))))}
    return json.dumps({"pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False},
                       "decoder": {"type": "ByteLevel"}, "model": {"type": "BPE", "vocab": vocab, "merges": []}})


def metaspace_spec():
    """A SentencePiece-style BPE over README.md: Metaspace pieces, 300
    merges learned by chip_smoke.train_bpe, every character of README a
    unit, <unk> for the rest."""
    pre = Metaspace()
    merges = chip_smoke.train_bpe(README, 300, pre_tokenizer=pre)
    vocab = {"<unk>": 0}
    for c in sorted({c for piece, _ in pre.split(README) for c in piece}):
        vocab.setdefault(c, len(vocab))
    for a, b in merges:
        vocab.setdefault(a + b, len(vocab))
    return {"pre_tokenizer": {"type": "Metaspace", "replacement": "▁", "add_prefix_space": True},
            "decoder": {"type": "Metaspace"},
            "model": {"type": "BPE", "vocab": vocab, "merges": [f"{a} {b}" for a, b in merges],
                      "unk_token": "<unk>"}}


@pytest.fixture(scope="module")
def specs():
    return {"bpe": chip_smoke.bpe_tokenizer_spec(chip_smoke.train_bpe(README, 300)),
            "wordpiece": chip_smoke.wordpiece_tokenizer_spec(README),
            "metaspace": metaspace_spec()}


def _port(spec, native: bool, monkeypatch):
    if not native:
        monkeypatch.setattr(bindings, "load_library", lambda auto_build=True: None)
    return Tokenizer.from_json(spec)


def assert_same(tok, jtok, text, pair=None, add_special_tokens=True):
    got = tok.encode(text, pair=pair, add_special_tokens=add_special_tokens)
    want = jtok.encode(text, pair=pair, add_special_tokens=add_special_tokens)
    assert got.ids == want.ids
    assert got.tokens == want.tokens
    assert got.offsets == want.offsets
    for k in range(len(want.ids) + 1):
        for skip in (True, False):
            assert tok.decode(want.ids[:k], skip) == jtok.decode(want.ids[:k], skip), (k, skip)
    return got


# The cases of tests/test_text.py: (tokenizer JSON, text, pair, add_special_tokens).
CASES = [
    ("bert", "The quick fox playing", None, True),
    ("bert", "zebra", None, False),
    ("bert", "the fox", "the quick", True),
    ("bert", "the, fox", None, False),
    ("bert", "The quick", None, False),
    ("bert", "Héllo\tWörld jumped over, the fox", None, True),
    ("gpt2", "hello hello", None, True),
    ("gpt2", "helloh", None, True),
    ("gpt2", "hello<|endoftext|>hello", None, True),
    ("gpt2", "hello olleh he", None, True),
    ("multibyte", "héllo", None, True),
]
JSONS = {"bert": bert_tokenizer_json, "gpt2": gpt2_tokenizer_json, "multibyte": multibyte_json}


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("kind,text,pair,special", CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_tokenizers_of_test_text_match_jax(monkeypatch, kind, text, pair, special, native):
    spec = JSONS[kind]()
    tok, jtok = _port(spec, native, monkeypatch), JaxTokenizer.from_json(spec)
    assert_same(tok, jtok, text, pair, special)
    if kind != "bert":
        assert (tok.model._get_native() is not None) == native


def test_vocab_lookups_and_tables_match_jax():
    from rten_tpu.text.models import bytes_to_unicode as jb2u
    from rten_tpu.text.normalizer import BertNormalizer as JaxBertNormalizer

    assert bytes_to_unicode() == jb2u() and all(unicode_to_bytes()[v] == k for k, v in jb2u().items())
    for kind in ("bert", "gpt2"):
        tok, jtok = Tokenizer.from_json(JSONS[kind]()), JaxTokenizer.from_json(JSONS[kind]())
        for tid in range(-1, 14):
            assert tok.id_to_token(tid) == jtok.id_to_token(tid)
            name = jtok.id_to_token(tid)
            if name is not None:
                assert tok.token_to_id(name) == jtok.token_to_id(name) == tid
    for text in ("Héllo\tWörld", "  ÀÉÎ õü 中文\u0000x", "a​b"):
        assert BertNormalizer(lowercase=True).normalize(text) == JaxBertNormalizer(lowercase=True).normalize(text)


_ASCII = list("abcdefghijklmnopqrstuvwxyzABCXYZ")
_PUNCT = list(".,;:!?()[]{}'\"-_/\\@#$%^&*+=<>|~`")
_MULTI = ["é", "ü", "ñ", "—", "→", "·", "≤", "中文", "日本", "🙂", "Ω", "ß", " ", "\t", "\n"]
_ADDED = {"bpe": ["<|endoftext|>"], "wordpiece": ["[SEP]", "[MASK]", "[CLS]"], "metaspace": []}


def fuzz_text(seed: int, kind: str) -> str:
    """Seeded text: README words, ASCII letters, punctuation, digits,
    multi-byte characters and the tokenizer's added tokens, joined by
    spaces or by nothing."""
    rng = np.random.default_rng(seed)
    words = README.split()
    parts = []
    for _ in range(int(rng.integers(10, 40))):
        pick = rng.integers(0, 6)
        if pick == 0:
            parts.append(words[int(rng.integers(len(words)))])
        elif pick == 1:
            parts.append("".join(rng.choice(_ASCII, int(rng.integers(1, 9)))))
        elif pick == 2:
            parts.append("".join(rng.choice(_PUNCT, int(rng.integers(1, 4)))))
        elif pick == 3:
            parts.append(str(int(rng.integers(0, 10 ** int(rng.integers(1, 7))))))
        elif pick == 4:
            parts.append("".join(rng.choice(_MULTI, int(rng.integers(1, 4)))))
        elif _ADDED[kind]:
            parts.append(str(rng.choice(_ADDED[kind])))
        parts.append(" " if rng.random() < 0.7 else "")
    return "".join(parts)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("kind", ["bpe", "wordpiece", "metaspace"])
@pytest.mark.parametrize("seed", range(6))
def test_fuzz_matches_jax(specs, monkeypatch, kind, seed, native):
    """Seeded fuzz over the README-built tokenizers: the port (its native
    merge loop on or off) against the JAX package (its own library), single
    inputs and pairs."""
    spec = specs[kind]
    tok, jtok = _port(spec, native, monkeypatch), JaxTokenizer.from_json(spec)
    text, pair = fuzz_text(seed, kind), fuzz_text(seed + 100, kind)
    got = assert_same(tok, jtok, text)
    assert got.ids
    assert_same(tok, jtok, text, pair=pair)
    assert_same(tok, jtok, pair, add_special_tokens=False)
    if kind == "bpe":
        assert (tok.model._get_native() is not None) == native


def test_readme_tokenizers_match_jax(specs):
    """README.md in full: the BPE's ids through the native library equal
    the Python path's and the JAX package's, and decode alike; WordPiece
    encodes it as the JAX package does, with no unknown token (every
    character is in its vocabulary)."""
    tok, py = Tokenizer.from_json(specs["bpe"]), Tokenizer.from_json(specs["bpe"])
    py.model._native, py.model._native_tried = None, True
    jtok = JaxTokenizer.from_json(specs["bpe"])
    ids = tok.encode(README).ids
    assert ids == py.encode(README).ids == jtok.encode(README).ids
    assert tok.decode(ids) == jtok.decode(ids)
    wp, jwp = Tokenizer.from_json(specs["wordpiece"]), JaxTokenizer.from_json(specs["wordpiece"])
    enc = wp.encode(README)
    assert enc.ids == jwp.encode(README).ids and "[UNK]" not in enc.tokens
    assert len(specs["wordpiece"]["model"]["vocab"]) == 30522
