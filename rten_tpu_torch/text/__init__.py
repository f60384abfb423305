"""Tokenizers (reference: rten-text crate — WordPiece wordpiece.rs:20,
byte-level BPE bpe.rs:232, HF tokenizer.json loader tokenizers/json.rs,
normalizer.rs). Host-side text processing, a copy of ``rten_tpu/text``; the
hot BPE merge loop runs in the C++ native library (rten_tpu_torch.native)
wherever it is available.
"""

from rten_tpu_torch.text.tokenizer import Encoded, Tokenizer, TokenizerError

__all__ = ["Tokenizer", "Encoded", "TokenizerError"]
