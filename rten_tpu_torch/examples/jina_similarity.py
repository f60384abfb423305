"""Sentence-embedding similarity (Jina-style mean-pooled encoder).

The port's copy of ``examples/jina_similarity.py`` (reference:
rten-examples/src/jina_similarity.rs): sentences → WordPiece tokenization →
BERT-class encoder batch (padded, per-sequence lengths masked) → mean-pool
+ L2-normalize → cosine similarity ranking; on the card (``--cpu``: on the
host).

    python -m rten_tpu_torch.examples.jina_similarity --demo --query "cats sleep"
"""

from __future__ import annotations

import sys

from rten_tpu_torch.examples import common

DOCS = [
    "the cat sleeps on the mat",
    "a dog chases the ball in the park",
    "cats nap in warm sunshine",
    "stock markets rallied on tuesday",
]


def main(argv=None, result: dict | None = None):
    """Run the app; ``result``, when given, receives the padded ``ids``,
    the ``embeddings`` [1 + docs, D] and the ``sims``."""
    argv = argv or sys.argv[1:]
    p = common.make_parser(__doc__)
    p.add_argument("--query", default="sleeping cats")
    p.add_argument("--docs", help="file with one document per line")
    p.add_argument(
        "--model",
        help="BERT-family embedding checkpoint as .npz "
        "(np.savez(path, **{k: v.numpy() for k, v in model.state_dict().items()})) "
        "through from_hf_bert (≙ jina_similarity.rs's exported model)",
    )
    p.add_argument("--heads", type=int, help="override inferred head count (--model)")
    p.add_argument("--tokenizer", help="HF tokenizer.json (required with --model)")
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    import numpy as np
    import torch

    from rten_tpu_torch.kernels.dispatch import resolve_device
    from rten_tpu_torch.models import bert
    from rten_tpu_torch.text.normalizer import Lowercase
    from rten_tpu_torch.text.pretokenizer import BertPreTokenizer
    from rten_tpu_torch.text.tokenizer import Tokenizer, WordPiece

    docs = DOCS
    if args.docs:
        with open(args.docs, encoding="utf-8") as f:
            docs = [line.strip() for line in f if line.strip()]
    texts = [args.query, *docs]

    if args.tokenizer:
        with open(args.tokenizer, encoding="utf-8") as f:
            tok = Tokenizer.from_json(f.read())
    else:
        words = sorted({w for t in texts for w in t.lower().split()})
        tok = Tokenizer(
            WordPiece(common.word_vocab(words)),
            normalizer=Lowercase(),
            pre_tokenizer=BertPreTokenizer(),
        )

    dev = resolve_device(device)
    encs = [tok.encode(t).ids for t in texts]
    max_len = max(len(e) for e in encs)
    ids = np.zeros((len(encs), max_len), np.int32)
    lengths = np.zeros((len(encs),), np.int32)
    for i, e in enumerate(encs):
        ids[i, : len(e)] = e
        lengths[i] = len(e)

    if args.model:
        if not args.tokenizer:
            raise SystemExit("--model needs --tokenizer (ids must match the checkpoint)")
        state = common.strip_prefix(common.load_state_npz(args.model), "bert.")
        d_model = state["embeddings.word_embeddings.weight"].shape[1]
        n_layers = 0
        while f"encoder.layer.{n_layers}.attention.self.query.weight" in state:
            n_layers += 1
        cfg = bert.BertConfig(
            vocab_size=state["embeddings.word_embeddings.weight"].shape[0],
            n_layers=n_layers,
            n_heads=args.heads or max(1, d_model // 64),
            d_model=d_model,
            d_ff=state["encoder.layer.0.intermediate.dense.weight"].shape[0],
            max_seq=state["embeddings.position_embeddings.weight"].shape[0],
            n_segments=(
                state["embeddings.token_type_embeddings.weight"].shape[0]
                if "embeddings.token_type_embeddings.weight" in state
                else 0
            ),
        )
        print(f"loaded {args.model}: {cfg.n_layers} layers, d_model {cfg.d_model}")
        params = bert.from_hf_bert(state, cfg, device=dev)
    else:
        words = sorted({w for t in texts for w in t.lower().split()})
        cfg = bert.BertConfig(
            vocab_size=len(words) + 8, n_layers=2, n_heads=4, d_model=64, d_ff=128,
            max_seq=64, n_segments=0,
        )
        params = bert.init_params(args.seed, cfg, device=dev)
    lengths_t = torch.from_numpy(lengths).to(dev)
    hidden = bert.encode(params, cfg, torch.from_numpy(ids).to(dev), lengths=lengths_t)
    emb = common.to_numpy(bert.pool(hidden, lengths_t, mode="mean"))

    sims = emb[1:] @ emb[0]
    order = np.argsort(sims)[::-1]
    print(f"query: {args.query!r}")
    for rank, i in enumerate(order, 1):
        print(f"  {rank}. sim={sims[i]:+.4f}  {docs[i]!r}")
    if result is not None:
        result.update(ids=ids, embeddings=emb, sims=sims)
    return 0


if __name__ == "__main__":
    common.run_main(main)
