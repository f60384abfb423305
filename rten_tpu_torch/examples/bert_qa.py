"""Extractive question answering with a BERT encoder.

The port's copy of ``examples/bert_qa.py`` (reference:
rten-examples/src/bert_qa.rs): WordPiece tokenization of [CLS] question
[SEP] context [SEP] with segment ids, BERT encoder, start/end span logits,
best-span search, answer text recovered from the context's tokens; on the
card (``--cpu``: the kernels' plain versions).

    python -m rten_tpu_torch.examples.bert_qa --demo
"""

from __future__ import annotations

import sys

from rten_tpu_torch.examples import common


def main(argv=None, result: dict | None = None):
    """Run the app; ``result``, when given, receives the run's ``ids``,
    ``span``, ``score``, ``answer`` and the ``start`` / ``end`` logits."""
    argv = argv or sys.argv[1:]
    p = common.make_parser(__doc__)
    p.add_argument("--question", default="where is the cat")
    p.add_argument("--context", default="the small cat sleeps on the warm mat near the door")
    p.add_argument(
        "--model",
        help="real weights: .npz of an HF BertForQuestionAnswering (or "
        "BertModel + random span head) state dict, via models/bert."
        "from_hf_bert; --demo uses seeded weights",
    )
    p.add_argument("--heads", type=int, help="override inferred head count (--model)")
    p.add_argument(
        "--tokenizer", help="HF tokenizer.json (defaults to the demo word vocab)"
    )
    args = p.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    import numpy as np
    import torch

    from rten_tpu_torch.kernels.dispatch import resolve_device
    from rten_tpu_torch.models import bert
    from rten_tpu_torch.text.normalizer import Lowercase
    from rten_tpu_torch.text.pretokenizer import BertPreTokenizer
    from rten_tpu_torch.text.tokenizer import Tokenizer, WordPiece

    dev = resolve_device(device)
    if args.tokenizer:
        with open(args.tokenizer, encoding="utf-8") as f:
            tok = Tokenizer.from_json(f.read())
        vocab = tok.model.vocab
    else:
        words = sorted(set((args.question + " " + args.context).lower().split()))
        vocab = common.word_vocab(words)
        tok = Tokenizer(
            WordPiece(vocab),
            normalizer=Lowercase(),
            pre_tokenizer=BertPreTokenizer(),
        )

    q_enc = tok.encode(args.question)
    c_enc = tok.encode(args.context)
    ids = [vocab["[CLS]"], *q_enc.ids, vocab["[SEP]"], *c_enc.ids, vocab["[SEP]"]]
    segs = [0] * (len(q_enc.ids) + 2) + [1] * (len(c_enc.ids) + 1)
    ctx_start = len(q_enc.ids) + 2  # first context token position

    qa_head = None
    if args.model:
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
        )
        print(f"loaded {args.model}: {cfg.n_layers} layers, d_model {cfg.d_model}")
        params = bert.from_hf_bert(state, cfg, device=dev)
        if "qa_outputs.weight" in state:
            # BertForQuestionAnswering span head: Linear [2, D] → w [D, 2].
            qa_head = {
                "w": torch.from_numpy(np.ascontiguousarray(np.asarray(state["qa_outputs.weight"], np.float32).T)).to(dev),
                "b": torch.from_numpy(np.asarray(state["qa_outputs.bias"], np.float32)).to(dev),
            }
    else:
        cfg = bert.BertConfig(
            vocab_size=len(vocab), n_layers=2, n_heads=4, d_model=64, d_ff=128, max_seq=64
        )
        params = bert.init_params(args.seed, cfg, device=dev)
    hidden = bert.encode(
        params,
        cfg,
        torch.tensor([ids], dtype=torch.int32, device=dev),
        segment_ids=torch.tensor([segs], dtype=torch.int32, device=dev),
    )
    if qa_head is None:
        # A random span head from the seed (the JAX app draws its own with
        # jax.random: the two apps' heads differ).
        gen = torch.Generator().manual_seed(args.seed + 1)
        qa_head = {
            "w": (torch.randn((cfg.d_model, 2), generator=gen) * 0.1).to(dev),
            "b": torch.zeros(2, device=dev),
        }
    start_l, end_l = bert.qa_logits(hidden, qa_head)
    start_l = start_l[0].float().cpu().numpy()
    end_l = end_l[0].float().cpu().numpy()

    # Best span within the context segment, end ≥ start, length ≤ 8.
    best, best_score = (ctx_start, ctx_start), -np.inf
    for s in range(ctx_start, len(ids) - 1):
        for e in range(s, min(s + 8, len(ids) - 1)):
            sc = start_l[s] + end_l[e]
            if sc > best_score:
                best, best_score = (s, e), sc
    context_tokens = c_enc.tokens
    s_rel, e_rel = best[0] - ctx_start, best[1] - ctx_start
    answer = " ".join(context_tokens[s_rel : e_rel + 1]).replace(" ##", "")
    print(f"Q: {args.question}")
    print(f"A: {answer!r} (span {best}, score {best_score:.2f})")
    if result is not None:
        result.update(ids=ids, span=best, score=float(best_score), answer=answer, start=start_l, end=end_l)
    return 0


if __name__ == "__main__":
    common.run_main(main)
