"""The port's example apps (rten_tpu_torch.examples: gpt2, bert_qa) on the
CPU against the JAX package's (examples/), text in and text out at a tiny
width, and the *_jit / predict names of the port's encoders and vision
models against their forwards.

gpt2.py runs with ``--top-k 1`` (one candidate: the draw is the argmax
whatever the noise, so the two packages' different samplers agree) on the
same tiny HF GPT-2 .npz and a byte-level BPE tokenizer learned from
README.md, dense and ``--int8``, and on a tiny f32 .rten file. bert_qa.py
runs on a tiny HF BertForQuestionAnswering .npz with its ``qa_outputs``
head and a WordPiece tokenizer over README's words. The JAX apps run once
per module (module-scoped fixtures)."""

import contextlib
import io
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from rten_tpu_torch.examples import bert_qa, gpt2

REPO = Path(__file__).resolve().parent.parent
README = (REPO / "README.md").read_text(encoding="utf-8")
GPT2_TINY = dict(vocab=500, n_layers=2, d=256, ff=1024, n_pos=256)  # SLICE_CFG's widths, head dim 64
BERT_TINY = dict(vocab=3000, n_layers=2, d=256, ff=512, n_pos=128)
N_NEW = 16


def _run(main, argv, result=None):
    """``main(argv)``'s exit code and printed lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv) if result is None else main(argv, result=result)
    return rc, buf.getvalue().splitlines()


def _lines(lines, *prefixes):
    return [line for line in lines if line.startswith(prefixes)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from rten_tpu_torch.format import save_rten
    from rten_tpu_torch.graph import Graph
    from rten_tpu_torch.models.gpt2_graph import Gpt2GraphConfig, build_gpt2_graph

    d = tmp_path_factory.mktemp("apps")
    paths = {"bpe": d / "bpe.json", "wordpiece": d / "wordpiece.json", "gpt2": d / "gpt2.npz",
             "rten": d / "gpt2_f32.rten", "bert": d / "bert_qa.npz"}
    paths["bpe"].write_text(json.dumps(chip_smoke.bpe_tokenizer_spec(chip_smoke.train_bpe(README, 200))))
    paths["wordpiece"].write_text(json.dumps(chip_smoke.wordpiece_tokenizer_spec(README, BERT_TINY["vocab"])))
    g, b = GPT2_TINY, BERT_TINY
    np.savez(paths["gpt2"], **chip_smoke.gpt2_hf_state(0, g["vocab"], g["n_layers"], g["d"], g["ff"], g["n_pos"]))
    np.savez(paths["bert"], **chip_smoke.bert_qa_hf_state(0, b["vocab"], b["n_layers"], b["d"], b["ff"], b["n_pos"]))
    gcfg = Gpt2GraphConfig(vocab_size=g["vocab"], n_positions=g["n_pos"], d_model=g["d"], n_layers=g["n_layers"],
                           n_heads=4, d_ff=g["ff"])
    paths["rten"].write_bytes(save_rten(build_gpt2_graph(Graph, gcfg, seed=1, tied=True)))
    paras = chip_smoke.readme_paragraphs(README)
    texts = {"prompt": paras[0], "question": paras[1].split(". ")[0], "context": paras[0].split(". ")[0]}
    return paths, texts


GPT2_ROUTES = {"npz": [], "npz_int8": ["--int8"], "rten": ["--heads", "4"]}


def _gpt2_argv(files, route):
    paths, texts = files
    model = paths["rten"] if route == "rten" else paths["gpt2"]
    return ["--model", str(model), "--tokenizer", str(paths["bpe"]), "--top-k", "1", "-n", str(N_NEW),
            "--prompt", texts["prompt"], *GPT2_ROUTES[route]]


@pytest.fixture(scope="module")
def jax_gpt2(files):
    """The JAX app's printed lines on each route."""
    sys.path.insert(0, str(REPO))
    from examples import gpt2 as jgpt2

    out = {}
    for route in GPT2_ROUTES:
        rc, lines = _run(jgpt2.main, _gpt2_argv(files, route))
        assert rc == 0
        out[route] = lines
    return out


@pytest.mark.parametrize("route", list(GPT2_ROUTES))
def test_gpt2_app_matches_jax(files, jax_gpt2, route):
    """The same prompt line (its token count) and generated text as the JAX
    app; the prompt ids are the JAX tokenizer's."""
    from rten_tpu.text import Tokenizer as JaxTokenizer

    paths, texts = files
    res = {}
    rc, lines = _run(gpt2.main, [*_gpt2_argv(files, route), "--cpu"], res)
    assert rc == 0
    want = jax_gpt2[route]
    assert _lines(lines, "prompt:", "generated:", "loaded", "backend:") == _lines(
        want, "prompt:", "generated:", "loaded", "backend:")
    assert res["prompt_ids"] == JaxTokenizer.from_json(paths["bpe"].read_text()).encode(texts["prompt"]).ids
    assert len(res["tokens"]) == N_NEW and _lines(lines, "16 tokens; warmup")


@pytest.fixture(scope="module")
def jax_bert(files):
    """The JAX app's printed lines, and its start / end logits on the same
    ids, computed as the app does (examples/bert_qa.py)."""
    import jax.numpy as jnp

    sys.path.insert(0, str(REPO))
    from examples import bert_qa as jqa
    from examples import common as jcommon
    from rten_tpu.models import bert as jbert
    from rten_tpu.text import Tokenizer as JaxTokenizer

    paths, texts = files
    argv = ["--model", str(paths["bert"]), "--tokenizer", str(paths["wordpiece"]), "--question",
            texts["question"], "--context", texts["context"]]
    rc, lines = _run(jqa.main, argv)
    assert rc == 0
    tok = JaxTokenizer.from_json(paths["wordpiece"].read_text())
    q, c = tok.encode(texts["question"]).ids, tok.encode(texts["context"]).ids
    vocab = tok.model.vocab
    ids = [vocab["[CLS]"], *q, vocab["[SEP]"], *c, vocab["[SEP]"]]
    segs = [0] * (len(q) + 2) + [1] * (len(c) + 1)
    state = jcommon.strip_prefix(jcommon.load_state_npz(str(paths["bert"])), "bert.")
    b = BERT_TINY
    cfg = jbert.BertConfig(vocab_size=b["vocab"], n_layers=b["n_layers"], n_heads=4, d_model=b["d"], d_ff=b["ff"],
                           max_seq=b["n_pos"])
    hidden = jbert.encode(jbert.from_hf_bert(state, cfg), cfg, jnp.asarray([ids], jnp.int32),
                          segment_ids=jnp.asarray([segs], jnp.int32))
    head = {"w": jnp.asarray(state["qa_outputs.weight"].T), "b": jnp.asarray(state["qa_outputs.bias"])}
    start, end = jbert.qa_logits(hidden, head)
    return argv, lines, ids, np.asarray(start)[0], np.asarray(end)[0]


def test_bert_qa_app_matches_jax(jax_bert):
    """The same question, span, answer and printed score as the JAX app,
    on the same ids; start and end logits within 1e-4."""
    argv, want, ids, start, end = jax_bert
    res = {}
    rc, lines = _run(bert_qa.main, [*argv, "--cpu"], res)
    assert rc == 0
    assert _lines(lines, "loaded", "Q:", "A:") == _lines(want, "loaded", "Q:", "A:")
    assert res["ids"] == ids
    for got, ref in ((res["start"], start), (res["end"], end)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * max(1.0, float(np.abs(ref).max())))
    assert abs(res["score"] - float(start[res["span"][0]] + end[res["span"][1]])) < 1e-4


@pytest.mark.parametrize("app,extra", [(gpt2, ["-n", "4"]), (bert_qa, [])], ids=["gpt2", "bert_qa"])
def test_demo_on_cpu_exits_0(app, extra):
    rc, lines = _run(app.main, ["--demo", "--cpu", *extra])
    assert rc == 0 and lines


def _jit_cases():
    from rten_tpu_torch.models import bert, mobilenet, resnet, vit, wav2vec2

    gen = torch.Generator().manual_seed(0)
    bcfg = bert.BertConfig(vocab_size=300, n_layers=1, n_heads=4, d_model=256, d_ff=512, max_seq=32)
    bparams = bert.quantize_params_int8(bert.init_params(0, bcfg, device="cpu"), device="cpu")
    ids = torch.randint(0, 300, (2, 12), generator=gen, dtype=torch.int32)
    lengths, segs = torch.tensor([12, 5]), torch.randint(0, 2, (2, 12), generator=gen, dtype=torch.int32)
    wcfg = wav2vec2.Wav2Vec2Config(conv_dim=(32, 32), conv_kernel=(10, 3), conv_stride=(5, 2), d_model=256,
                                   n_layers=1, n_heads=4, d_ff=512)
    wparams = wav2vec2.quantize_params_int8(wav2vec2.init_params(0, wcfg, device="cpu"), device="cpu")
    wav = torch.randn(2, 490, generator=gen)
    vcfg = vit.ViTConfig(image_size=32, patch_size=8, n_layers=1, n_heads=4, d_model=256, d_ff=512, n_classes=10)
    mcfg = mobilenet.MobileNetConfig(blocks=((1, 16, 1, 1), (6, 24, 2, 2)), last_channels=64, num_classes=10)
    rcfg = resnet.ResNetConfig(stage_sizes=(1, 1), num_classes=10, width=8)
    images = torch.randn(2, 3, 32, 32, generator=gen)
    mparams = mobilenet.quantize_params_int8(mobilenet.init_params(0, mcfg, device="cpu"), device="cpu")
    return {
        "bert.encode_jit": (lambda: bert.encode_jit(bparams, bcfg, ids, lengths, segs),
                            lambda: bert.encode(bparams, bcfg, ids, lengths=lengths, segment_ids=segs)),
        "wav2vec2.ctc_logits_jit": (lambda: wav2vec2.ctc_logits_jit(wparams, wcfg, wav, lengths=torch.tensor([490, 300])),
                                    lambda: wav2vec2.ctc_logits(wparams, wcfg, wav, lengths=torch.tensor([490, 300]))),
        "vit.classify_jit": (lambda p=vit.init_params(0, vcfg, device="cpu"): vit.classify_jit(p, vcfg, images),
                             lambda p=vit.init_params(0, vcfg, device="cpu"): vit.classify(p, vcfg, images)),
        "mobilenet.predict": (lambda: mobilenet.predict(mparams, mcfg, images),
                              lambda: mobilenet.forward(mparams, mcfg, images)),
        "resnet.predict": (lambda p=resnet.init_params(0, rcfg, device="cpu"): resnet.predict(p, rcfg, images),
                           lambda p=resnet.init_params(0, rcfg, device="cpu"): resnet.forward(p, rcfg, images)),
    }


@pytest.fixture(scope="module")
def jit_cases():
    return _jit_cases()


@pytest.mark.parametrize("name", ["bert.encode_jit", "wav2vec2.ctc_logits_jit", "vit.classify_jit",
                                  "mobilenet.predict", "resnet.predict"])
def test_jit_names_equal_their_forwards(jit_cases, name):
    """Each *_jit / predict name (the JAX package's jitted forwards) is its
    forward under torch.inference_mode(): the same bits, no autograd."""
    jitted, eager = jit_cases[name]
    got, want = jitted(), eager()
    assert got.is_inference() and not want.is_inference()
    assert got.dtype == want.dtype and torch.equal(got, want)
