"""The port's text apps (rten_tpu_torch.examples: jina_similarity,
qwen2_chat) on the CPU against the JAX package's (examples/) on the same
files: a seeded HF-named BERT .npz with a WordPiece tokenizer over
README's words, and a tiny Qwen2-class .npz (RoPE, GQA 4 / 2, SwiGLU, q/k/v
biases, head dim 64) with a byte-level BPE learned from README. jina's
printed lines equal (numbers within 1e-4 relative / 1e-5 absolute).
qwen2_chat runs 2 turns through Generator.append_prompt, dense and
``--int8``, with TopKSampler pinned to top-1 in both packages (one
candidate: the draw is the argmax whatever the noise, so the packages'
different samplers agree): every printed line, so every turn's tokens,
equal. Also ``infer_llama_config`` against the JAX one."""

import dataclasses

import pytest
from torch_app_helpers import check_port_app, jax_app, jax_runs, port_app, run

import chip_smoke


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return chip_smoke.write_app_files(tmp_path_factory.mktemp("lang_files"), qwen2=chip_smoke.APP_QWEN2)


@pytest.fixture(scope="module")
def jax_lines(files, tmp_path_factory):
    return jax_runs(("jina_similarity",), files, tmp_path_factory.mktemp("lang_jax"))


def test_jina_similarity_matches_jax(files, jax_lines, tmp_path):
    res = check_port_app("jina_similarity", files, jax_lines["jina_similarity"], tmp_path)
    assert res["embeddings"].shape == (6, chip_smoke.APP_BERT["d"])


@pytest.fixture()
def top1(monkeypatch):
    """TopKSampler(k, temperature) made TopKSampler(1, temperature) in both
    packages (each app imports it from its package at run time)."""
    import rten_tpu.generate as jgen
    import rten_tpu_torch.generate as tgen

    for mod in (jgen, tgen):
        cls = mod.TopKSampler
        monkeypatch.setattr(mod, "TopKSampler", lambda k, temperature=1.0, cls=cls: cls(1, temperature))


@pytest.fixture(scope="module")
def jax_qwen2(files):
    """The JAX app's printed lines, dense and --int8, under the top-1 pin."""
    import rten_tpu.generate as jgen

    cls, out = jgen.TopKSampler, {}
    jgen.TopKSampler = lambda k, temperature=1.0: cls(1, temperature)
    try:
        for route, extra in (("dense", []), ("int8", ["--int8"])):
            rc, out[route] = run(jax_app("qwen2_chat").main, [*chip_smoke.app_argv("qwen2_chat", files), *extra])
            assert rc == 0
    finally:
        jgen.TopKSampler = cls
    return out


@pytest.mark.parametrize("route", ["dense", "int8"])
def test_qwen2_chat_turns_match_jax(files, jax_qwen2, top1, route):
    res = {}
    extra = ["--int8"] if route == "int8" else []
    rc, lines = run(port_app("qwen2_chat").main, [*chip_smoke.app_argv("qwen2_chat", files), *extra, "--cpu"], res)
    assert rc == 0
    assert lines == jax_qwen2[route]
    assert [len(t) for t in res["turns"]] == [chip_smoke.APP_TOKENS] * 2 and len(set(res["turns"][1])) > 1


def test_infer_llama_config_matches_jax(files):
    from rten_tpu.models import decoder as jdec
    from rten_tpu_torch.models import decoder

    state = jax_app("common").load_state_npz(files["qwen2"])
    for heads in (None, 2):
        want = dataclasses.asdict(jax_app("qwen2_chat").infer_llama_config(state, jdec, heads))
        got = dataclasses.asdict(port_app("qwen2_chat").infer_llama_config(state, decoder, heads))
        want.pop("dtype"), got.pop("dtype")
        assert {k: got[k] for k in want} == want
