"""The port's speculative decoding (``generate/speculative.py`` and
``Generator.with_draft``, on the CPU) against the JAX package's.

Greedy: ``speculative_scan`` gives the same tokens and per-round counts as
JAX's from the same prefilled caches, for K 1, 2 and 4 and two drafts
unlike the target (its own first layer alone: most drafts accepted; an
independent one-layer model: most rejected); ``speculative_generate`` and
``Generator.with_draft`` give JAX's tokens, which are the target's plain
greedy tokens. Rows diverge, EOS stops a row, ``append_prompt`` mid-stream
rolls the caches back, a tight ``max_len`` stays exact, and a refill
without headroom raises as JAX's does.

Sampled (the cases of ``tests/test_speculative.py:136-231``): the first
token of an accept/reject round is distributed as temperature sampling of
the target alone (2048 rows, vocab 13, total variation < 0.08, and the
draft's own distribution fails that bound); a draft that is the target
accepts every token; temperature 1e-4 is greedy; TopK and TopP are
refused.
"""

import dataclasses
import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.generate import Generator as JGenerator
from rten_tpu.generate import GeneratorConfig as JGeneratorConfig
from rten_tpu.generate import speculative as jspec
from rten_tpu.generate.generator import NativeBackend as JNativeBackend
from rten_tpu.models import decoder as jdec
from rten_tpu_torch.generate import Generator, GeneratorConfig, NativeBackend, speculative
from rten_tpu_torch.generate.sampler import TemperatureSampler, TopKSampler, TopPSampler
from rten_tpu_torch.kernels.quant_matmul import int8_pack, quantize_weights_int8
from rten_tpu_torch.models import decoder as tdec
from torch_port_helpers import configs, dense_tree, to_jax, to_numpy

DRAFTS = ("first_layer", "independent")


def _pair_params(tree, n_layers):
    """(JAX config, port config, JAX int8 params, port params) of ``tree``."""
    jcfg, tcfg = (dataclasses.replace(c, n_layers=n_layers) for c in configs())
    jparams = jdec.quantize_params_int8(to_jax(tree))
    return jcfg, tcfg, jparams, tdec.params_from_jax(to_numpy(jparams), tcfg, device="cpu")


@pytest.fixture(scope="module")
def models():
    """The target (the slice config) and its two drafts of one layer."""
    tree = dense_tree(0)
    other = dense_tree(1)
    return {
        "target": _pair_params(tree, 2),
        "first_layer": _pair_params(dict(tree, layers=tree["layers"][:1]), 1),
        "independent": _pair_params(dict(other, layers=other["layers"][:1]), 1),
    }


def _prompt(seed, b, n=5):
    return np.random.default_rng(seed).integers(0, 500, (b, n)).astype(np.int32)


def _port_greedy(target, prompt, n):
    """The target's plain greedy stream: prefill, then ``generate_scan``."""
    _, tcfg, _, tparams = target
    cache = tdec.init_cache(tcfg, prompt.shape[0], prompt.shape[1] + n + 4, device="cpu")
    first, cache = tdec.prefill(tparams, tcfg, torch.from_numpy(prompt), cache, lm_head_mode="argmax",
                                last_only=True)  # [B, 1]
    rest, _ = tdec.generate_scan(tparams, tcfg, cache, first, n_steps=n - 1)
    return np.concatenate([first.numpy(), rest.numpy()], axis=1)


@pytest.mark.parametrize("draft", DRAFTS)
@pytest.mark.parametrize("k", [1, 2, 4])
def test_speculative_scan_tokens_and_counts_match_jax(models, draft, k):
    jcfg, tcfg, jparams, tparams = models["target"]
    jcfg_d, tcfg_d, jparams_d, tparams_d = models[draft]
    prompt = _prompt(3, 2)
    jc, jcd = jdec.init_cache(jcfg, 2, 64), jdec.init_cache(jcfg_d, 2, 64)
    logits, jc = jdec.prefill(jparams, jcfg, jnp.asarray(prompt), jc)
    _, jcd = jdec.prefill(jparams_d, jcfg_d, jnp.asarray(prompt), jcd)
    last = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
    jtoks, jcounts, jc, _, jlast = jspec.speculative_scan(jparams, jcfg, jc, jparams_d, jcfg_d, jcd, last, k=k,
                                                          n_rounds=5)
    tc, tcd = tdec.init_cache(tcfg, 2, 64, device="cpu"), tdec.init_cache(tcfg_d, 2, 64, device="cpu")
    tdec.prefill(tparams, tcfg, torch.from_numpy(prompt), tc, last_only=True)
    tdec.prefill(tparams_d, tcfg_d, torch.from_numpy(prompt), tcd, last_only=True)
    toks, counts, tc, tcd, tlast = speculative.speculative_scan(
        tparams, tcfg, tc, tparams_d, tcfg_d, tcd, torch.from_numpy(np.asarray(last)), k=k, n_rounds=5)
    np.testing.assert_array_equal(counts, np.asarray(jcounts))
    np.testing.assert_array_equal(toks, np.asarray(jtoks))
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))
    for cache in (tc, tcd):  # device and host lengths equal, and JAX's
        np.testing.assert_array_equal(cache["len"].numpy(), np.asarray(jc["len"]))
        np.testing.assert_array_equal(cache["host_len"], np.asarray(jc["len"]))
    assert ((counts >= 1) & (counts <= k + 1)).all()


@pytest.mark.parametrize("draft", DRAFTS)
@pytest.mark.parametrize("k", [1, 2, 4])
def test_speculative_generate_matches_jax_and_greedy(models, draft, k):
    """Three rows that accept at different rates: each equals JAX's and the
    target's own greedy stream."""
    jcfg, tcfg, jparams, tparams = models["target"]
    jcfg_d, tcfg_d, jparams_d, tparams_d = models[draft]
    prompt, n = _prompt(4, 3), 20
    want = jspec.speculative_generate(jparams, jcfg, jparams_d, jcfg_d, prompt, k=k, max_new_tokens=n,
                                      rounds_per_call=3)
    got = speculative.speculative_generate(tparams, tcfg, tparams_d, tcfg_d, prompt, k=k, max_new_tokens=n,
                                           rounds_per_call=3, device="cpu")
    assert got == want
    np.testing.assert_array_equal(np.asarray(got), _port_greedy(models["target"], prompt, n))


def test_speculative_eos_stops_row(models):
    _, tcfg, _, tparams = models["target"]
    _, tcfg_d, _, tparams_d = models["first_layer"]
    prompt = _prompt(5, 2)
    ref = _port_greedy(models["target"], prompt, 24)
    eos = int(ref[0, 6])
    stops = [next((i for i in range(24) if ref[r, i] == eos), 23) for r in range(2)]
    got = speculative.speculative_generate(tparams, tcfg, tparams_d, tcfg_d, prompt, k=3, max_new_tokens=24,
                                           eos_token=eos, device="cpu")
    for r in range(2):
        assert got[r] == list(ref[r, : stops[r] + 1])
    assert got[0][-1] == eos


def _backends(models, draft, batch=1, max_len=128):
    _, tcfg, _, tparams = models["target"]
    _, tcfg_d, _, tparams_d = models[draft]
    return (NativeBackend(tparams, tcfg, batch=batch, max_len=max_len, device="cpu"),
            NativeBackend(tparams_d, tcfg_d, batch=batch, max_len=max_len, device="cpu"))


def _jax_backends(models, draft, batch=1, max_len=128):
    jcfg, _, jparams, _ = models["target"]
    jcfg_d, _, jparams_d, _ = models[draft]
    return (JNativeBackend(jparams, jcfg, batch=batch, max_len=max_len),
            JNativeBackend(jparams_d, jcfg_d, batch=batch, max_len=max_len))


def _take(gen, n):
    return [t.tolist() for t in itertools.islice(gen, n)]


@pytest.mark.parametrize("draft", DRAFTS)
def test_with_draft_matches_jax_and_plain(models, draft):
    prompt = [5, 17, 3, 42]
    bk, dk = _backends(models, draft)
    got = _take(Generator(bk).with_prompt(prompt).with_draft(dk, k=3, rounds_per_call=2), 20)
    jbk, jdk = _jax_backends(models, draft)
    want = _take(JGenerator(jbk).with_prompt(prompt).with_draft(jdk, k=3, rounds_per_call=2), 20)
    plain = _take(Generator(_backends(models, draft)[0]).with_prompt(prompt), 20)
    assert got == want == plain


def test_with_draft_append_prompt_mid_stream(models):
    """Big rounds leave tokens buffered at the append: the caches roll back
    and the continuation equals the plain two-turn conversation (and JAX's
    speculative one)."""
    first_turn, second_turn = [5, 17, 3], [8, 2]
    results = []
    for make in (lambda g: g, lambda g: g.with_draft(_backends(models, "first_layer")[1], k=4, rounds_per_call=3)):
        gen = make(Generator(_backends(models, "first_layer")[0]).with_prompt(first_turn))
        out = _take(gen, 6)
        gen.append_prompt(second_turn)
        results.append(out + _take(gen, 8))
    jbk, jdk = _jax_backends(models, "first_layer")
    jgen = JGenerator(jbk).with_prompt(first_turn).with_draft(jdk, k=4, rounds_per_call=3)
    jout = _take(jgen, 6)
    jgen.append_prompt(second_turn)
    results.append(jout + _take(jgen, 8))
    assert results[1] == results[0] == results[2]


def test_with_draft_batch_and_eos(models):
    prompt = _prompt(6, 2, 3)
    plain = np.stack(_take(Generator(_backends(models, "independent", batch=2)[0]).with_prompt(prompt), 10), 1)
    bk, dk = _backends(models, "independent", batch=2)
    got = np.stack(_take(Generator(bk, GeneratorConfig(max_tokens=10)).with_prompt(prompt)
                         .with_draft(dk, k=2, rounds_per_call=2), 20), 1)
    np.testing.assert_array_equal(got, plain)
    eos = int(plain[0, 4])  # stops when every row emits it (the Generator's EOS rule), at batch 1
    bk, dk = _backends(models, "independent")
    stream = [t[0] for t in _take(Generator(bk, GeneratorConfig(max_tokens=30, eos_tokens=(eos,)))
                                  .with_prompt(prompt[:1]).with_draft(dk, k=2), 40)]
    assert stream == plain[0, : plain[0].tolist().index(eos) + 1].tolist()


def test_with_draft_tight_max_len_stays_exact_or_raises(models):
    """Backends sized for plain decoding (prompt + max_tokens) grow at the
    first prompt and stay exact. A follow-up prompt that fits the cache
    but leaves a refill short of rounds·(k+1) + k+2 positions raises at
    the refill, in both packages."""
    prompt, n = [5, 17, 3, 42], 20
    plain = _take(Generator(_backends(models, "first_layer")[0]).with_prompt(prompt), n)
    tight = len(prompt) + n
    bk, dk = _backends(models, "first_layer", max_len=tight)
    gen = Generator(bk, GeneratorConfig(max_tokens=n)).with_prompt(prompt).with_draft(dk, k=3, rounds_per_call=2)
    assert _take(gen, n) == plain
    assert bk.max_len == dk.max_len == len(prompt) + n + 2 * 4 + 3 + 2

    bk, dk = _backends(models, "first_layer", max_len=tight)
    jbk, jdk = _jax_backends(models, "first_layer", max_len=tight)
    for gen in (Generator(bk, GeneratorConfig(max_tokens=n)).with_prompt(prompt).with_draft(dk, k=3,
                                                                                             rounds_per_call=2),
                JGenerator(jbk, JGeneratorConfig(max_tokens=n)).with_prompt(prompt).with_draft(jdk, k=3,
                                                                                               rounds_per_call=2)):
        _take(gen, 3)
        gen.append_prompt(list(range(1, 21)))  # the cache then holds 27 of its 37 positions
        _take(gen, 1)
        with pytest.raises(ValueError, match="headroom"):
            _take(gen, 1)


# ---------------------------------------------------------------------------
# Speculative sampling
# ---------------------------------------------------------------------------


def _vocab13(seed, n_layers):
    """A port model of vocab 13 at the slice widths from ``init_params``
    (normal 0.02 weights: logits spread enough that temperature 0.3 draws
    several tokens). Its tied lm_head, too small for
    ``quantize_params_int8`` to pack, is packed here with N padded to 128."""
    cfg = dataclasses.replace(configs()[1], vocab_size=13, n_layers=n_layers)
    dense = tdec.init_params(seed, cfg, device="cpu")
    params = tdec.quantize_params_int8(dense, device="cpu")
    head = np.pad(dense["tok_emb"].numpy().T, ((0, 0), (0, 128 - 13)))
    params["lm_head_q"] = dict(int8_pack(*quantize_weights_int8(head, axis=-1), device="cpu"), tiled=False)
    return cfg, params


def test_sample_marginal_matches_target_distribution():
    """2048 copies of one prompt, one round of K 3 against an independent
    draft: the first emitted token's histogram is within total variation
    0.08 of the target's softmax at temperature 0.3, which the draft's own
    distribution is not (the test has power)."""
    vocab, b, temp = 13, 2048, 0.3
    cfg_t, params_t = _vocab13(0, 2)
    cfg_d, params_d = _vocab13(1, 1)
    prompt = torch.tensor([[5, 12, 3, 8]], dtype=torch.int32).repeat(b, 1)

    def prefilled():
        ct, cd = tdec.init_cache(cfg_t, b, 32, device="cpu"), tdec.init_cache(cfg_d, b, 32, device="cpu")
        logits, ct = tdec.prefill(params_t, cfg_t, prompt, ct, last_only=True)
        _, cd = tdec.prefill(params_d, cfg_d, prompt, cd, last_only=True)
        return ct, cd, logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)

    # The analytic marginals after [prompt, last] (one row: all are alike).
    ct, cd, last = prefilled()
    lg, _ = tdec.prefill(params_t, cfg_t, torch.cat([prompt[:1], last[:1]], 1),
                         tdec.init_cache(cfg_t, 1, 32, device="cpu"), last_only=True)
    p_ref = torch.softmax(lg[0, -1] / temp, -1).numpy()
    lg_d, _ = tdec.prefill(params_d, cfg_d, torch.cat([prompt[:1], last[:1]], 1),
                           tdec.init_cache(cfg_d, 1, 32, device="cpu"), last_only=True)
    q_ref = torch.softmax(lg_d[0, -1] / temp, -1).numpy()

    toks, counts, *_ = speculative.speculative_sample_scan(params_t, cfg_t, ct, params_d, cfg_d, cd, last,
                                                           torch.Generator().manual_seed(42), temp, k=3, n_rounds=1)
    hist = np.bincount(toks[0, :, 0], minlength=vocab) / b
    assert 0.5 * np.abs(hist - p_ref).sum() < 0.08, (hist, p_ref)
    assert 0.5 * np.abs(q_ref - p_ref).sum() > 0.2
    assert counts.shape == (1, b) and ((counts >= 1) & (counts <= 4)).all()


def test_sample_full_acceptance_when_draft_is_target(models):
    _, tcfg, _, tparams = models["target"]
    k, prompt = 3, _prompt(8, 2)
    ct, cd = tdec.init_cache(tcfg, 2, 64, device="cpu"), tdec.init_cache(tcfg, 2, 64, device="cpu")
    logits, ct = tdec.prefill(tparams, tcfg, torch.from_numpy(prompt), ct, last_only=True)
    tdec.prefill(tparams, tcfg, torch.from_numpy(prompt), cd, last_only=True)
    last = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    _, counts, ct, cd, _ = speculative.speculative_sample_scan(tparams, tcfg, ct, tparams, tcfg, cd, last,
                                                               torch.Generator().manual_seed(0), 0.8, k=k,
                                                               n_rounds=3)
    assert (counts == k + 1).all(), counts
    assert torch.equal(ct["len"], cd["len"]) and ct["len"].tolist() == [5 + 3 * (k + 1)] * 2
    assert ct["host_len"].tolist() == cd["host_len"].tolist() == ct["len"].tolist()


def test_sample_near_zero_temperature_is_greedy(models):
    _, tcfg, _, tparams = models["target"]
    _, tcfg_d, _, tparams_d = models["independent"]
    prompt, n = _prompt(9, 2, 3), 16
    got = speculative.speculative_sample_generate(tparams, tcfg, tparams_d, tcfg_d, prompt,
                                                  rng=torch.Generator().manual_seed(7), k=3, max_new_tokens=n,
                                                  temperature=1e-4, rounds_per_call=3, device="cpu")
    np.testing.assert_array_equal(np.asarray(got), _port_greedy(models["target"], prompt, n))
    bk, dk = _backends(models, "first_layer")
    gen = Generator(bk).with_prompt(prompt[0]).with_sampler(TemperatureSampler(1e-4)).with_draft(dk, k=3)
    assert [t[0] for t in _take(gen, n)] == _port_greedy(models["target"], prompt[:1], n)[0].tolist()


def test_sample_generate_eos_and_shapes(models):
    _, tcfg, _, tparams = models["target"]
    _, tcfg_d, _, tparams_d = models["independent"]
    out = speculative.speculative_sample_generate(tparams, tcfg, tparams_d, tcfg_d, _prompt(10, 2, 2),
                                                  rng=torch.Generator().manual_seed(0), k=2, max_new_tokens=12,
                                                  temperature=1.0, eos_token=7, device="cpu")
    for row in out:
        assert 1 <= len(row) <= 12
        if 7 in row:
            assert row[-1] == 7 and row.count(7) == 1


@pytest.mark.parametrize("sampler", [TopKSampler(5), TopPSampler(0.9)], ids=["topk", "topp"])
def test_with_draft_refuses_other_samplers(models, sampler):
    bk, dk = _backends(models, "first_layer")
    gen = Generator(bk).with_prompt([1, 2]).with_draft(dk, k=2).with_sampler(sampler)
    with pytest.raises(ValueError, match="speculative"):
        _take(gen, 4)
    with pytest.raises(TypeError, match="NativeBackend"):
        Generator(types.SimpleNamespace(device=torch.device("cpu"))).with_draft(dk)  # a backend, not native
    with pytest.raises(ValueError, match="batch"):
        Generator(bk).with_draft(_backends(models, "first_layer", batch=2)[1])
