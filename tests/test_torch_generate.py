"""The port's Generator / NativeBackend (on the CPU) against the JAX
package's on the same seeded int8 parameters: the token streams must be
identical through with_prompt, append_prompt, EOS, max_tokens, on_token
and profile."""

import numpy as np
import pytest

from rten_tpu.generate import Generator as JGenerator
from rten_tpu.generate import GeneratorConfig as JGeneratorConfig
from rten_tpu.generate.generator import NativeBackend as JNativeBackend
from rten_tpu.models import decoder as jdec
from rten_tpu_torch.generate import (
    ArgMaxSampler,
    Generator,
    GeneratorConfig,
    Metrics,
    NativeBackend,
)
from rten_tpu_torch.models import decoder as tdec
from torch_port_helpers import configs, dense_tree, to_jax, to_numpy

PROMPT = [11, 42, 7, 300, 5]


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = configs()
    jparams = jdec.quantize_params_int8(to_jax(dense_tree(0)))
    tparams = tdec.params_from_jax(to_numpy(jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _pair(models, max_tokens, eos=()):
    jcfg, tcfg, jparams, tparams = models
    jgen = JGenerator(JNativeBackend(jparams, jcfg, max_len=64),
                      JGeneratorConfig(max_tokens=max_tokens, eos_tokens=eos))
    tgen = Generator(NativeBackend(tparams, tcfg, max_len=64, device="cpu"),
                     GeneratorConfig(max_tokens=max_tokens, eos_tokens=eos))
    return jgen, tgen


def _stream(gen):
    return [int(t[0]) for t in gen]


def test_prompt_stream_and_max_tokens(models):
    jgen, tgen = _pair(models, max_tokens=10)
    seen = []
    metrics = Metrics()
    tgen.with_prompt(PROMPT).on_token(lambda t: seen.append(int(t[0]))).profile(metrics)
    jtoks = _stream(jgen.with_prompt(PROMPT))
    ttoks = _stream(tgen)
    assert len(ttoks) == 10
    assert ttoks == jtoks
    assert seen == ttoks
    assert len(metrics.step_times_s) == 10 and metrics.tokens_per_second() > 0
    assert isinstance(tgen.sampler, ArgMaxSampler)
    assert tgen.backend.length == len(PROMPT) + 9  # the last token is not fed yet


def test_append_prompt(models):
    jgen, tgen = _pair(models, max_tokens=100)
    out = []
    for gen in (jgen, tgen):
        gen.with_prompt(PROMPT)
        first = [int(next(gen)[0]) for _ in range(3)]
        gen.append_prompt([7, 8, 9])
        rest = [int(next(gen)[0]) for _ in range(4)]
        out.append(first + rest)
    assert out[1] == out[0]
    # prompt 5, two fed samples, then [last, 7, 8, 9] together, then 3 more
    assert tgen.backend.length == len(PROMPT) + 2 + 4 + 3
    assert int(tgen.backend.cache["len"][0]) == tgen.backend.length


def test_eos_stops(models):
    _, tgen = _pair(models, max_tokens=50)
    stream = _stream(tgen.with_prompt(PROMPT))
    eos = stream[3]
    jgen, tgen = _pair(models, max_tokens=50, eos=(eos,))
    jtoks = _stream(jgen.with_prompt(PROMPT))
    ttoks = _stream(tgen.with_prompt(PROMPT))
    assert ttoks == jtoks
    assert ttoks[-1] == eos and len(ttoks) == stream.index(eos) + 1


def test_logits_sampler_path_matches_fused_argmax(models):
    """A sampler other than the fused one gets the logits; ArgMax over
    them gives the same stream as the lm_head kernel's argmax."""

    class LogitsArgMax(ArgMaxSampler.__base__):
        def sample(self, rng, logits):
            return ArgMaxSampler().sample(rng, logits)

    _, tgen = _pair(models, max_tokens=6)
    _, tgen2 = _pair(models, max_tokens=6)
    fused = _stream(tgen.with_prompt(PROMPT))
    via_logits = _stream(tgen2.with_prompt(PROMPT).with_sampler(LogitsArgMax()))
    assert via_logits == fused


def test_backend_refuses_overflow(models):
    _, tcfg, _, tparams = models
    backend = NativeBackend(tparams, tcfg, max_len=4, device="cpu")
    with pytest.raises(ValueError, match="KV cache full"):
        backend.prefill(np.array([[1, 2, 3, 4, 5]], np.int32))
