"""The port's ``GraphBackend`` against the JAX package's: twins of
``tests/test_graph_backend.py`` on the CPU, plus a GPT-2-shaped graph in
int8.

Graphs come from that file's own graph functions (copied into port graphs before
either package runs them). In each twin the port's greedy tokens equal the
JAX package's and the last step's logits are within 1e-3 (BASELINE's
bars); the port's compiled bucketed path also equals its own legacy
exact-shape interpret path token for token.
"""

import warnings

import numpy as np
import pytest

from rten_tpu.generate import Generator as JGenerator
from rten_tpu.generate import GeneratorConfig as JGeneratorConfig
from rten_tpu.generate.generator import GraphBackend as JGraphBackend
from rten_tpu.graph import Graph as JGraph
from rten_tpu.runtime.session import Model as JModel
from rten_tpu.runtime.session import ModelOptions as JModelOptions
from rten_tpu_torch.generate import Generator, GeneratorConfig, GraphBackend
from rten_tpu_torch.graph import Graph
from rten_tpu_torch.models.gpt2_graph import Gpt2GraphConfig, build_gpt2_graph
from rten_tpu_torch.runtime.session import Model, ModelOptions
from test_graph_backend import (
    D,
    ENC_N,
    V,
    build_decoder_graph,
    build_decoder_graph_no_posids,
    build_encdec_decoder_graph,
    build_merged_decoder_graph,
    build_merged_encdec_graph,
)
from torch_port_helpers import host, port_graph

NO_OPT = dict(enable_optimization=False)


def models(jgraph, **opts):
    """(JAX model, port model on the CPU) of one JAX-package graph."""
    tgraph = port_graph(jgraph)
    return JModel(jgraph, options=JModelOptions(**opts)), Model(tgraph, options=ModelOptions(**opts), device="cpu")


def stream(backend, prompt, n):
    """n greedy tokens after ``prompt`` through ``backend.prefill`` /
    ``decode`` (either package's), and the last step's logits [V]."""
    logits = backend.prefill(np.asarray([prompt], np.int32))
    tokens = []
    for i in range(n):
        last = host(logits)[0]
        tokens.append(int(last.argmax()))
        if i + 1 < n:
            logits = backend.decode(np.asarray([[tokens[-1]]], np.int32))
    return tokens, last


def assert_matches(got, want):
    (gt, gl), (wt, wl) = got, want
    assert gt == wt
    np.testing.assert_allclose(gl, wl, rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def decoder_models():
    return models(build_decoder_graph(np.random.default_rng(0)), **NO_OPT)


def test_backend_auto_selects_compiled(decoder_models):
    _, tm = decoder_models
    assert GraphBackend(tm).mode == "compiled"


@pytest.mark.parametrize("prompt, n", [([3, 7, 1, 9], 12), ([5, 2], 40)], ids=["short", "bucket_growth"])
def test_compiled_matches_legacy_and_jax(decoder_models, prompt, n):
    jm, tm = decoder_models
    got = stream(GraphBackend(tm), prompt, n)
    assert got[0] == stream(GraphBackend(tm, mode="interpret"), prompt, n)[0]
    assert_matches(got, stream(JGraphBackend(jm), prompt, n))


def test_compiled_entries_are_per_bucket():
    _, tm = models(build_decoder_graph(np.random.default_rng(0)), **NO_OPT)
    stream(GraphBackend(tm), [5, 2], 40)
    # prefill (bucket 32) + decode at bucket 32 + decode at bucket 64
    assert len(tm._compiled) == 3
    be = GraphBackend(tm)
    stream(be, [5, 2], 40)  # another backend: on the CPU nothing is keyed on its buffers
    be.reset()
    stream(be, [4, 4], 40)
    assert len(tm._compiled) == 3


def test_multi_turn_append_prompt(decoder_models):
    jm, tm = decoder_models

    def turns(gen_cls, cfg_cls, backend):
        gen = gen_cls(backend, cfg_cls(max_tokens=4)).with_prompt([3, 7])
        first = [int(t[0]) for t in gen]
        gen.append_prompt([11, 4])
        gen.config = cfg_cls(max_tokens=4)
        gen._emitted = 0
        return first, [int(t[0]) for t in gen]

    got = turns(Generator, GeneratorConfig, GraphBackend(tm))
    assert got == turns(Generator, GeneratorConfig, GraphBackend(tm, mode="interpret"))
    assert got == turns(JGenerator, JGeneratorConfig, JGraphBackend(jm))


def test_hoisting_matches_jax_and_stays_exact():
    jm, tm = models(build_decoder_graph(np.random.default_rng(1), with_bias_input=True), **NO_OPT)
    bias = np.linspace(-1, 1, V).astype(np.float32)
    be = GraphBackend(tm, constant_inputs={"logit_bias_in": bias})
    got = stream(be, [3, 7, 1], 8)
    assert be._hoisted  # the invariant subgraph was hoisted
    assert {tm.graph.node_name(nid) for nid in be._hoisted} == {"scaled_bias_out"}
    plain = GraphBackend(tm, mode="interpret")
    plain.constant_inputs = {"logit_bias_in": bias}
    plain._hoisted = {}  # no hoist, the input kept
    assert got[0] == stream(plain, [3, 7, 1], 8)[0]
    assert_matches(got, stream(JGraphBackend(jm, constant_inputs={"logit_bias_in": bias}), [3, 7, 1], 8))


def test_no_posids_cumsum_graph_auto_compiles():
    jm, tm = models(build_decoder_graph_no_posids(np.random.default_rng(4)), **NO_OPT)
    be = GraphBackend(tm)
    assert be.mode == "compiled"
    got = stream(be, [3, 7, 1, 9], 40)
    assert got[0] == stream(GraphBackend(tm, mode="interpret"), [3, 7, 1, 9], 40)[0]
    assert_matches(got, stream(JGraphBackend(jm), [3, 7, 1, 9], 40))


def test_kv_shape_positions_stay_interpret_and_warn():
    jm, tm = models(build_decoder_graph_no_posids(np.random.default_rng(4), kv_shape_positions=True), **NO_OPT)
    with pytest.warns(UserWarning, match="EXACT-SHAPE INTERPRET"):
        be = GraphBackend(tm)
    assert be.mode == "interpret"
    with pytest.warns(UserWarning, match="EXACT-SHAPE INTERPRET"):
        assert JGraphBackend(jm).mode == "interpret"


def test_maskless_graph_warns_with_reason():
    rng = np.random.default_rng(5)
    g = JGraph()
    ids = g.add_value("input_ids", ["batch", None])
    pk_in = g.add_value("past_key_values.0.key", ["batch", None, D])
    pv_in = g.add_value("past_key_values.0.value", ["batch", None, D])
    g.inputs = [ids, pk_in, pv_in]
    wte = g.add_constant("wte", rng.standard_normal((V, D)).astype(np.float32))
    wlm = g.add_constant("wlm", rng.standard_normal((D, V)).astype(np.float32))
    emb = g.add_simple_op("Gather", [wte, ids], {"axis": 0}, name="emb")
    pk = g.add_value("present.0.key")
    g.add_operator("concat_k", "Concat", {"axis": 1}, [pk_in, emb], [pk])
    pv = g.add_value("present.0.value")
    g.add_operator("concat_v", "Concat", {"axis": 1}, [pv_in, emb], [pv])
    logits = g.add_value("logits")
    g.add_operator("lm", "MatMul", {}, [emb, wlm], [logits])
    g.outputs = [logits, pk, pv]
    jm, tm = models(g, **NO_OPT)
    with pytest.warns(UserWarning, match="no attention_mask input"):
        be = GraphBackend(tm)
    assert be.mode == "interpret"
    with pytest.raises(ValueError, match="attention_mask"):
        GraphBackend(tm, mode="compiled")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # explicit modes never warn
        GraphBackend(tm, mode="interpret")
        jbe = JGraphBackend(jm, mode="interpret")
    assert_matches(stream(be, [3, 1], 5), stream(jbe, [3, 1], 5))


def test_encdec_decoder_compiled_matches_interpret_and_jax():
    rng = np.random.default_rng(7)
    jm, tm = models(build_encdec_decoder_graph(rng), **NO_OPT)
    enc = rng.standard_normal((1, ENC_N, D)).astype(np.float32) * 0.5
    be = GraphBackend(tm, constant_inputs={"encoder_hidden_states": enc})
    assert be.mode == "compiled"
    got = stream(be, [2, 5, 1], 40)
    assert any("k_enc" in (tm.graph.node_name(nid) or "") for nid in be._hoisted)
    legacy = GraphBackend(tm, mode="interpret", constant_inputs={"encoder_hidden_states": enc})
    assert got[0] == stream(legacy, [2, 5, 1], 40)[0]
    assert_matches(got, stream(JGraphBackend(jm, constant_inputs={"encoder_hidden_states": enc}), [2, 5, 1], 40))


def test_merged_export_static_cache_interpret():
    rng = np.random.default_rng(8)
    jm, tm = models(build_merged_encdec_graph(rng), **NO_OPT)
    enc = rng.standard_normal((1, ENC_N, D)).astype(np.float32) * 0.5
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # maskless → interpret warning, expected
        be = GraphBackend(tm, constant_inputs={"encoder_hidden_states": enc})
        jbe = JGraphBackend(jm, constant_inputs={"encoder_hidden_states": enc})
    assert be.mode == "interpret"
    assert be.static_cache == {"past_key_values.0.encoder.key", "past_key_values.0.encoder.value"}
    assert_matches(stream(be, [3, 1], 8), stream(jbe, [3, 1], 8))
    np.testing.assert_allclose(host(be.cache["past_key_values.0.encoder.key"]),
                               enc @ tm.graph.nodes[tm.node_id("wk2")].value, rtol=1e-5)
    assert be.cache["past_key_values.0.decoder.key"].shape[1] == 2 + 7


def test_merged_decoder_use_cache_branch_compiled():
    jm, tm = models(build_merged_decoder_graph(np.random.default_rng(11)), **NO_OPT)
    be = GraphBackend(tm)
    assert be.mode == "compiled"
    got = stream(be, [3, 1, 4], 10)
    assert got[0] == stream(GraphBackend(tm, mode="interpret"), [3, 1, 4], 10)[0]
    assert_matches(got, stream(JGraphBackend(jm), [3, 1, 4], 10))


GPT2_TINY = Gpt2GraphConfig(vocab_size=500, n_positions=256, d_model=128, n_layers=2, n_heads=2, d_ff=512)


def test_gpt2_graph_int8_matches_jax():
    """The GPT-2-shaped graph (``models.gpt2_graph``) at a tiny width,
    quantized by each package (the same int8 weights), optimized, through
    both GraphBackends: 9 QuantMatMul, 5 LayerNormalization, 2 Gelu."""
    from rten_tpu.optimize.quantize import quantize_graph_int8 as jquantize
    from rten_tpu_torch.optimize.quantize import quantize_graph_int8

    jg, jn = jquantize(build_gpt2_graph(JGraph, GPT2_TINY, seed=0))
    tg, tn = quantize_graph_int8(build_gpt2_graph(Graph, GPT2_TINY, seed=0))
    assert jn == tn == 4 * GPT2_TINY.n_layers + 1
    jm, tm = JModel(jg), Model(tg, device="cpu")
    kinds = [op.op_type for _, op in tm.graph.operator_nodes()]
    assert sorted(kinds) == sorted(op.op_type for _, op in jm.graph.operator_nodes())
    assert (kinds.count("QuantMatMul"), kinds.count("LayerNormalization"), kinds.count("Gelu")) == (9, 5, 2)
    prompt = list(range(3, 40))
    be = GraphBackend(tm)
    assert be.mode == "compiled"
    got = stream(be, prompt, 30)  # crosses the 64 bucket
    assert got[0] == stream(GraphBackend(tm, mode="interpret"), prompt, 30)[0]
    assert_matches(got, stream(JGraphBackend(jm), prompt, 30))
    assert len(tm._compiled) == 3
