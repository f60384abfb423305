"""The port's lifting (``rten_tpu_torch.models.lift``, ``generate.
backend_for_model``), the decoders' dense-weight route and the CLI against
the JAX package's, on the CPU.

- Lifted params equal ``params_from_jax`` of the JAX lift's params leaf by
  leaf (GPT-2, OPT, Llama; Whisper from one graph and from two), configs
  field by field.
- The dense route (``decoder.forward`` and ``encoder_decoder.decode`` on
  dense params) against the JAX ``forward`` / ``decode`` on the same dense
  params (its jnp path; one case through its TPU branch with every Pallas
  call interpreted): prefill and decode logits within 1e-5 of the largest
  in f32, relative RMS within 0.05 in bf16, greedy tokens equal.
- ``backend_for_model`` returns the JAX package's backend type on every
  graph, with two intended differences: an untied GPT-2 head is lifted
  onto ``params["lm_head"]`` (the lifted logits equal the graph's, where the
  JAX lift's do not), and an int8 graph after the optimizer's sweep falls
  back to ``GraphBackend`` (the JAX lift raises KeyError).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rten_tpu.generate import generator as jgen
from rten_tpu.graph import Graph as JGraph
from rten_tpu.models import decoder as jdec
from rten_tpu.models import encoder_decoder as jed
from rten_tpu.models import lift as jlift
from rten_tpu.optimize.quantize import quantize_graph_int8
from rten_tpu.runtime.session import Model as JModel
from rten_tpu.runtime.session import ModelOptions as JModelOptions
from rten_tpu_torch import cli
from rten_tpu_torch.format import save_rten
from rten_tpu_torch.generate import Generator, GeneratorConfig, GraphBackend, NativeBackend, backend_for_model
from rten_tpu_torch.graph import Graph
from rten_tpu_torch.models import decoder as tdec
from rten_tpu_torch.models import encoder_decoder as ted
from rten_tpu_torch.models import lift
from rten_tpu_torch.models.gpt2_graph import Gpt2GraphConfig, build_gpt2_graph
from rten_tpu_torch.runtime.session import Model, ModelOptions
from test_graph_backend import build_decoder_graph
from test_lift import _gpt2_state, _graph_from_state, _opt_state, _whisper_state
from torch_port_helpers import (
    configs, dense_tree, ed_configs, ed_tree, host, jax_cast, llama_configs, llama_tree, patch_jax_fused,
    port_graph, to_jax, to_numpy,
)

GRAPH_CFG = Gpt2GraphConfig(vocab_size=300, n_positions=64, d_model=128, n_layers=2, n_heads=2, d_ff=256)
CFG_FIELDS = ("vocab_size", "n_layers", "n_heads", "n_kv_heads", "d_model", "d_ff", "max_seq", "pos_encoding",
              "pos_offset", "norm", "activation")


def _llama_state(rng, n_layers=2, d=64, kv=32, ff=96, vocab=96):
    """A Llama-named HF state ([out, in] nn.Linear weights, an untied head)."""
    def w(*shape):
        return (rng.standard_normal(shape) * 0.1).astype(np.float32)

    st = {"model.embed_tokens.weight": w(vocab, d), "model.norm.weight": 1 + w(d), "lm_head.weight": w(vocab, d)}
    for i in range(n_layers):
        p = f"model.layers.{i}."
        st.update({p + "input_layernorm.weight": 1 + w(d), p + "post_attention_layernorm.weight": 1 + w(d),
                   p + "self_attn.q_proj.weight": w(d, d), p + "self_attn.k_proj.weight": w(kv, d),
                   p + "self_attn.v_proj.weight": w(kv, d), p + "self_attn.o_proj.weight": w(d, d),
                   p + "mlp.gate_proj.weight": w(ff, d), p + "mlp.up_proj.weight": w(ff, d),
                   p + "mlp.down_proj.weight": w(d, ff)})
    return st


def assert_trees_equal(got, want, path="params"):
    """Two port params trees hold the same keys and equal tensors."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(set(got) ^ set(want)))
        for k in want:
            assert_trees_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_trees_equal(g, w, f"{path}[{i}]")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, (path, got.dtype, want.dtype)
        assert torch.equal(got, want), path


def both_graphs(state, n_heads, d):
    jg = _graph_from_state(state, n_heads=n_heads, d=d)
    return jg, port_graph(jg)


@pytest.mark.parametrize("family", ["gpt2", "opt", "llama"])
def test_lift_decoder_equals_jax_lift(family, rng):
    state = {"gpt2": _gpt2_state, "opt": _opt_state, "llama": _llama_state}[family](rng)
    jg, tg = both_graphs(state, n_heads=4, d=64)
    jcfg, jparams = jlift.lift_decoder(jg)
    cfg, params = lift.lift_decoder(tg, device="cpu")
    assert all(getattr(cfg, f) == getattr(jcfg, f) for f in CFG_FIELDS), (cfg, jcfg)
    assert cfg.tie_embeddings == jcfg.tie_embeddings and cfg.dtype == torch.float32
    assert_trees_equal(params, tdec.params_from_jax(to_numpy(jparams), cfg, device="cpu"))
    assert lift.infer_n_heads(tg, 64) == jlift.infer_n_heads(jg, 64) == 4


@pytest.mark.parametrize("split", [False, True])
def test_lift_encoder_decoder_equals_jax_lift(split, rng):
    state = _whisper_state(rng)
    if split:
        args = ({k: v for k, v in state.items() if "encoder" in k}, {k: v for k, v in state.items() if "decoder" in k})
        kw = dict(n_heads=2)
    else:
        jg = JGraph()
        for name, arr in state.items():
            jg.add_constant(name, arr)
        jg.add_constant("reshape_shape", np.asarray([0, -1, 2, 16], np.int64))
        args, kw = (jg,), {}
    jcfg, jparams = jlift.lift_encoder_decoder(*args, **kw)
    cfg, params = lift.lift_encoder_decoder(*[port_graph(a) if isinstance(a, JGraph) else a for a in args],
                                            device="cpu", **kw)
    assert all(getattr(cfg, f.name) == getattr(jcfg, f.name) for f in dataclasses.fields(cfg) if f.name != "dtype")
    assert_trees_equal(params, ted.params_from_jax(to_numpy(jparams), cfg, device="cpu"))


def test_lift_errors():
    with pytest.raises(lift.LiftError, match="naming"):
        lift.lift_decoder({"something.weight": np.zeros((4, 4), np.float32)}, device="cpu")
    state = _gpt2_state(np.random.default_rng(0))
    with pytest.raises(lift.LiftError, match="n_heads"):
        lift.lift_decoder(state, device="cpu")
    del state["transformer.h.1.mlp.c_proj.weight"]
    with pytest.raises(lift.LiftError, match="missing weight"):
        lift.lift_decoder(state, n_heads=4, device="cpu")
    with pytest.raises(lift.LiftError):
        lift.lift_encoder_decoder({"not_whisper.weight": np.zeros((2, 2), np.float32)}, device="cpu")


def _decode_pair(jparams, jcfg, params, cfg, ids, n_steps, use_flash=False):
    """(JAX logits, port logits) of a prompt ``ids`` [B, T] into a cache,
    then ``n_steps`` greedy decode steps, each step's tokens the JAX
    stream's (fed to both). The JAX jnp path runs jitted, through a wrapper
    of its own (no trace shared with another test); its TPU branch
    (``use_flash``, under ``patch_jax_fused``) eagerly."""
    b = ids.shape[0]
    forward = lambda p, t, c: jdec.forward(p, jcfg, t, c, use_flash=use_flash)  # noqa: E731
    jforward = forward if use_flash else jax.jit(forward)
    jcache, cache = jdec.init_cache(jcfg, b, 64), tdec.init_cache(cfg, b, 64, device="cpu")
    jl, jcache = jforward(jparams, jnp.asarray(ids), jcache)
    tl, cache = tdec.forward(params, cfg, torch.from_numpy(ids), cache)
    jout, tout = [np.asarray(jl, np.float32)[:, -1]], [host(tl)[:, -1]]
    for _ in range(n_steps):
        tok = jout[-1].argmax(-1).astype(np.int32)[:, None]
        jl, jcache = jforward(jparams, jnp.asarray(tok), jcache)
        tl, cache = tdec.forward(params, cfg, torch.from_numpy(tok), cache)
        jout.append(np.asarray(jl, np.float32)[:, -1])
        tout.append(host(tl)[:, -1])
    np.testing.assert_allclose(host(tdec.forward(params, cfg, torch.from_numpy(ids), None)[0])[:, -1], tout[0],
                               rtol=0, atol=1e-5 * np.abs(tout[0]).max())  # the cacheless forward
    return np.stack(jout), np.stack(tout)


@pytest.mark.parametrize("family,dtype", [("gpt2", "f32"), ("gpt2", "bf16"), ("llama", "f32")])
def test_dense_route_matches_jax(family, dtype):
    jcfg, cfg = configs() if family == "gpt2" else llama_configs()
    tree = dense_tree(0) if family == "gpt2" else llama_tree(0)
    jparams = to_jax(tree)
    if dtype == "bf16":
        jcfg, cfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16), dataclasses.replace(cfg, dtype=torch.bfloat16)
        jparams = jax_cast(jparams, jnp.bfloat16)
    params = tdec.params_from_jax(tree, cfg, device="cpu")
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    want, got = _decode_pair(jparams, jcfg, params, cfg, ids, 3)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    else:
        assert np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2)) < 0.05
        top2 = np.sort(want, -1)[..., -2:]
        clear = top2[..., 1] - top2[..., 0] > 0.05 * np.abs(want).max()
        np.testing.assert_array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])
    tok = torch.from_numpy(ids[:, -1:])  # generate_scan on the dense route equals its forwards
    cache = tdec.init_cache(cfg, 2, 64, device="cpu")
    tdec.prefill(params, cfg, torch.from_numpy(ids), cache)
    scan, _ = tdec.generate_scan(params, cfg, cache, tok, n_steps=3)
    cache = tdec.init_cache(cfg, 2, 64, device="cpu")
    tdec.prefill(params, cfg, torch.from_numpy(ids), cache)
    steps = []
    for _ in range(3):
        tok, cache = tdec.forward(params, cfg, tok, cache, lm_head_mode="argmax")
        steps.append(tok)
    assert torch.equal(scan, torch.cat(steps, 1))


def test_dense_route_matches_jax_kernels_interpreted(monkeypatch):
    """The JAX package's TPU branch on dense params (``dispatch.on_tpu``
    forced, every Pallas call interpreted): ``decode_attention`` without
    its wo a step, causal ``flash_attention`` for the prompt."""
    patch_jax_fused(monkeypatch)
    jcfg, cfg = configs()
    tree = dense_tree(0)
    ids = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 5)).astype(np.int32)
    want, got = _decode_pair(to_jax(tree), jcfg, tdec.params_from_jax(tree, cfg, device="cpu"), cfg, ids, 1,
                             use_flash=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_dense_encoder_decoder_matches_jax():
    jcfg, cfg = ed_configs()
    tree = ed_tree(0)
    jparams, params = to_jax(tree), ted.params_from_jax(tree, cfg, device="cpu")
    mel = np.random.default_rng(3).standard_normal((1, 16, 64)).astype(np.float32)
    jdecode = jax.jit(lambda p, t, s: jed.decode(p, jcfg, t, s, use_flash=False))  # a trace of its own
    jenc = jax.jit(lambda p, m: jed.encode(p, jcfg, m))(jparams, jnp.asarray(mel))
    enc = ted.encode(params, cfg, torch.from_numpy(mel))
    np.testing.assert_allclose(host(enc), np.asarray(jenc), rtol=0, atol=1e-5 * np.abs(np.asarray(jenc)).max())
    jstate, state = jed.init_decoder_state(jparams, jcfg, jenc), ted.init_decoder_state(params, cfg, enc)
    tok = np.array([[1, 2, 3, 4]], np.int32)
    for _ in range(3):  # the prompt, then two greedy steps
        jl, jstate = jdecode(jparams, jnp.asarray(tok), jstate)
        tl, state = ted.decode(params, cfg, torch.from_numpy(tok), state)
        want = np.asarray(jl)
        np.testing.assert_allclose(host(tl), want, rtol=0, atol=1e-5 * np.abs(want).max())
        tok = want[:, -1:].argmax(-1).astype(np.int32)
        assert np.array_equal(host(tl)[:, -1:].argmax(-1), tok)


def _gpt2_file(tied=True, quantize=False):
    g = build_gpt2_graph(JGraph, GRAPH_CFG, seed=0, tied=tied)
    if quantize:
        g, _ = quantize_graph_int8(g)
    return save_rten(port_graph(g))


def _whisper_graph(rng):
    g = JGraph()
    for name, arr in _whisper_state(rng).items():
        g.add_constant(name, arr)
    return g


BACKEND_CASES = {
    "gpt2_heads_given": (dict(), dict(n_heads=2), "NativeBackend"),
    "gpt2_heads_not_inferable": (dict(), dict(), "GraphBackend"),
    "int8_unoptimized": (dict(quantize=True, opt=False), dict(n_heads=2), "NativeBackend"),
    "int8_swept": (dict(quantize=True), dict(n_heads=2), "GraphBackend"),
    "opt": ("opt", dict(), "NativeBackend"),
    "llama": ("llama", dict(), "NativeBackend"),
    "whisper": ("whisper", dict(n_heads=2), "EncDecBackendFactory"),
    "graph_decoder": ("graph", dict(), "GraphBackend"),
}


@pytest.mark.parametrize("case", BACKEND_CASES)
def test_backend_for_model_picks_jax_type(case, rng):
    spec, kw, want = BACKEND_CASES[case]
    if isinstance(spec, dict):  # a GPT-2 file, loaded by both packages
        data = _gpt2_file(quantize=spec.get("quantize", False))
        opt = spec.get("opt", True)
        jmodel = JModel.load(data, JModelOptions(enable_optimization=opt))
        tmodel = Model.load(data, ModelOptions(enable_optimization=opt), device="cpu")
    else:
        jg = {"opt": lambda: _graph_from_state(_opt_state(rng), 4, 64),
              "llama": lambda: _graph_from_state(_llama_state(rng), 4, 64),
              "whisper": lambda: _whisper_graph(rng), "graph": lambda: build_decoder_graph(rng)}[spec]()
        jmodel, tmodel = jg, port_graph(jg)
        if spec == "graph":
            jmodel, tmodel = JModel(jg), Model(tmodel, device="cpu")
    got = backend_for_model(tmodel, device="cpu", **kw)
    assert type(got).__name__ == want
    if case == "int8_swept":  # the reference's lift raises KeyError on the swept int8 graph
        with pytest.raises(KeyError):
            jgen.backend_for_model(jmodel, **kw)
        assert any(op.op_type == "QuantMatMul" for _, op in got.model.graph.operator_nodes())
    else:
        assert type(jgen.backend_for_model(jmodel, **kw)).__name__ == want
    if want == "NativeBackend":
        out = got.prefill(np.arange(1, 6, dtype=np.int32)[None])
        assert out.shape == (1, got.cfg.vocab_size) and torch.isfinite(out).all()


def test_untied_head_is_lifted_onto_lm_head():
    """An untied GPT-2 graph: the port's lift carries ``lm_head`` and its
    NativeBackend's logits equal the graph's own through GraphBackend; the
    JAX lift ties the head to ``wte`` and its logits differ."""
    data = _gpt2_file(tied=False)
    model = Model.load(data, device="cpu")
    native = backend_for_model(model, n_heads=2, device="cpu")
    assert isinstance(native, NativeBackend) and "lm_head" in native.params and not native.cfg.tie_embeddings
    graph = GraphBackend(model)
    prompt = np.arange(3, 11, dtype=np.int32)[None]
    first = want = host(graph.prefill(prompt))
    np.testing.assert_allclose(host(native.prefill(prompt)), want, rtol=0, atol=1e-5 * np.abs(want).max())
    for tok in (7, 11):
        want = host(graph.decode(np.asarray([[tok]], np.int32)))
        np.testing.assert_allclose(host(native.decode(np.asarray([[tok]], np.int32))), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    jnative = jgen.backend_for_model(JModel.load(data), n_heads=2)
    jlogits = np.asarray(jnative.prefill(prompt), np.float32)
    assert np.abs(jlogits - first).max() > 0.1 * np.abs(first).max()


def test_lifted_generator_equals_graph_backend_stream():
    data = _gpt2_file(tied=True)
    model = Model.load(data, device="cpu")
    prompt = np.arange(5, 13, dtype=np.int32)
    native = [int(t[0]) for t in Generator(backend_for_model(model, n_heads=2, device="cpu"),
                                           GeneratorConfig(max_tokens=5)).with_prompt(prompt)]
    graph = [int(t[0]) for t in Generator(GraphBackend(model), GeneratorConfig(max_tokens=5)).with_prompt(prompt)]
    assert native == graph


@pytest.mark.parametrize("flags", [["-n", "2"], ["--mode", "interpret", "-t", "--mmap"]], ids=["compile", "interpret"])
def test_cli_on_a_gpt2_file(flags, tmp_path, capsys):
    path = tmp_path / "gpt2.rten"
    path.write_bytes(_gpt2_file())
    assert cli.main([str(path), *flags, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "output 'logits': shape [1, 1, 300]" in out and "latency:" in out and "mode=" in out
