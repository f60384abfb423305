"""Shared set-up of the ``test_torch_*`` tests: one tiny GPT-2-class
configuration for both packages, seeded dense parameters built once in
numpy and handed to both, and the conversions of KV caches, scales and
pages between the JAX package's TPU layouts and the port's logical ones.

At d_model 256, d_ff 1024 and vocab 500 every projection has ≥ 2^16
elements, so the JAX package's ``quantize_params_int8`` turns each into an
int8 pack and the int8 decode path is what the tests compare.
"""

import jax.numpy as jnp
import numpy as np
import torch

from rten_tpu.kernels.decode_attention import unpack_kv_scales
from rten_tpu.models import decoder as jdec
from rten_tpu_torch.models import decoder as tdec

SLICE_CFG = dict(vocab_size=500, n_layers=2, n_heads=4, d_model=256, d_ff=1024, max_seq=256)


def configs(**kw):
    """(JAX config, port config) of the slice tests, in f32, ``kw``
    replacing fields of ``SLICE_CFG``."""
    c = {**SLICE_CFG, **kw}
    return (
        jdec.DecoderConfig(**c, dtype=jnp.float32),
        tdec.DecoderConfig(**c, dtype=torch.float32),
    )


def dense_tree(seed: int = 0, **kw) -> dict:
    """Dense params as numpy arrays in the JAX package's tree layout, with
    random biases and norm parameters (the packages' own inits make them
    zeros and ones, which would leave those paths untested) and weights
    large enough that greedy decoding has clear winners; ``kw`` replaces
    fields of ``SLICE_CFG``."""
    rng = np.random.default_rng(seed)
    c = {**SLICE_CFG, **kw}
    d, ff, v = c["d_model"], c["d_ff"], c["vocab_size"]

    def w(*shape, scale=0.08):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def norm():
        return {"scale": rng.uniform(0.8, 1.2, d).astype(np.float32), "bias": w(d, scale=0.05)}

    tree = {
        "tok_emb": w(v, d, scale=0.5),
        "pos_emb": w(c["max_seq"], d, scale=0.2),
        "final_norm": norm(),
        "layers": [],
    }
    for _ in range(c["n_layers"]):
        tree["layers"].append(
            {
                "ln1": norm(), "ln2": norm(),
                "wq": w(d, d), "wk": w(d, d), "wv": w(d, d), "wo": w(d, d),
                "bq": w(d, scale=0.05), "bk": w(d, scale=0.05), "bv": w(d, scale=0.05),
                "bo": w(d, scale=0.05),
                "w_up": w(d, ff), "b_up": w(ff, scale=0.05),
                "w_down": w(ff, d, scale=0.04), "b_down": w(d, scale=0.05),
            }
        )
    return tree


# The Llama/Qwen2-class twin of SLICE_CFG: RoPE, RMSNorm, SwiGLU, 4 query
# heads over 2 kv heads, an untied lm_head. d_ff 384 fuses gate|up into
# ``w_gu``; d_ff 344 (``llama_configs(d_ff=344)``) keeps ``w_gate`` and
# ``w_up`` apart and K-pads ``w_down`` to 384.
LLAMA_SLICE_CFG = dict(vocab_size=500, n_layers=2, n_heads=4, n_kv_heads=2, d_model=256, d_ff=384, max_seq=256,
                       pos_encoding="rope", norm="rmsnorm", activation="swiglu", tie_embeddings=False,
                       layer_norm_eps=1e-6)


def llama_configs(**kw):
    """(JAX config, port config) of the Llama slice tests, in f32, with
    ``kw`` replacing fields of ``LLAMA_SLICE_CFG``."""
    c = {**LLAMA_SLICE_CFG, **kw}
    return jdec.DecoderConfig(**c, dtype=jnp.float32), tdec.DecoderConfig(**c, dtype=torch.float32)


def llama_tree(seed: int = 0, d_ff: int = 384, qkv_bias: bool = True) -> dict:
    """``dense_tree``'s SwiGLU / GQA variant: dense params in the JAX
    package's Llama layout (``w_gate``, ``w_up``, ``w_down`` without biases,
    ``wk`` / ``wv`` of the kv heads' width, an ``lm_head``, norm scales
    only), with Qwen2's q/k/v biases when ``qkv_bias``."""
    rng = np.random.default_rng(seed)
    c = LLAMA_SLICE_CFG
    d, v = c["d_model"], c["vocab_size"]
    hkv = c["n_kv_heads"] * d // c["n_heads"]

    def w(*shape, scale=0.08):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def norm():
        return {"scale": rng.uniform(0.8, 1.2, d).astype(np.float32)}

    tree = {"tok_emb": w(v, d, scale=0.5), "lm_head": w(d, v, scale=0.1), "final_norm": norm(), "layers": []}
    for _ in range(c["n_layers"]):
        layer = {"ln1": norm(), "ln2": norm(), "wq": w(d, d), "wk": w(d, hkv), "wv": w(d, hkv), "wo": w(d, d),
                 "w_gate": w(d, d_ff), "w_up": w(d, d_ff), "w_down": w(d_ff, d, scale=0.04)}
        if qkv_bias:
            layer.update(bq=w(d, scale=0.05), bk=w(hkv, scale=0.05), bv=w(hkv, scale=0.05))
        tree["layers"].append(layer)
    return tree


# The Whisper-class encoder-decoder slice: 16 mel bins, 32 audio positions
# (64 mel frames), d_model 256 in 4 heads of 64, 2 + 2 layers, d_ff 512,
# vocab 500, 64 text positions. Every projection and the tied head have
# ≥ 2^16 elements and K a multiple of 128, so all of them quantize.
ED_SLICE_CFG = dict(n_mels=16, n_audio_ctx=32, vocab_size=500, d_model=256, n_heads=4, n_audio_layers=2,
                    n_text_layers=2, d_ff=512, max_text_ctx=64)


def ed_configs(**kw):
    """(JAX config, port config) of the encoder-decoder slice, in f32, with
    ``kw`` replacing fields of ``ED_SLICE_CFG``."""
    from rten_tpu.models import encoder_decoder as jed
    from rten_tpu_torch.models import encoder_decoder as ted

    c = {**ED_SLICE_CFG, **kw}
    return jed.EncDecConfig(**c, dtype=jnp.float32), ted.EncDecConfig(**c, dtype=torch.float32)


def ed_tree(seed: int = 0) -> dict:
    """Dense encoder-decoder params as numpy arrays in the JAX package's
    tree, with random biases and norm parameters (``dense_tree``'s rule) and
    Whisper's biasless k projections."""
    rng = np.random.default_rng(seed)
    c = ED_SLICE_CFG
    d, ff, v = c["d_model"], c["d_ff"], c["vocab_size"]

    def w(*shape, scale=0.08):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    def ln():
        return {"scale": rng.uniform(0.8, 1.2, d).astype(np.float32), "bias": w(d, scale=0.05)}

    def attn():
        return {"wq": w(d, d), "bq": w(d, scale=0.05), "wk": w(d, d), "wv": w(d, d), "bv": w(d, scale=0.05),
                "wo": w(d, d), "bo": w(d, scale=0.05)}

    def mlp():
        return {"w_up": w(d, ff), "b_up": w(ff, scale=0.05), "w_down": w(ff, d, scale=0.04),
                "b_down": w(d, scale=0.05)}

    return {
        "enc_conv1": w(d, c["n_mels"], 3, scale=0.2), "enc_conv1_b": w(d, scale=0.05),
        "enc_conv2": w(d, d, 3, scale=0.05), "enc_conv2_b": w(d, scale=0.05),
        "enc_layers": [{"ln1": ln(), "attn": attn(), "ln2": ln(), "mlp": mlp()} for _ in range(c["n_audio_layers"])],
        "enc_ln_post": ln(),
        "tok_emb": w(v, d, scale=0.5), "pos_emb": w(c["max_text_ctx"], d, scale=0.2),
        "dec_layers": [{"ln1": ln(), "self_attn": attn(), "ln_x": ln(), "cross_attn": attn(), "ln2": ln(),
                        "mlp": mlp()} for _ in range(c["n_text_layers"])],
        "dec_ln": ln(),
    }


def to_jax(tree):
    if isinstance(tree, dict):
        return {k: to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_jax(v) for v in tree]
    return jnp.asarray(tree)


def to_numpy(tree):
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_numpy(v) for v in tree]
    return np.asarray(tree)


def unfold(leaf, head_dim: int) -> np.ndarray:
    """A JAX cache leaf (folded [B, Hk, S·D/128, 128] or not) as [B, Hk, S, D]."""
    leaf = np.asarray(leaf)
    b, hk = leaf.shape[:2]
    return leaf.reshape(b, hk, -1, head_dim)


def port_scales(packed, head_dim: int) -> np.ndarray:
    """JAX KV scales in the kernel layout [B, H, 8, S·D/128] as the port's
    logical [B, H, S] (the JAX package's ``unpack_kv_scales``)."""
    return np.asarray(unpack_kv_scales(jnp.asarray(packed), head_dim))[..., 0]


def carry_cache(jcache: dict, head_dim: int) -> dict:
    """A JAX ``init_cache``-style cache (bf16/f32 or int8 with packed
    scales; rows of any lengths) as the port's CPU cache: logical
    [B, H, S, D] leaves, scales [B, H, S], device and host lengths."""
    def tensor(arr):
        if arr.dtype == jnp.bfloat16:  # numpy holds it as ml_dtypes' bfloat16, which torch cannot take
            return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(arr.copy())

    out = {key: [tensor(unfold(leaf, head_dim)) for leaf in jcache[key]] for key in ("k", "v")}
    for key in ("k_scale", "v_scale"):
        if key in jcache:
            out[key] = [torch.from_numpy(port_scales(leaf, head_dim).copy()) for leaf in jcache[key]]
    lens = np.asarray(jcache["len"])
    out["len"] = torch.from_numpy(lens.astype(np.int32))
    out["host_len"] = lens.astype(np.int64)
    return out


def port_pages(pages, head_dim: int) -> np.ndarray:
    """JAX pages, folded [Hk, P, page·D/128, 128], as the port's [P, H, page, D]."""
    pages = np.asarray(pages)
    hk, p = pages.shape[:2]
    return pages.reshape(hk, p, -1, head_dim).transpose(1, 0, 2, 3)


def port_scale_pages(tiles, head_dim: int, page_size: int) -> np.ndarray:
    """JAX scale pages [Hk, P, 8, 128] (token t of a page at [t % f, t·D/128],
    f = 128/D: ``PagePool.write_scale_tiles``) as the port's [P, H, page]."""
    tiles = np.asarray(tiles)
    f = 128 // head_dim
    t = np.arange(page_size)
    return tiles[:, :, t % f, t // f].transpose(1, 0, 2)


def jax_pages(pages) -> np.ndarray:
    """Port pages [P, H, page, D] → the JAX package's folded [H, P, page·D/128, 128]."""
    pages = np.asarray(pages)
    p, h, page, d = pages.shape
    return np.ascontiguousarray(pages.transpose(1, 0, 2, 3)).reshape(h, p, page * d // 128, 128)


def jax_scale_tiles(scales, head_dim: int) -> np.ndarray:
    """Port scale pages [P, H, page] → JAX tiles [H, P, 8, 128] (token t of a
    page at [t % f, t·D/128]; ``PagePool.write_scale_tiles``)."""
    scales = np.asarray(scales)
    p, h, page = scales.shape
    f = 128 // head_dim
    tiles = np.zeros((h, p, 8, 128), np.float32)
    t = np.arange(page)
    tiles[:, :, t % f, t // f] = scales.transpose(1, 0, 2)
    return tiles


def _interpreted(fn):
    """``fn`` called with ``interpret=True`` whatever its caller passes."""
    return lambda *a, **kw: fn(*a, **{**kw, "interpret": True})


def patch_jax_fused(monkeypatch, w8a8: bool = False):
    """Run the JAX package's fused decode path (the Pallas kernels) on the
    CPU, as ``tests/test_decoder_generate.py:429-455`` runs it:
    ``dispatch.on_tpu`` forced and every Pallas wrapper the decoder and the
    engines reach in interpret mode (the paged ones pass ``interpret``
    themselves, so it is overridden). With ``w8a8`` its W8A8 path
    (``RTEN_W_CONVERT=w8a8``): the GEMV and MLP at ``w_convert="w8a8"``
    explicitly (a trace cached under ``"direct"`` in the same worker is not
    reused), and the module default that ``_proj`` reads set to ``"w8a8"``.
    ``monkeypatch`` undoes all of it; nothing in ``rten_tpu`` changes."""
    import functools

    import rten_tpu.kernels.decode_attention as jda
    import rten_tpu.kernels.dispatch as jdispatch
    import rten_tpu.kernels.paged_attention as jpa
    import rten_tpu.kernels.quant_matmul as jqm

    interpreted = _interpreted
    monkeypatch.setattr(jdispatch, "on_tpu", lambda: True)
    if w8a8:
        monkeypatch.setattr(jqm, "_W_CONVERT_DEFAULT", "w8a8")
    w_convert = "w8a8" if w8a8 else "direct"
    for name in ("quant_gemv_int8", "quant_mlp_int8"):
        monkeypatch.setattr(jqm, name, functools.partial(getattr(jqm, name), interpret=True, w_convert=w_convert))
    for mod, name in ((jqm, "quant_matmul_int8"), (jqm, "quant_matmul_w8a8"), (jda, "decode_attention"),
                      (jda, "decode_attention_int8"), (jpa, "paged_decode_attention"),
                      (jpa, "paged_decode_attention_int8"), (jdec, "flash_attention")):
        monkeypatch.setattr(mod, name, interpreted(getattr(mod, name)))


def patch_jax_w8a8(monkeypatch):
    """``patch_jax_fused`` in the JAX package's W8A8 mode."""
    patch_jax_fused(monkeypatch, w8a8=True)


def patch_jax_encdec(monkeypatch):
    """``patch_jax_fused`` for the JAX encoder-decoder
    (``rten_tpu/models/encoder_decoder.py``), whose every Pallas call then
    runs in interpret mode: its encoder's and cross attention's
    ``flash_attention`` (bound in its own module) and its ``_mm``'s
    ``quant_matmul_int8``; its ``decode`` passes ``interpret=not on_tpu()``,
    False under the patch, to the GEMV, MLP and KV kernels, so those take
    ``interpret=True`` over their caller's."""
    import rten_tpu.kernels.quant_matmul as jqm
    from rten_tpu.models import encoder_decoder as jed

    patch_jax_fused(monkeypatch)
    for mod, name in ((jqm, "quant_gemv_int8"), (jqm, "quant_mlp_int8"), (jed, "flash_attention")):
        monkeypatch.setattr(mod, name, _interpreted(getattr(mod, name)))


def patch_jax_encoders(monkeypatch):
    """``patch_jax_fused`` for the JAX encoders and vision models
    (``rten_tpu/models/bert.py``, ``wav2vec2.py``, ``vit.py``,
    ``mobilenet.py``): their TPU branch, each Pallas call in interpret mode.
    ``dispatch.on_tpu`` forced sends ``bert._proj`` and
    ``mobilenet._pointwise`` to ``quant_matmul_int8`` (imported at call
    time, so the patched one) and turns ``use_flash`` on by default;
    ``flash_attention`` is bound in each transformer's own module, and
    ``wav2vec2.encode`` passes ``interpret=not on_tpu()``, False under the
    patch, so it is overridden there too."""
    from rten_tpu.models import bert as jbert
    from rten_tpu.models import vit as jvit
    from rten_tpu.models import wav2vec2 as jw2v

    patch_jax_fused(monkeypatch)
    for mod in (jbert, jvit, jw2v):
        monkeypatch.setattr(mod, "flash_attention", _interpreted(mod.flash_attention))


def jax_cast(tree, dtype):
    """A JAX params tree with every float leaf in ``dtype`` (int8 packs'
    ``q`` and ``s`` kept)."""
    if isinstance(tree, dict):
        if set(tree) == {"q", "s"}:
            return tree
        return {k: jax_cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [jax_cast(v, dtype) for v in tree]
    return jnp.asarray(tree).astype(dtype)


def rel_err(got, want, mask=None) -> float:
    """max |got - want| over max |want| (over the positions ``mask`` keeps)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if mask is not None:
        got, want = got[mask], want[mask]
    return float(np.abs(got - want).max() / np.abs(want).max())


def torch_f32(arr) -> torch.Tensor:
    """A JAX or numpy array (bf16 included) as a CPU tensor of its values in f32."""
    return torch.from_numpy(np.asarray(arr, np.float32).copy())


def port_graph(jgraph):
    """A copy of a JAX-package ``Graph`` as the port's ``Graph`` (the same
    nodes, ids, inputs, outputs and captures; If branches copied too)."""
    from rten_tpu.graph import Graph as JGraph
    from rten_tpu_torch import graph as tg

    g = tg.Graph()
    for node in jgraph.nodes:
        kind = type(node).__name__
        if kind == "ConstantNode":
            g.nodes.append(tg.ConstantNode(node.name, node.value))
        elif kind == "ValueNode":
            g.nodes.append(tg.ValueNode(node.name, node.shape, node.dtype))
        else:
            attrs = {k: port_graph(v) if isinstance(v, JGraph) else v for k, v in node.attrs.items()}
            g.nodes.append(tg.OperatorNode(node.name, node.op_type, attrs, list(node.inputs), list(node.outputs)))
    g.inputs, g.outputs, g.captures = list(jgraph.inputs), list(jgraph.outputs), list(jgraph.captures)
    return g


def host(value) -> np.ndarray:
    """A port result (a tensor on any device) or a JAX one as numpy."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def assert_graphs_equal(a, b):
    """Two graphs of either package hold the same nodes (kind, name, value
    shape and dtype and bits, shape, op type, attrs, inputs, outputs) and
    the same inputs, outputs and captures; If branches compared alike."""
    assert len(a.nodes) == len(b.nodes)
    for i, (na, nb) in enumerate(zip(a.nodes, b.nodes)):
        kind = type(na).__name__
        assert kind == type(nb).__name__ and na.name == nb.name, (i, na, nb)
        if kind == "ConstantNode":
            assert na.value.dtype == nb.value.dtype and na.value.shape == nb.value.shape, (i, na.name)
            np.testing.assert_array_equal(na.value, nb.value)
        elif kind == "ValueNode":
            assert na.shape == nb.shape, (i, na.name)
        else:
            assert (na.op_type, list(na.inputs), list(na.outputs)) == (nb.op_type, list(nb.inputs), list(nb.outputs))
            assert set(na.attrs) == set(nb.attrs), (i, na.op_type, na.attrs, nb.attrs)
            for key, va in na.attrs.items():
                vb = nb.attrs[key]
                if hasattr(va, "nodes"):
                    assert_graphs_equal(va, vb)
                else:
                    assert type(va) is type(vb) and np.array_equal(va, vb), (i, na.op_type, key, va, vb)
    assert (list(a.inputs), list(a.outputs), list(a.captures)) == (list(b.inputs), list(b.outputs), list(b.captures))
