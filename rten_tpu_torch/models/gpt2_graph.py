"""A GPT-2 decoder as a graph of primitive ops, with seeded weights.

``build_gpt2_graph(graph_cls, cfg, seed, tied=False)`` writes the graph an
opset-14 HF-Optimum export of GPT-2 with past key / values holds, from numpy
alone, into ``graph_cls()`` (the port's ``Graph``, or any class with its
API):

- inputs ``input_ids``, ``attention_mask``, ``position_ids`` and
  ``past_key_values.N.key|value`` [B, H, past, D / H]; outputs ``logits``
  and ``present.N.key|value``;
- HF initializer names (``transformer.h.N.attn.c_attn.weight``, ...), the
  Conv1D weights as [in, out] matrices, an untied ``lm_head.weight``
  [d_model, vocab] (with ``tied``, a copy of ``wte``ᵀ, as a tied HF export
  holds; every other weight is the same);
- LayerNorm as the ReduceMean / Sub / Pow / Sqrt / Div pattern, GELU as the
  Erf pattern (both of which the optimizer fuses), the head split and merge
  as Reshape / Transpose with shape math, attention as MatMul / Softmax with
  the causal slice of a [1, 1, P, P] constant (keys up to the query's own
  position, counted from the end of the keys) and the extended attention
  mask ``(1 - mask) · f32 min``.

So a run with a padded cache is exact where the attention mask marks the
valid columns: the layout ``GraphBackend`` feeds. The projections are
normal with GPT-2's std 0.02 (the residual ones 0.02 / sqrt(2 · layers)),
the embeddings with std 0.1 (so that the tokens of a random model vary),
biases and LayerNorm parameters random too; nothing is read from a
checkpoint.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Gpt2GraphConfig:
    vocab_size: int = 50257
    n_positions: int = 1024
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    layer_norm_eps: float = 1e-5


GPT2_SMALL = Gpt2GraphConfig()
INIT_STD = 0.02
F32_MIN = np.float32(np.finfo(np.float32).min)


def build_gpt2_graph(graph_cls, cfg: Gpt2GraphConfig = GPT2_SMALL, seed: int = 0, tied: bool = False):
    """The GPT-2 decoder graph of ``cfg`` with weights from ``seed`` (its
    head ``wte``ᵀ with ``tied``)."""
    rng = np.random.default_rng(seed)
    d, h = cfg.d_model, cfg.n_heads
    hd = d // h
    g = graph_cls()

    def const(name, arr):
        return g.add_constant(name, np.asarray(arr))

    def op(op_type, inputs, name, attrs=None, n_outputs=1):
        return g.add_simple_op(op_type, inputs, attrs, name=name, n_outputs=n_outputs)

    def normal(*shape, std=INIT_STD):
        return (rng.standard_normal(shape) * std).astype(np.float32)

    ids = g.add_value("input_ids", ["batch_size", "sequence_length"])
    mask = g.add_value("attention_mask", ["batch_size", "total_sequence_length"])
    pos = g.add_value("position_ids", ["batch_size", "sequence_length"])
    past = []
    for i in range(cfg.n_layers):
        past.append(tuple(
            g.add_value(f"past_key_values.{i}.{kind}", ["batch_size", h, "past_sequence_length", hd])
            for kind in ("key", "value")))
    g.inputs = [ids, mask, pos] + [v for pair in past for v in pair]

    two = const("const_two", np.float32(2.0))
    eps = const("const_eps", np.float32(cfg.layer_norm_eps))
    one = const("const_one", np.float32(1.0))
    half = const("const_half", np.float32(0.5))
    sqrt2 = const("const_sqrt2", np.float32(np.sqrt(2.0)))
    f32_min = const("const_f32_min", F32_MIN)
    scale = const("const_attn_scale", np.float32(np.sqrt(hd)))
    idx = [const(f"const_idx_{i}", np.int64(i)) for i in range(3)]
    ax0 = const("const_axes_0", np.array([0], np.int64))
    ax12 = const("const_axes_1_2", np.array([1, 2], np.int64))
    ax23 = const("const_axes_2_3", np.array([2, 3], np.int64))
    zero1 = const("const_zero_1", np.array([0], np.int64))
    heads = const("const_heads", np.array([h, hd], np.int64))
    width = const("const_width", np.array([d], np.int64))
    qkv_split = const("const_qkv_split", np.array([d, d, d], np.int64))
    causal = const("transformer.h.bias", np.tril(np.ones((cfg.n_positions, cfg.n_positions), np.uint8))[None, None])

    def layer_norm(x, prefix):
        sc = const(f"{prefix}.weight", rng.uniform(0.8, 1.2, d).astype(np.float32))
        bi = const(f"{prefix}.bias", normal(d, std=0.05))
        mean = op("ReduceMean", [x], f"/{prefix}/ReduceMean", {"axes": [-1], "keep_dims": True})
        dev = op("Sub", [x, mean], f"/{prefix}/Sub")
        var = op("ReduceMean", [op("Pow", [dev, two], f"/{prefix}/Pow")], f"/{prefix}/ReduceMean_1",
                 {"axes": [-1], "keep_dims": True})
        std = op("Sqrt", [op("Add", [var, eps], f"/{prefix}/Add")], f"/{prefix}/Sqrt")
        norm = op("Div", [dev, std], f"/{prefix}/Div")
        return op("Add", [op("Mul", [norm, sc], f"/{prefix}/Mul"), bi], f"/{prefix}/Add_1")

    def linear(x, prefix, n_in, n_out, std=INIT_STD):
        w = const(f"{prefix}.weight", normal(n_in, n_out, std=std))
        b = const(f"{prefix}.bias", normal(n_out, std=0.05))
        return op("Add", [op("MatMul", [x, w], f"/{prefix}/MatMul"), b], f"/{prefix}/Add")

    # Embeddings and the extended attention mask, (1 - mask) · f32 min.
    wte_w = normal(cfg.vocab_size, d, std=0.1)
    wte = const("transformer.wte.weight", wte_w)
    wpe = const("transformer.wpe.weight", normal(cfg.n_positions, d, std=0.1))
    x = op("Add", [op("Gather", [wte, ids], "/wte/Gather", {"axis": 0}),
                   op("Gather", [wpe, pos], "/wpe/Gather", {"axis": 0})], "/embed/Add")
    maskf = op("Cast", [op("Unsqueeze", [mask, ax12], "/mask/Unsqueeze")], "/mask/Cast", {"to": "float"})
    ext = op("Mul", [op("Sub", [one, maskf], "/mask/Sub"), f32_min], "/mask/Mul")

    presents = []
    for i in range(cfg.n_layers):
        p = f"transformer.h.{i}"
        ln1 = layer_norm(x, f"{p}.ln_1")
        qkv = linear(ln1, f"{p}.attn.c_attn", d, 3 * d)
        q, k, v = (g.add_value(f"/{p}/attn/Split_out{j}") for j in range(3))
        g.add_operator(f"/{p}/attn/Split", "Split", {"axis": 2}, [qkv, qkv_split], [q, k, v])
        # Shape math: [B, T, H, D/H] and [B, T, D] from the input's shape.
        shp = op("Shape", [ln1], f"/{p}/attn/Shape")
        b_dim = op("Unsqueeze", [op("Gather", [shp, idx[0]], f"/{p}/attn/Gather", {"axis": 0}), ax0],
                   f"/{p}/attn/Unsqueeze")
        t_scalar = op("Gather", [shp, idx[1]], f"/{p}/attn/Gather_1", {"axis": 0})
        t_dim = op("Unsqueeze", [t_scalar, ax0], f"/{p}/attn/Unsqueeze_1")
        split_shape = op("Concat", [b_dim, t_dim, heads], f"/{p}/attn/Concat", {"axis": 0})
        merge_shape = op("Concat", [b_dim, t_dim, width], f"/{p}/attn/Concat_1", {"axis": 0})

        def heads_first(val, name):
            r = op("Reshape", [val, split_shape], f"/{p}/attn/Reshape_{name}")
            return op("Transpose", [r], f"/{p}/attn/Transpose_{name}", {"perm": [0, 2, 1, 3]})

        qh, kh, vh = heads_first(q, "q"), heads_first(k, "k"), heads_first(v, "v")
        pk = g.add_value(f"present.{i}.key")
        g.add_operator(f"/{p}/attn/Concat_k", "Concat", {"axis": 2}, [past[i][0], kh], [pk])
        pv = g.add_value(f"present.{i}.value")
        g.add_operator(f"/{p}/attn/Concat_v", "Concat", {"axis": 2}, [past[i][1], vh], [pv])
        presents += [pk, pv]
        kt = op("Transpose", [pk], f"/{p}/attn/Transpose_kt", {"perm": [0, 1, 3, 2]})
        scores = op("Div", [op("MatMul", [qh, kt], f"/{p}/attn/MatMul"), scale], f"/{p}/attn/Div")
        # Causal: query row r may see keys up to S - T + r.
        s_scalar = op("Gather", [op("Shape", [pk], f"/{p}/attn/Shape_1"), idx[2]], f"/{p}/attn/Gather_2",
                      {"axis": 0})
        s_dim = op("Unsqueeze", [s_scalar, ax0], f"/{p}/attn/Unsqueeze_2")
        start = op("Unsqueeze", [op("Sub", [s_scalar, t_scalar], f"/{p}/attn/Sub"), ax0], f"/{p}/attn/Unsqueeze_3")
        allowed = op("Slice", [causal, op("Concat", [start, zero1], f"/{p}/attn/Concat_2", {"axis": 0}),
                               op("Concat", [s_dim, s_dim], f"/{p}/attn/Concat_3", {"axis": 0}), ax23],
                     f"/{p}/attn/Slice")
        masked = op("Add", [op("Where", [allowed, scores, f32_min], f"/{p}/attn/Where"), ext], f"/{p}/attn/Add")
        probs = op("Softmax", [masked], f"/{p}/attn/Softmax", {"axis": -1})
        ctx = op("MatMul", [probs, pv], f"/{p}/attn/MatMul_1")
        merged = op("Reshape", [op("Transpose", [ctx], f"/{p}/attn/Transpose_ctx", {"perm": [0, 2, 1, 3]}),
                                merge_shape], f"/{p}/attn/Reshape_ctx")
        attn = linear(merged, f"{p}.attn.c_proj", d, d, std=INIT_STD / np.sqrt(2 * cfg.n_layers))
        x = op("Add", [x, attn], f"/{p}/Add")

        ln2 = layer_norm(x, f"{p}.ln_2")
        up = linear(ln2, f"{p}.mlp.c_fc", d, cfg.d_ff)
        erf = op("Erf", [op("Div", [up, sqrt2], f"/{p}/mlp/act/Div")], f"/{p}/mlp/act/Erf")
        gelu = op("Mul", [op("Mul", [up, op("Add", [erf, one], f"/{p}/mlp/act/Add")], f"/{p}/mlp/act/Mul"), half],
                  f"/{p}/mlp/act/Mul_1")
        down = linear(gelu, f"{p}.mlp.c_proj", cfg.d_ff, d, std=INIT_STD / np.sqrt(2 * cfg.n_layers))
        x = op("Add", [x, down], f"/{p}/Add_1")

    final = layer_norm(x, "transformer.ln_f")
    head = const("lm_head.weight", np.ascontiguousarray(wte_w.T) if tied else normal(d, cfg.vocab_size))
    logits = g.add_value("logits")
    g.add_operator("/lm_head/MatMul", "MatMul", {}, [final, head], [logits])
    g.outputs = [logits] + presents
    return g
