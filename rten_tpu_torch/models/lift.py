"""Lift loaded decoder graphs onto the native decoders: the counterpart of
``rten_tpu/models/lift.py``.

Given a loaded `.rten` / ONNX model whose initializers follow HuggingFace
naming (GPT-2 ``h.N.attn.c_attn.weight``..., OPT ``decoder.layers.N.fc1``...,
Llama ``layers.N.self_attn.q_proj``..., Whisper ``encoder.*`` /
``decoder.*``), ``lift_decoder`` and ``lift_encoder_decoder`` extract the
weights into the port's dense params (``decoder.from_hf_gpt2``,
``from_hf_opt``, ``from_hf_llama``, ``encoder_decoder.from_hf_whisper``) on
``device`` and infer the config, so that generation runs on the decoders'
dense-weight route instead of the graph interpreter.

Head count is not recoverable from weight shapes alone: it is inferred from
the graph's Reshape shape constants ([.., .., n_heads, head_dim] with
n_heads · head_dim = d_model) or passed explicitly.

One intended difference from the JAX package: a GPT-2 or OPT graph whose
``lm_head.weight`` is not the token embedding transposed (an untied head)
keeps that head as ``params["lm_head"]`` [d_model, vocab], which the port's
forward reads, so the lifted logits equal the graph's. The JAX package ties
the head to the embedding whatever the graph holds.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from rten_tpu_torch.kernels.dispatch import resolve_device
from rten_tpu_torch.models import decoder
from rten_tpu_torch.models.decoder import DecoderConfig


class LiftError(ValueError):
    pass


def graph_weights(graph) -> dict[str, np.ndarray]:
    """Named constants of a Graph (initializer names survive ONNX import)."""
    out: dict[str, np.ndarray] = {}
    for node in graph.nodes:
        name = getattr(node, "name", None)
        value = getattr(node, "value", None)
        if name and value is not None:
            out[name] = np.asarray(value)
    return out


def _strip_prefixes(weights: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    return {re.sub(r"^(transformer|model|m)\.", "", k): v for k, v in weights.items()}


def infer_n_heads(graph, d_model: int) -> int | None:
    """Scan Reshape-style shape constants for [.., .., h, hd] with
    h · hd == d_model."""
    candidates: dict[int, int] = {}
    for node in graph.nodes:
        value = getattr(node, "value", None)
        if value is None:
            continue
        arr = np.asarray(value)
        if arr.ndim == 1 and arr.size == 4 and np.issubdtype(arr.dtype, np.integer):
            h, hd = int(arr[-2]), int(arr[-1])
            if h > 0 and hd > 0 and h * hd == d_model:
                candidates[h] = candidates.get(h, 0) + 1
    if not candidates:
        return None
    return max(candidates, key=candidates.get)


def _n_layers(w: dict, pattern: str) -> int:
    return 1 + max(int(m.group(1)) for k in w if (m := re.match(pattern, k)))


def _untied_head(w: dict, emb: str, dev, dtype):
    """The graph's ``lm_head.weight`` as [d_model, vocab] when it is not
    ``emb``ᵀ (the orientation judged by shape: [d, vocab] as a MatMul
    operand, [vocab, d] as an nn.Linear weight), else None."""
    head = w.get("lm_head.weight")
    if head is None:
        return None
    table = w[emb]  # [vocab, d]
    if head.shape == table.shape[::-1]:
        head_dv = head
    elif head.shape == table.shape:
        head_dv = head.T
    else:
        raise LiftError(f"lm_head.weight {head.shape} fits neither orientation of {emb} {table.shape}")
    if np.array_equal(head_dv, table.T):
        return None
    # A copy: a loaded graph's arrays are read-only views of the file.
    return torch.from_numpy(np.array(head_dv, np.float32)).to(dev, dtype)


def lift_decoder(model_or_graph, n_heads: int | None = None, dtype=None, device="cuda"):
    """Returns (cfg, params) for ``models.decoder`` (dense params in
    ``dtype``, default f32, on ``device``), or raises LiftError, also where
    a family's weight is missing (an int8 graph after the optimizer's sweep
    keeps only ``*_q`` / ``*_scale`` constants; the JAX package raises
    KeyError there).

    Accepts a runtime Model, a Graph, or a {name: array} mapping."""
    try:
        return _lift_decoder(model_or_graph, n_heads, dtype, device)
    except KeyError as e:
        raise LiftError(f"missing weight {e.args[0]!r}") from e


def _lift_decoder(model_or_graph, n_heads, dtype, device):
    if isinstance(model_or_graph, dict):
        weights, graph = model_or_graph, None
    else:
        graph = getattr(model_or_graph, "graph", model_or_graph)
        weights = graph_weights(graph)
    w = _strip_prefixes(weights)
    dtype = dtype or torch.float32
    dev = resolve_device(device)

    def heads(d):
        h = n_heads if n_heads is not None else (infer_n_heads(graph, d) if graph is not None else None)
        if h is None:
            raise LiftError("n_heads not inferable — pass n_heads=")
        return h

    if "wte.weight" in w:  # GPT-2 family
        d = w["wte.weight"].shape[1]
        head = _untied_head(w, "wte.weight", dev, dtype)
        cfg = DecoderConfig(
            vocab_size=w["wte.weight"].shape[0],
            n_layers=_n_layers(w, r"h\.(\d+)\."),
            n_heads=heads(d),
            d_model=d,
            d_ff=w["h.0.mlp.c_fc.weight"].shape[-1],
            max_seq=w["wpe.weight"].shape[0],
            tie_embeddings=head is None,
            dtype=dtype,
        )
        params = decoder.from_hf_gpt2(w, cfg, dtype, device=dev)
    elif (
        "decoder.embed_tokens.weight" in w
        and "decoder.layers.0.fc1.weight" in w
        # Whisper-class encoder-decoders also use fc1/fc2 naming: anything
        # with encoder weights belongs to lift_encoder_decoder.
        and not any("encoder" in k for k in w)
    ):  # OPT family: ReLU MLP, learned positions at the 2-row offset
        d = w["decoder.embed_tokens.weight"].shape[1]
        head = _untied_head(w, "decoder.embed_tokens.weight", dev, dtype)
        cfg = DecoderConfig(
            vocab_size=w["decoder.embed_tokens.weight"].shape[0],
            n_layers=_n_layers(w, r"decoder\.layers\.(\d+)\."),
            n_heads=heads(d),
            d_model=d,
            d_ff=w["decoder.layers.0.fc1.weight"].shape[0],
            max_seq=w["decoder.embed_positions.weight"].shape[0] - 2,
            pos_offset=2,
            activation="relu",
            tie_embeddings=head is None,
            dtype=dtype,
        )
        params = decoder.from_hf_opt(w, cfg, dtype, device=dev)
    elif "embed_tokens.weight" in w:  # Llama family (its head is always carried)
        d = w["embed_tokens.weight"].shape[1]
        h = heads(d)
        head = None
        cfg = DecoderConfig(
            vocab_size=w["embed_tokens.weight"].shape[0],
            n_layers=_n_layers(w, r"layers\.(\d+)\."),
            n_heads=h,
            n_kv_heads=w["layers.0.self_attn.k_proj.weight"].shape[0] // (d // h),
            d_model=d,
            d_ff=w["layers.0.mlp.gate_proj.weight"].shape[0],
            max_seq=4096,
            pos_encoding="rope",
            norm="rmsnorm",
            activation="swiglu",
            tie_embeddings=False,
            dtype=dtype,
        )
        params = decoder.from_hf_llama(w, cfg, dtype, device=dev)
    else:
        raise LiftError(
            "graph does not follow a recognized decoder naming scheme "
            "(GPT-2 wte/h.N.* or Llama embed_tokens/layers.N.*)"
        )
    if head is not None:
        params["lm_head"] = head
    return cfg, params


def lift_encoder_decoder(
    model_or_graph,
    decoder_graph=None,
    n_heads: int | None = None,
    dtype=None,
    int8_kv: bool = False,
    device="cuda",
):
    """Lift a Whisper-class encoder-decoder graph onto
    ``models.encoder_decoder`` (dense params in ``dtype``, default f32, on
    ``device``). Accepts a single Model / Graph / {name: array} mapping with
    the full HF ``WhisperModel`` state (``(model.)encoder.*`` /
    ``decoder.*`` initializer names), or separate encoder and decoder graphs
    (the HF Optimum two-file export) whose weights are merged. Returns
    (EncDecConfig, params), or raises LiftError if the naming scheme is not
    recognized or a weight is missing."""

    def _weights_of(x):
        if x is None:
            return {}
        if isinstance(x, dict):
            return dict(x)
        return graph_weights(getattr(x, "graph", x))

    w = _weights_of(model_or_graph)
    w.update(_weights_of(decoder_graph))
    w = _strip_prefixes(w)
    dtype = dtype or torch.float32

    if "decoder.embed_tokens.weight" not in w or "encoder.conv1.weight" not in w:
        raise LiftError(
            "graph does not follow the Whisper encoder-decoder naming scheme "
            "((model.)encoder.conv1/layers.N.*, decoder.embed_tokens/layers.N.*)"
        )
    d = w["decoder.embed_tokens.weight"].shape[1]

    def _count(prefix):
        n = 0
        while f"{prefix}.{n}.self_attn.q_proj.weight" in w:
            n += 1
        return n

    n_audio_layers = _count("encoder.layers")
    n_text_layers = _count("decoder.layers")
    if not n_audio_layers or not n_text_layers:
        raise LiftError("no encoder/decoder layers found")

    if n_heads is None and not isinstance(model_or_graph, dict):
        n_heads = infer_n_heads(getattr(model_or_graph, "graph", model_or_graph), d)
    if n_heads is None:
        n_heads = max(1, d // 64)  # Whisper convention: head dim 64 across the published family
    try:
        return _lift_whisper(w, n_heads, n_audio_layers, n_text_layers, dtype, int8_kv, device)
    except KeyError as e:
        raise LiftError(f"missing weight {e.args[0]!r}") from e


def _lift_whisper(w, n_heads, n_audio_layers, n_text_layers, dtype, int8_kv, device):
    from rten_tpu_torch.models.encoder_decoder import EncDecConfig, from_hf_whisper

    vocab, d = w["decoder.embed_tokens.weight"].shape
    if "encoder.embed_positions.weight" in w:
        n_audio_ctx = w["encoder.embed_positions.weight"].shape[0]
    else:
        n_audio_ctx = EncDecConfig.n_audio_ctx  # sinusoids are recomputed
    cfg = EncDecConfig(
        n_mels=w["encoder.conv1.weight"].shape[1],
        n_audio_ctx=n_audio_ctx,
        vocab_size=vocab,
        d_model=d,
        n_heads=n_heads,
        n_audio_layers=n_audio_layers,
        n_text_layers=n_text_layers,
        d_ff=w["decoder.layers.0.fc1.weight"].shape[0],
        max_text_ctx=w["decoder.embed_positions.weight"].shape[0],
        dtype=dtype,
        int8_kv=int8_kv,
    )
    return cfg, from_hf_whisper(w, cfg, dtype, device=device)
