"""wav2vec2-class speech encoder with a CTC head, on PyTorch and CUDA.

Counterpart of ``rten_tpu/models/wav2vec2.py`` (HuggingFace
``Wav2Vec2ForCTC`` with the base model's conventions,
``feat_extract_norm="group"``, ``do_stable_layer_norm=False``), its TPU
branch:

  waveform [B, N]
    -> seven strided 1-D convolutions (``ieee.conv1d`` in f32; conv 0
       followed by a per-channel GroupNorm over time), each then GELU
    -> feature projection (LayerNorm, then a dense matrix)
    -> + the grouped positional convolution (K 128 in 16 groups, SAME
       padding with the extra frame of an even kernel dropped), GELU
    -> LayerNorm -> post-LN encoder layers (``bert._proj`` projections,
       ``quant_matmul_int8`` for the int8 packs, and ``flash_attention``,
       not causal, with each row's valid frames as ``kv_len``: BERT's
       ``bert._layers``)
    -> CTC logits [B, T, vocab] (``ctc_logits``).

``from_hf_wav2vec2`` reads a ``Wav2Vec2ForCTC.state_dict()`` (the
positional convolution's weight norm resolved, in both of PyTorch's
namings), ``infer_config`` sizes a config from one. ``ctc_logits_jit``
(the JAX package's jitted ``ctc_logits``) is ``ctc_logits`` under
``torch.inference_mode()``. Entry points that make tensors default to ``device="cuda"``;
``device="cpu"`` runs the kernels' plain versions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rten_tpu_torch.kernels.dispatch import resolve_device
from rten_tpu_torch.models import bert, decoder
from rten_tpu_torch.models.bert import _lengths, _ln_f, _proj
from rten_tpu_torch.models.encoder_decoder import _gelu
from rten_tpu_torch.models.ieee import conv1d, matmul


@dataclasses.dataclass(frozen=True)
class Wav2Vec2Config:
    """The JAX package's ``Wav2Vec2Config`` (``wav2vec2.py:40``),
    wav2vec2-base's widths by default."""

    vocab_size: int = 32
    conv_dim: tuple = (512, 512, 512, 512, 512, 512, 512)
    conv_kernel: tuple = (10, 3, 3, 3, 3, 2, 2)
    conv_stride: tuple = (5, 2, 2, 2, 2, 2, 2)
    conv_bias: bool = False
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    num_conv_pos_embeddings: int = 128
    num_conv_pos_groups: int = 16
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


WAV2VEC2_BASE = Wav2Vec2Config()

_DENSE = ("conv", "fp_w", "pos_conv", "lm_head_w") + bert._MATRICES


def feat_extract_output_length(cfg: Wav2Vec2Config, n_samples: int) -> int:
    """Encoder frames the conv stack makes of ``n_samples`` samples."""
    t = n_samples
    for k, s in zip(cfg.conv_kernel, cfg.conv_stride):
        t = (t - k) // s + 1
    return t


def init_params(seed: int, cfg: Wav2Vec2Config = WAV2VEC2_BASE, device="cuda") -> dict:
    """Random dense params from a numpy seed in the JAX package's tree
    (``init_params``, :73): convolutions ``[out, in, K]`` at std 0.1, the
    positional convolution ``[D, D / groups, K]`` at 0.05, matrices ``[in,
    out]`` at 0.02, zero biases, unit norm scales, in ``cfg.dtype``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    d, ff = cfg.d_model, cfg.d_ff

    def dense(*shape, scale=0.02):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * np.float32(scale)).to(dev, cfg.dtype)

    def zeros(n):
        return torch.zeros(n, dtype=cfg.dtype, device=dev)

    def ln(n):
        return {"scale": torch.ones(n, dtype=cfg.dtype, device=dev), "bias": zeros(n)}

    convs, c_in = [], 1
    for i, (c, k) in enumerate(zip(cfg.conv_dim, cfg.conv_kernel)):
        layer = {"conv": dense(c, c_in, k, scale=0.1)}
        if cfg.conv_bias:
            layer["conv_b"] = zeros(c)
        if i == 0:
            layer["gn"] = ln(c)
        convs.append(layer)
        c_in = c
    c_last = cfg.conv_dim[-1]
    params = {
        "convs": convs, "fp_ln": ln(c_last), "fp_w": dense(c_last, d), "fp_b": zeros(d),
        "pos_conv": dense(d, d // cfg.num_conv_pos_groups, cfg.num_conv_pos_embeddings, scale=0.05),
        "pos_conv_b": zeros(d), "enc_ln": ln(d), "layers": [],
        "lm_head_w": dense(d, cfg.vocab_size), "lm_head_b": zeros(cfg.vocab_size),
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "wq": dense(d, d), "bq": zeros(d), "wk": dense(d, d), "bk": zeros(d),
            "wv": dense(d, d), "bv": zeros(d), "wo": dense(d, d), "bo": zeros(d), "attn_ln": ln(d),
            "w_up": dense(d, ff), "b_up": zeros(ff), "w_down": dense(ff, d), "b_down": zeros(d), "ffn_ln": ln(d),
        })
    return params


def quantize_params_int8(params: dict, device="cuda") -> dict:
    """Weight-only INT8 on the transformer projections by BERT's rule
    (``bert.quantize_params_int8``): the convolutions, the feature
    projection and the CTC head stay dense."""
    return bert.quantize_params_int8(params, device=device)


def params_from_jax(tree: dict, cfg: Wav2Vec2Config, device="cuda") -> dict:
    """Carry a JAX package params tree across (``bert.params_from_jax``'s
    rules, the convolutions dense)."""
    return decoder.carry_tree(tree, cfg.dtype, _DENSE, resolve_device(device))


def _conv1d(x, w, bias=None, *, stride=1, padding=0, groups=1):
    """x [B, C_in, T] by w [C_out, C_in / groups, K] in IEEE f32, the bias
    added in f32, rounded to x.dtype (the JAX ``_conv1d``)."""
    out = conv1d(x.float(), w.float(), stride=stride, padding=padding, groups=groups)
    if bias is not None:
        out = out + bias.float()[None, :, None]
    return out.to(x.dtype)


def extract_features(params: dict, cfg: Wav2Vec2Config, wav) -> torch.Tensor:
    """The strided conv feature extractor: waveforms [B, N] -> [B, T, C]."""
    x = wav.to(cfg.dtype)[:, None, :]
    for i, layer in enumerate(params["convs"]):
        x = _conv1d(x, layer["conv"], layer.get("conv_b"), stride=cfg.conv_stride[i])
        if "gn" in layer:
            # GroupNorm with as many groups as channels: each channel
            # normalized over time (HF feat_extract_norm="group").
            xf = x.float()
            mean = xf.mean(-1, keepdim=True)
            var = xf.var(-1, keepdim=True, unbiased=False)
            xf = (xf - mean) * torch.rsqrt(var + cfg.layer_norm_eps)
            xf = xf * layer["gn"]["scale"].float()[None, :, None] + layer["gn"]["bias"].float()[None, :, None]
            x = xf.to(x.dtype)
        x = _gelu(x, x.dtype)
    return x.transpose(1, 2)


def encode(params: dict, cfg: Wav2Vec2Config, wav, *, lengths=None) -> torch.Tensor:
    """Final hidden states [B, T, D] in ``cfg.dtype`` of waveforms [B, N],
    on their device. ``lengths`` [B]: each row's valid FRAMES (default T;
    ``feat_extract_output_length`` of its samples); frames past them are
    masked out of attention and their own outputs are unspecified."""
    feats = extract_features(params, cfg, wav)
    b, t, _ = feats.shape
    x = _proj(_ln_f(feats, params["fp_ln"], cfg.layer_norm_eps), params["fp_w"], params["fp_b"])

    # The grouped positional convolution: SAME padding, the extra frame of
    # an even kernel dropped (HF Wav2Vec2SamePadLayer), GELU, residual.
    k = cfg.num_conv_pos_embeddings
    pos = _conv1d(x.transpose(1, 2), params["pos_conv"], params["pos_conv_b"], padding=k // 2,
                  groups=cfg.num_conv_pos_groups)
    if k % 2 == 0:
        pos = pos[:, :, :-1]
    x = _ln_f(x + _gelu(pos.transpose(1, 2), x.dtype), params["enc_ln"], cfg.layer_norm_eps)

    # Post-LN layers (do_stable_layer_norm=False), BERT's.
    kv_len = _lengths(lengths, b, t, x.device)
    x = bert._layers(params["layers"], x.reshape(b * t, -1), b, t, cfg.n_heads, cfg.layer_norm_eps, kv_len)
    return x.view(b, t, -1)


def ctc_logits(params: dict, cfg: Wav2Vec2Config, wav, *, lengths=None) -> torch.Tensor:
    """Per-frame CTC character logits [B, T, vocab] in ``cfg.dtype``
    (``Wav2Vec2ForCTC``)."""
    hidden = encode(params, cfg, wav, lengths=lengths)
    return matmul(hidden, params["lm_head_w"].to(hidden.dtype)) + params["lm_head_b"].to(hidden.dtype)


@torch.inference_mode()
def ctc_logits_jit(params: dict, cfg: Wav2Vec2Config, wav, *, lengths=None) -> torch.Tensor:
    """``ctc_logits`` under ``torch.inference_mode()`` (the JAX package's
    ``ctc_logits_jit``, ``rten_tpu/models/wav2vec2.py:259``)."""
    return ctc_logits(params, cfg, wav, lengths=lengths)


def infer_config(state: dict, n_heads: int = 12, **overrides) -> Wav2Vec2Config:
    """A ``Wav2Vec2Config`` from a ``Wav2Vec2ForCTC`` state dict's shapes
    (the head count is not in the shapes: pass it; the strides are taken
    as the base model's unless overridden)."""
    state = {k: decoder._np_f32(v) for k, v in state.items()}
    dims, kernels = [], []
    while f"wav2vec2.feature_extractor.conv_layers.{len(dims)}.conv.weight" in state:
        w = state[f"wav2vec2.feature_extractor.conv_layers.{len(dims)}.conv.weight"]
        dims.append(w.shape[0])
        kernels.append(w.shape[2])
    n_layers = 0
    while f"wav2vec2.encoder.layers.{n_layers}.attention.q_proj.weight" in state:
        n_layers += 1
    d_model = state["wav2vec2.feature_projection.projection.weight"].shape[0]
    pos_w = _pos_conv_weight(state)
    kwargs = dict(
        vocab_size=state["lm_head.weight"].shape[0], conv_dim=tuple(dims), conv_kernel=tuple(kernels),
        conv_stride=Wav2Vec2Config.conv_stride[: len(dims)],
        conv_bias="wav2vec2.feature_extractor.conv_layers.0.conv.bias" in state,
        d_model=d_model, n_layers=n_layers, n_heads=n_heads,
        d_ff=state["wav2vec2.encoder.layers.0.feed_forward.intermediate_dense.weight"].shape[0],
        num_conv_pos_embeddings=pos_w.shape[2], num_conv_pos_groups=d_model // pos_w.shape[1],
    )
    kwargs.update(overrides)
    return Wav2Vec2Config(**kwargs)


def _pos_conv_weight(state: dict) -> np.ndarray:
    """The positional convolution's weight, its weight norm resolved: the
    plain ``weight``, or ``weight_g`` / ``weight_v``, or PyTorch ≥ 2.1's
    ``parametrizations.weight.original0`` / ``original1``. The norm is over
    dims (0, 1) a kernel position (``weight_norm(conv, dim=2)``)."""
    base = "wav2vec2.encoder.pos_conv_embed.conv."
    if base + "weight" in state:
        return decoder._np_f32(state[base + "weight"])
    if base + "weight_g" in state:
        g, v = decoder._np_f32(state[base + "weight_g"]), decoder._np_f32(state[base + "weight_v"])
    else:
        g = decoder._np_f32(state[base + "parametrizations.weight.original0"])
        v = decoder._np_f32(state[base + "parametrizations.weight.original1"])
    norm = np.sqrt((v * v).sum(axis=(0, 1), keepdims=True))
    return v / np.maximum(norm, 1e-12) * g


def from_hf_wav2vec2(hf_state: dict, cfg: Wav2Vec2Config, dtype=None, device="cuda") -> dict:
    """Dense port params from a HuggingFace ``Wav2Vec2ForCTC.state_dict()``
    (torch tensors or numpy arrays; a copy of
    ``rten_tpu/models/wav2vec2.py:323``): nn.Linear weights transposed to
    ``[in, out]``, the positional convolution's weight norm resolved."""
    dev, dtype = resolve_device(device), dtype or cfg.dtype
    g = decoder._hf_getter(hf_state, ("",), dev, dtype)

    def t(name):
        return g(name).t().contiguous()

    def ln(p):
        return {"scale": g(p + "weight"), "bias": g(p + "bias")}

    convs = []
    for i in range(len(cfg.conv_dim)):
        p = f"wav2vec2.feature_extractor.conv_layers.{i}."
        layer = {"conv": g(p + "conv.weight")}
        if p + "conv.bias" in hf_state:
            layer["conv_b"] = g(p + "conv.bias")
        if i == 0 and p + "layer_norm.weight" in hf_state:
            layer["gn"] = ln(p + "layer_norm.")
        convs.append(layer)
    params = {
        "convs": convs, "fp_ln": ln("wav2vec2.feature_projection.layer_norm."),
        "fp_w": t("wav2vec2.feature_projection.projection.weight"),
        "fp_b": g("wav2vec2.feature_projection.projection.bias"),
        "pos_conv": torch.from_numpy(_pos_conv_weight(hf_state)).to(dev, dtype),
        "pos_conv_b": g("wav2vec2.encoder.pos_conv_embed.conv.bias"),
        "enc_ln": ln("wav2vec2.encoder.layer_norm."), "layers": [],
        "lm_head_w": t("lm_head.weight"), "lm_head_b": g("lm_head.bias"),
    }
    for i in range(cfg.n_layers):
        p = f"wav2vec2.encoder.layers.{i}."
        params["layers"].append({
            "wq": t(p + "attention.q_proj.weight"), "bq": g(p + "attention.q_proj.bias"),
            "wk": t(p + "attention.k_proj.weight"), "bk": g(p + "attention.k_proj.bias"),
            "wv": t(p + "attention.v_proj.weight"), "bv": g(p + "attention.v_proj.bias"),
            "wo": t(p + "attention.out_proj.weight"), "bo": g(p + "attention.out_proj.bias"),
            "attn_ln": ln(p + "layer_norm."),
            "w_up": t(p + "feed_forward.intermediate_dense.weight"),
            "b_up": g(p + "feed_forward.intermediate_dense.bias"),
            "w_down": t(p + "feed_forward.output_dense.weight"), "b_down": g(p + "feed_forward.output_dense.bias"),
            "ffn_ln": ln(p + "final_layer_norm."),
        })
    return params
