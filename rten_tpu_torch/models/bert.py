"""BERT-class transformer encoder (BERT / DistilBERT / Jina-style embedding
models) on PyTorch and CUDA.

Counterpart of ``rten_tpu/models/bert.py`` (BASELINE's "MobileNet +
DistilBERT INT8"), its TPU branch: padded batches with per-sequence valid
lengths, post-LN encoder layers whose attention is ``flash_attention``, not
causal, with each row's ``kv_len`` (padding never attends), and whose
projections, once ``quantize_params_int8`` made them int8 packs, go through
``quant_matmul_int8`` with the bias added in f32 in its epilogue before the
one rounding (the TPU branch of the JAX ``_proj``; its CPU branch
dequantizes the weights instead). Matrices left dense take
``ieee.matmul`` (the JAX ``dispatch.matmul``). Every LayerNorm runs in f32
and rounds once (the JAX ``_ln_f``); GELU is the exact erf, in f32.

Heads: ``encode`` (final hidden states [B, T, D]), ``pool`` (sentence
embeddings, cls or mean over valid tokens) and ``qa_logits`` (extractive-QA
start / end logits, padding masked). ``from_hf_bert`` reads a HuggingFace
``BertModel`` state dict. ``encode_jit`` (the JAX package's jitted
``encode``) is ``encode`` under ``torch.inference_mode()``.

Parameters are plain dicts of tensors under the JAX package's names; an
int8 matrix is an ``int8_pack`` (``{"qt": int8 [N, K], "s": f32 [N]}``).
Entry points that make tensors default to ``device="cuda"`` and raise on a
machine without CUDA; ``device="cpu"`` runs the kernels' plain versions.
The forward functions run on their inputs' device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from rten_tpu_torch.kernels.attention import flash_attention
from rten_tpu_torch.kernels.dispatch import resolve_device
from rten_tpu_torch.kernels.quant_matmul import int8_pack, quant_matmul_int8, quantize_weights_int8
from rten_tpu_torch.models import decoder
from rten_tpu_torch.models.encoder_decoder import _gelu, _heads, _unheads
from rten_tpu_torch.models.ieee import matmul


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """The JAX package's ``BertConfig`` (``bert.py:34``), BERT-base's
    widths by default."""

    vocab_size: int = 30522
    n_layers: int = 12
    n_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    max_seq: int = 512
    n_segments: int = 2  # 0: no token_type embeddings (DistilBERT)
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.float32

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


BERT_BASE = BertConfig()
DISTILBERT_BASE = BertConfig(n_layers=6, n_segments=0)
JINA_SMALL = BertConfig(n_layers=4, d_model=512, n_heads=8, d_ff=2048, n_segments=2)

_MATRICES = ("wq", "wk", "wv", "wo", "w_up", "w_down")
_DENSE = ("tok_emb", "pos_emb", "seg_emb") + _MATRICES


def init_params(seed: int, cfg: BertConfig = BERT_BASE, device="cuda") -> dict:
    """Random dense params from a numpy seed in the JAX package's tree
    (``init_params``, :56): normal 0.02 matrices and embeddings ``[in,
    out]``, zero biases, unit LayerNorm scales, in ``cfg.dtype``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    d, ff = cfg.d_model, cfg.d_ff

    def dense(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)).to(dev, cfg.dtype)

    def zeros(n):
        return torch.zeros(n, dtype=cfg.dtype, device=dev)

    def ln():
        return {"scale": torch.ones(d, dtype=cfg.dtype, device=dev), "bias": zeros(d)}

    params = {"tok_emb": dense(cfg.vocab_size, d), "pos_emb": dense(cfg.max_seq, d), "emb_ln": ln(), "layers": []}
    if cfg.n_segments:
        params["seg_emb"] = dense(cfg.n_segments, d)
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "wq": dense(d, d), "bq": zeros(d), "wk": dense(d, d), "bk": zeros(d),
            "wv": dense(d, d), "bv": zeros(d), "wo": dense(d, d), "bo": zeros(d), "attn_ln": ln(),
            "w_up": dense(d, ff), "b_up": zeros(ff), "w_down": dense(ff, d), "b_down": zeros(d), "ffn_ln": ln(),
        })
    return params


def quantize_params_int8(params: dict, device="cuda") -> dict:
    """Weight-only INT8 by the JAX package's rule (``quantize_params_int8``,
    :101): every 2-D leaf whose key starts with ``w``, of at least 2^16
    elements with both dims multiples of 128, becomes an ``int8_pack``
    quantized per output channel; everything else (embeddings, biases,
    norms, smaller matrices) stays as it is, on ``device``."""
    dev = resolve_device(device)

    def walk(node, key=""):
        if isinstance(node, dict):
            if "qt" in node:
                return node
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, key) for v in node]
        if key.startswith("w") and node.dim() == 2 and node.numel() >= 1 << 16:
            if node.shape[0] % 128 == 0 and node.shape[1] % 128 == 0:
                return int8_pack(*quantize_weights_int8(decoder._np_f32(node), axis=-1), device=dev)
        return node.to(dev)

    return walk(params)


def params_from_jax(tree: dict, cfg: BertConfig, device="cuda") -> dict:
    """Carry a JAX package params tree across (leaves as numpy arrays or
    anything ``np.asarray`` takes): ``{"q", "s"}`` packs become
    ``int8_pack``s, embeddings and dense matrices tensors in ``cfg.dtype``,
    vectors ``[N]`` (f32 in a quantized tree)."""
    return decoder.carry_tree(tree, cfg.dtype, _DENSE, resolve_device(device))


def from_hf_bert(hf_state: dict, cfg: BertConfig, dtype=None, device="cuda") -> dict:
    """Dense port params from a HuggingFace ``BertModel.state_dict()``
    layout (torch tensors or numpy arrays; a copy of
    ``rten_tpu/models/bert.py:220``): nn.Linear weights ``[out, in]`` are
    transposed; token_type embeddings are read where present."""
    g = decoder._hf_getter(hf_state, ("",), resolve_device(device), dtype or cfg.dtype)

    def t(name):
        return g(name).t().contiguous()

    def ln(p):
        return {"scale": g(p + "weight"), "bias": g(p + "bias")}

    params = {"tok_emb": g("embeddings.word_embeddings.weight"), "pos_emb": g("embeddings.position_embeddings.weight"),
              "emb_ln": ln("embeddings.LayerNorm."), "layers": []}
    if "embeddings.token_type_embeddings.weight" in hf_state:
        params["seg_emb"] = g("embeddings.token_type_embeddings.weight")
    for i in range(cfg.n_layers):
        p = f"encoder.layer.{i}."
        params["layers"].append({
            "wq": t(p + "attention.self.query.weight"), "bq": g(p + "attention.self.query.bias"),
            "wk": t(p + "attention.self.key.weight"), "bk": g(p + "attention.self.key.bias"),
            "wv": t(p + "attention.self.value.weight"), "bv": g(p + "attention.self.value.bias"),
            "wo": t(p + "attention.output.dense.weight"), "bo": g(p + "attention.output.dense.bias"),
            "attn_ln": ln(p + "attention.output.LayerNorm."),
            "w_up": t(p + "intermediate.dense.weight"), "b_up": g(p + "intermediate.dense.bias"),
            "w_down": t(p + "output.dense.weight"), "b_down": g(p + "output.dense.bias"),
            "ffn_ln": ln(p + "output.LayerNorm."),
        })
    return params


# ---------------------------------------------------------------------------
# Building blocks (wav2vec2 and ViT use them too)
# ---------------------------------------------------------------------------


def _ln_f(x, p, eps: float):
    """LayerNorm in f32 (statistics, normalization, scale and shift),
    rounded once to x.dtype: the JAX ``_ln_f``."""
    xf = x.float()
    y = F.layer_norm(xf, (xf.shape[-1],), p["scale"].float(), p["bias"].float(), eps)
    return y.to(x.dtype)


def _proj(x, w, b):
    """``x @ w + b`` over the last axis: an ``int8_pack`` through
    ``quant_matmul_int8`` (bias in f32 in its epilogue, one rounding to
    x.dtype), a dense matrix through ``ieee.matmul`` then ``+ b``."""
    if isinstance(w, dict):
        out = quant_matmul_int8(x.reshape(-1, x.shape[-1]), w["qt"], w["s"], b)
        return out.view(*x.shape[:-1], -1)
    return matmul(x, w.to(x.dtype)) + b.to(x.dtype)


def _lengths(lengths, b: int, t: int, device):
    """Each row's valid length as a contiguous int32 [B] tensor on
    ``device`` (all T without ``lengths``)."""
    if lengths is None:
        return torch.full((b,), t, dtype=torch.int32, device=device)
    return torch.as_tensor(lengths).to(device, torch.int32).contiguous()


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def encode(params: dict, cfg: BertConfig, input_ids, *, lengths=None, segment_ids=None) -> torch.Tensor:
    """Final hidden states [B, T, D] in ``cfg.dtype`` of ``input_ids``
    [B, T] (int), on their device. ``lengths`` [B]: each row's valid
    tokens (default T). Positions at or past ``lengths[b]`` are padding:
    masked out of attention (no row attends to them); their own outputs are
    unspecified, so use ``pool`` / ``qa_logits``, which mask them."""
    b, t = input_ids.shape
    dev = input_ids.device
    ids = input_ids.long()
    kv_len = _lengths(lengths, b, t, dev)
    x = params["tok_emb"][ids] + params["pos_emb"][:t][None]
    if cfg.n_segments and "seg_emb" in params:
        seg = torch.zeros_like(ids) if segment_ids is None else segment_ids.long()
        x = x + params["seg_emb"][seg]
    x = _ln_f(x.to(cfg.dtype), params["emb_ln"], cfg.layer_norm_eps).view(b * t, -1)
    return _layers(params["layers"], x, b, t, cfg.n_heads, cfg.layer_norm_eps, kv_len).view(b, t, -1)


@torch.inference_mode()
def encode_jit(params: dict, cfg: BertConfig, input_ids, lengths=None, segment_ids=None) -> torch.Tensor:
    """``encode`` under ``torch.inference_mode()`` (the JAX package's
    ``encode_jit``, ``rten_tpu/models/bert.py:225``)."""
    return encode(params, cfg, input_ids, lengths=lengths, segment_ids=segment_ids)


def _layers(layers, x, b: int, t: int, h: int, eps: float, kv_len):
    """Post-LN encoder layers (the original BERT's, wav2vec2's) over rows
    x [B·T, D]: LN(x + attention(x)), then LN(x + MLP(x)), attention not
    causal with each row's ``kv_len``."""
    for layer in layers:
        q = _heads(_proj(x, layer["wq"], layer["bq"]), b, t, h)
        k = _heads(_proj(x, layer["wk"], layer["bk"]), b, t, h)
        v = _heads(_proj(x, layer["wv"], layer["bv"]), b, t, h)
        attn = _unheads(flash_attention(q, k, v, causal=False, kv_len=kv_len))
        x = _ln_f(x + _proj(attn, layer["wo"], layer["bo"]), layer["attn_ln"], eps)
        up = _proj(x, layer["w_up"], layer["b_up"])
        up = _gelu(up, up.dtype)
        x = _ln_f(x + _proj(up, layer["w_down"], layer["b_down"]), layer["ffn_ln"], eps)
    return x


def pool(hidden, lengths=None, mode: str = "mean") -> torch.Tensor:
    """Sentence embeddings [B, D] in hidden's dtype, L2-normalized in f32:
    the first token (``mode="cls"``) or the mean over each row's valid
    tokens (``"mean"``)."""
    b, t, _ = hidden.shape
    if mode == "cls":
        emb = hidden[:, 0, :]
    else:
        lens = _lengths(lengths, b, t, hidden.device)
        mask = (torch.arange(t, device=hidden.device)[None, :] < lens[:, None]).to(hidden.dtype)
        emb = (hidden * mask[:, :, None]).sum(1) / torch.clamp(lens[:, None].to(hidden.dtype), min=1)
    emb = emb.float()
    norm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
    return (emb / torch.clamp(norm, min=1e-9)).to(hidden.dtype)


def qa_logits(hidden, qa_head: dict, lengths=None):
    """Extractive-QA span head: (start, end) logits [B, T] in hidden's
    dtype, positions at or past ``lengths[b]`` set to -1e30. ``qa_head`` is
    ``{"w": [D, 2], "b": [2]}``."""
    b, t, _ = hidden.shape
    logits = matmul(hidden, qa_head["w"].to(hidden.dtype)) + qa_head["b"].to(hidden.dtype)
    if lengths is not None:
        lens = _lengths(lengths, b, t, hidden.device)
        mask = torch.arange(t, device=hidden.device)[None, :] < lens[:, None]
        logits = torch.where(mask[:, :, None], logits, torch.full_like(logits, -1e30))
    return logits[..., 0], logits[..., 1]
