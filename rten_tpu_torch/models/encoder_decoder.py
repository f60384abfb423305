"""Whisper-class encoder-decoder on PyTorch and CUDA: INT8 weights, a bf16
or INT8 self-attention KV cache, cross-attention K/V computed once per
utterance.

Counterpart of ``rten_tpu/models/encoder_decoder.py`` (BASELINE's "Whisper
encoder-decoder transcription with INT8 weights + INT8 KV-cache"):

- **The audio encoder** (``encode``): two 1-D convolutions
  (``ieee.conv1d``: IEEE f32 at ``dtype=float32`` whatever the TF32 flags;
  the second of stride 2; the JAX package leaves them to XLA, no Pallas
  kernel), each followed by the exact-erf GELU; sinusoidal positions; then
  pre-norm encoder blocks whose projections are ``quant_matmul_int8`` (the
  MLP's up with its GELU in the kernel's epilogue) and whose attention is
  ``flash_attention``, not causal, over every audio position.
- **The decoder state** (``init_decoder_state``): each layer's cross K/V,
  projected once from the encoder states, and the self-attention cache in
  the port decoder's layout (``decoder.init_cache``): k/v ``[B, H, S, D]``
  in the model dtype, or (``cfg.int8_kv``) int8 with one f32 scale per
  (token, head) ``[B, H, S]``, each row's device length ``len`` and its
  host mirror ``host_len``. S is ``max_text_ctx``, neither rounded up to 256
  nor folded (the JAX package's TPU layout).
- **A decoder forward** (``decode``), T ≥ 1 tokens per row appended at
  each row's length. As in the JAX package, one token a row at up to 8
  rows with the int8 packs takes the fused structure, per layer:
  ``quant_gemv_int8`` for q|k|v with ln1 and ``bqkv`` fused;
  ``decode_attention`` without its wo (``decode_attention_int8`` on an int8
  cache), which appends the token in place; ``quant_gemv_int8`` for wo with
  its bias and the residual; ``quant_gemv_int8`` for the cross q with
  ``ln_x``; ``flash_attention`` at Tq 1, not causal, over the cross K/V;
  ``quant_gemv_int8`` for the cross wo with the residual; ``quant_mlp_int8``
  (ln2, up, GELU, down, residual). Then the lm_head GEMV with ``dec_ln``
  fused, returning f32 logits or the greedy token (its fused argmax over
  the first ``vocab_size`` columns: the padded columns never win). More
  rows, more tokens or ``fuse=False`` take the unfused structure: plain
  norms, ``quant_matmul_int8`` projections, the residual added outside;
  one token a row still takes the KV kernel, a prompt of T > 1 writes its
  k/v into the cache and attends causally with ``flash_attention`` at its
  ``q_offset`` / ``kv_len`` (``decoder._attention``).

**Dense weights** (a tree with no int8 pack: ``init_params``,
``from_hf_whisper``, ``params_from_jax`` of a dense tree, ``models.lift``)
take the JAX package's ``_mm`` on a dense matrix (``encoder_decoder.py:
141-163``) with the attention its TPU branch picks: every projection a
plain matmul in IEEE f32 (``ieee.matmul``, the JAX ``dispatch.matmul`` at
HIGHEST precision) plus its bias (and GELU) in the model dtype, with the
unfused structure at every row count: ``decode_attention`` without its wo
for one token a row (``decode_attention_int8`` on an int8 cache), causal
``flash_attention`` for a prompt, non-causal ``flash_attention`` for the
encoder and the cross attention, and the tied head ``x @ tok_emb``ᵀ after
``dec_ln``. A tree that mixes packs and dense projections is refused.

Parameters are plain dicts of tensors under the JAX package's names.
``quantize_params_int8`` (or ``params_from_jax`` of a quantized tree) makes
the decode layout by the JAX package's rules: int8 packs
(``kernels.quant_matmul.int8_pack``) for every projection of ≥ 2^16
elements whose K is a multiple of 128 (N zero-padded to 128), a tied
``lm_head_q`` from ``tok_emb``ᵀ, each decoder layer's q|k|v fused into
``wqkv`` with ``bqkv`` (zeros for Whisper's biasless k), every per-channel
vector as f32 ``[N]``; the convolutions and embeddings stay dense in the
model dtype.

Numbers differ from the JAX package's where its rounding does (each held
by a test): the port's norms round the normalized rows to the model dtype
once and scale and shift them in f32 (the JAX ``_layer_norm`` rounds after
each); a projection's bias is added in f32 in the matmul's epilogue before
its one rounding (the JAX ``_mm(x, w) + b`` rounds, then adds); the
kernels' GELU takes erf from a polynomial (``kernels.activations``, within
1.5e-7 of the exact erf); the KV scales are ``absmax / 127`` by IEEE
division.

Entry points default to ``device="cuda"`` and raise on a machine without
CUDA; ``device="cpu"`` runs the kernels' plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar

import numpy as np
import torch
import torch.nn.functional as F

from rten_tpu_torch.kernels.attention import flash_attention
from rten_tpu_torch.kernels.decode_attention import decode_attention, decode_attention_int8
from rten_tpu_torch.kernels.dispatch import resolve_device
from rten_tpu_torch.kernels.quant_matmul import (
    MAX_ROWS,
    int8_pack,
    quant_gemv_int8,
    quant_matmul_int8,
    quant_mlp_int8,
    quantize_weights_int8,
)
from rten_tpu_torch.models import decoder
from rten_tpu_torch.models.ieee import conv1d


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    """The JAX package's ``EncDecConfig`` (``encoder_decoder.py:43``),
    whisper-tiny's widths by default."""

    n_mels: int = 80
    n_audio_ctx: int = 1500
    vocab_size: int = 51865
    d_model: int = 384
    n_heads: int = 6
    n_audio_layers: int = 4
    n_text_layers: int = 4
    d_ff: int = 1536
    max_text_ctx: int = 448
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    int8_kv: bool = False
    norm: ClassVar[str] = "layernorm"  # every norm is a LayerNorm (``decoder._norm`` reads it)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


WHISPER_TINY = EncDecConfig()

_MATRICES = ("wq", "wk", "wv", "wo", "w_up", "w_down", "wqkv", "lm_head_q")
_DENSE = ("tok_emb", "pos_emb", "enc_conv1", "enc_conv1_b", "enc_conv2", "enc_conv2_b")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_params(seed: int, cfg: EncDecConfig = WHISPER_TINY, device="cuda") -> dict:
    """Random dense params from a numpy seed in the JAX package's tree
    (``init_params``, :96): normal 0.02 weights, zero biases, unit norm
    scales; linear weights ``[in, out]``, convolutions ``[out, in, 3]``;
    Whisper's k projections without a bias."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    d, ff = cfg.d_model, cfg.d_ff

    def dense(*shape):
        w = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
        return torch.from_numpy(w).to(dev, cfg.dtype)

    def zeros(n):
        return torch.zeros(n, dtype=cfg.dtype, device=dev)

    def ln():
        return {"scale": torch.ones(d, dtype=cfg.dtype, device=dev), "bias": zeros(d)}

    def attn():
        return {"wq": dense(d, d), "bq": zeros(d), "wk": dense(d, d), "wv": dense(d, d), "bv": zeros(d),
                "wo": dense(d, d), "bo": zeros(d)}

    def mlp():
        return {"w_up": dense(d, ff), "b_up": zeros(ff), "w_down": dense(ff, d), "b_down": zeros(d)}

    enc_layers = [{"ln1": ln(), "attn": attn(), "ln2": ln(), "mlp": mlp()} for _ in range(cfg.n_audio_layers)]
    dec_layers = [{"ln1": ln(), "self_attn": attn(), "ln_x": ln(), "cross_attn": attn(), "ln2": ln(), "mlp": mlp()}
                  for _ in range(cfg.n_text_layers)]
    return {
        "enc_conv1": dense(d, cfg.n_mels, 3), "enc_conv1_b": zeros(d),
        "enc_conv2": dense(d, d, 3), "enc_conv2_b": zeros(d),
        "enc_layers": enc_layers, "enc_ln_post": ln(),
        "tok_emb": dense(cfg.vocab_size, d), "pos_emb": dense(cfg.max_text_ctx, d),
        "dec_layers": dec_layers, "dec_ln": ln(),
    }


def quantize_params_int8(params: dict, device="cuda") -> dict:
    """INT8 decode params from dense ones by the JAX package's rules
    (``quantize_params_int8``, :166): every projection matrix of ≥ 2^16
    elements whose K is a multiple of 128 is quantized per output channel
    after zero-padding N to a multiple of 128 (smaller ones stay dense);
    the tied ``lm_head_q`` from ``tok_emb``ᵀ; each decoder layer's
    self-attention q|k|v fused into ``wqkv`` and ``bqkv`` (zeros for the
    biasless k) where the fused matrix meets the same rule and its N is a
    multiple of 128. The packs are the port's ``int8_pack`` layout (the JAX
    package's tiled GEMV stripes are a TPU layout); convolutions and
    embeddings stay dense; every other vector becomes f32 ``[N]``."""
    dev = resolve_device(device)
    dtype = params["tok_emb"].dtype

    def matrix(arr: np.ndarray):
        if arr.ndim == 2 and arr.size >= decoder._QUANT_MIN_SIZE and arr.shape[0] % 128 == 0:
            pad_n = -arr.shape[1] % 128
            if pad_n:
                arr = np.pad(arr, ((0, 0), (0, pad_n)))
            return int8_pack(*quantize_weights_int8(arr, axis=-1), device=dev)
        return torch.from_numpy(arr).to(dev, dtype)

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, key) for v in node]
        if key in _DENSE:
            return node.to(dev)
        if key in _MATRICES:
            return matrix(decoder._np_f32(node))
        return torch.from_numpy(decoder._np_f32(node).reshape(-1).copy()).to(dev)

    out = walk(params)
    out["lm_head_q"] = matrix(decoder._np_f32(params["tok_emb"]).T.copy())
    for src, dst in zip(params["dec_layers"], out["dec_layers"]):
        a_src, a_dst = src["self_attn"], dst["self_attn"]
        fused = np.concatenate([decoder._np_f32(a_src[k]) for k in ("wq", "wk", "wv")], axis=1)
        if not (fused.size >= decoder._QUANT_MIN_SIZE and fused.shape[0] % 128 == 0 and fused.shape[1] % 128 == 0):
            continue
        a_dst["wqkv"] = int8_pack(*quantize_weights_int8(fused, axis=-1), device=dev)
        bq, bv = decoder._np_f32(a_src["bq"]).reshape(-1), decoder._np_f32(a_src["bv"]).reshape(-1)
        bk = np.zeros(fused.shape[1] - bq.size - bv.size, np.float32)
        a_dst["bqkv"] = torch.from_numpy(np.concatenate([bq, bk, bv])).to(dev)
        for k in ("wq", "wk", "wv", "bq", "bv"):
            a_dst.pop(k, None)
    return out


def params_from_jax(tree: dict, cfg: EncDecConfig, device="cuda") -> dict:
    """Carry a JAX package params tree across (leaves as numpy arrays or
    anything ``np.asarray`` takes). A dense tree gives dense port params in
    ``cfg.dtype``; a quantized one (``rten_tpu`` ``quantize_params_int8``)
    the port's decode layout directly: row-major ``[K, N]`` and tiled
    ``[S, K, bn]`` packs become ``int8_pack``s (the tiled ones untiled, N as
    the JAX package padded it), ``[1, N]`` vectors f32 ``[N]``."""
    return decoder.carry_tree(tree, cfg.dtype, _DENSE + _MATRICES, resolve_device(device))


def from_hf_whisper(hf_state: dict, cfg: EncDecConfig, dtype=None, device="cuda") -> dict:
    """Dense port params from a HuggingFace ``WhisperModel`` /
    ``WhisperForConditionalGeneration`` state dict (torch tensors or numpy
    arrays): a copy of ``rten_tpu/models/encoder_decoder.py:748``. nn.Linear
    weights are ``[out, in]``, so they are transposed; Whisper's k_proj has
    no bias; the encoder's sinusoidal positions are recomputed, not read."""
    g = decoder._hf_getter(hf_state, ("", "model."), resolve_device(device), dtype or cfg.dtype)

    def t(name):
        return g(name).t().contiguous()

    def attn(p):
        return {"wq": t(p + "q_proj.weight"), "bq": g(p + "q_proj.bias"), "wk": t(p + "k_proj.weight"),
                "wv": t(p + "v_proj.weight"), "bv": g(p + "v_proj.bias"),
                "wo": t(p + "out_proj.weight"), "bo": g(p + "out_proj.bias")}

    def ln(p):
        return {"scale": g(p + "weight"), "bias": g(p + "bias")}

    def mlp(p):
        return {"w_up": t(p + "fc1.weight"), "b_up": g(p + "fc1.bias"),
                "w_down": t(p + "fc2.weight"), "b_down": g(p + "fc2.bias")}

    params: dict = {
        "enc_conv1": g("encoder.conv1.weight"), "enc_conv1_b": g("encoder.conv1.bias"),
        "enc_conv2": g("encoder.conv2.weight"), "enc_conv2_b": g("encoder.conv2.bias"),
        "enc_ln_post": ln("encoder.layer_norm."),
        "tok_emb": g("decoder.embed_tokens.weight"), "pos_emb": g("decoder.embed_positions.weight"),
        "dec_ln": ln("decoder.layer_norm."),
        "enc_layers": [], "dec_layers": [],
    }
    for i in range(cfg.n_audio_layers):
        p = f"encoder.layers.{i}."
        params["enc_layers"].append({"ln1": ln(p + "self_attn_layer_norm."), "attn": attn(p + "self_attn."),
                                     "ln2": ln(p + "final_layer_norm."), "mlp": mlp(p)})
    for i in range(cfg.n_text_layers):
        p = f"decoder.layers.{i}."
        params["dec_layers"].append({"ln1": ln(p + "self_attn_layer_norm."), "self_attn": attn(p + "self_attn."),
                                     "ln_x": ln(p + "encoder_attn_layer_norm."),
                                     "cross_attn": attn(p + "encoder_attn."),
                                     "ln2": ln(p + "final_layer_norm."), "mlp": mlp(p)})
    return params


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def _pack(node: dict, key: str) -> dict:
    pack = node.get(key)
    if not (isinstance(pack, dict) and "qt" in pack):
        raise ValueError(f"{key} is not an int8 pack: the encoder-decoder needs quantize_params_int8 (or "
                         "params_from_jax of quantized params), with every projection ≥ 2^16 elements, "
                         "or dense weights throughout")
    return pack


def _is_dense(params: dict) -> bool:
    """Whether no projection of ``params`` is an int8 pack (the dense route)."""
    def packs(node):
        if isinstance(node, dict):
            return "qt" in node or any(packs(v) for v in node.values())
        if isinstance(node, list):
            return any(packs(v) for v in node)
        return False

    return not packs(params)


def _weight(node: dict, key: str, dense: bool):
    """A projection's weight: the dense matrix on the dense route, else its
    int8 pack (``_pack``, which refuses a dense one)."""
    return node[key] if dense else _pack(node, key)


def _proj(x, w, bias=None, activation=None, **kw):
    """``x @ W + bias`` (+ ``activation``): an int8 pack through
    ``quant_matmul_int8`` (bias in f32 in the epilogue; 8 rows or fewer go
    to the GEMV), a dense matrix through ``decoder._dense_proj``."""
    if isinstance(w, dict):
        return quant_matmul_int8(x, w["qt"], w["s"], bias, activation=activation, **kw)
    return decoder._dense_proj(x, w, bias, activation)


def _heads(x, b: int, t: int, h: int):
    """Rows [B·T, H·D] as a [B, H, T, D] view."""
    return x.view(b, t, h, -1).transpose(1, 2)


def _unheads(attn):
    """``flash_attention``'s [B, H, T, D] (a view of a [B, T, H, D]
    buffer) as rows [B·T, H·D]."""
    b, h, t, hd = attn.shape
    return attn.transpose(1, 2).reshape(b * t, h * hd)


def _sinusoids(length: int, d: int) -> np.ndarray:
    """Whisper's sinusoidal positions (``encoder_decoder.py:289``)."""
    log_timescale = np.log(10000.0) / (d // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(d // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def _gelu(x, dtype):
    """The exact-erf GELU in f32, rounded to ``dtype``
    (``jax.nn.gelu(approximate=False)``)."""
    return F.gelu(x.float()).to(dtype)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def encode(params: dict, cfg: EncDecConfig, mel) -> torch.Tensor:
    """mel [B, n_mels, T_audio] → encoder states [B, T_audio / 2, d] in
    ``cfg.dtype``, on mel's device."""
    x = mel.to(cfg.dtype)
    x = _gelu(conv1d(x, params["enc_conv1"], padding=1) + params["enc_conv1_b"][None, :, None], cfg.dtype)
    x = _gelu(conv1d(x, params["enc_conv2"], stride=2, padding=1) + params["enc_conv2_b"][None, :, None],
              cfg.dtype)
    b, d, t = x.shape
    pos = torch.from_numpy(_sinusoids(t, d)).to(x.device, cfg.dtype)
    x = (x.transpose(1, 2) + pos[None]).reshape(b * t, d)
    h = cfg.n_heads
    dense = _is_dense(params)
    for layer in params["enc_layers"]:
        a, m = layer["attn"], layer["mlp"]
        xn = decoder._norm(x, layer["ln1"], cfg)
        q = _heads(_proj(xn, _weight(a, "wq", dense), a["bq"]), b, t, h)
        k = _heads(_proj(xn, _weight(a, "wk", dense)), b, t, h)
        v = _heads(_proj(xn, _weight(a, "wv", dense), a["bv"]), b, t, h)
        x = x + _proj(_unheads(flash_attention(q, k, v, causal=False)), _weight(a, "wo", dense), a["bo"])
        hidden = _proj(decoder._norm(x, layer["ln2"], cfg), _weight(m, "w_up", dense), m["b_up"],
                       activation="gelu")
        x = x + _proj(hidden, _weight(m, "w_down", dense), m["b_down"])
    return decoder._norm(x, params["enc_ln_post"], cfg).view(b, t, d)


# ---------------------------------------------------------------------------
# Decoder state
# ---------------------------------------------------------------------------


def init_decoder_state(params: dict, cfg: EncDecConfig, enc_states, max_len: int | None = None) -> dict:
    """The cross K/V of every decoder layer, projected once from the
    encoder states [B, S_audio, d] (``cross_k`` / ``cross_v``: [B, H,
    S_audio, D] views of the projections), and an empty self-attention
    cache of ``max_len`` (default ``max_text_ctx``) positions in the port
    decoder's layout (``k``, ``v``, with ``cfg.int8_kv`` int8 and
    ``k_scale`` / ``v_scale``; ``len`` and ``host_len``), on the encoder
    states' device."""
    b, s, d = enc_states.shape
    e2 = enc_states.reshape(b * s, d)
    state = {"cross_k": [], "cross_v": []}
    dense = _is_dense(params)
    for layer in params["dec_layers"]:
        c = layer["cross_attn"]
        state["cross_k"].append(_heads(_proj(e2, _weight(c, "wk", dense)), b, s, cfg.n_heads))
        state["cross_v"].append(_heads(_proj(e2, _weight(c, "wv", dense), c["bv"]), b, s, cfg.n_heads))
    cache_cfg = decoder.DecoderConfig(vocab_size=cfg.vocab_size, n_layers=cfg.n_text_layers, n_heads=cfg.n_heads,
                                      d_model=cfg.d_model, d_ff=cfg.d_ff, max_seq=cfg.max_text_ctx,
                                      int8_kv=cfg.int8_kv, dtype=cfg.dtype)
    state.update(decoder.init_cache(cache_cfg, b, max_len or cfg.max_text_ctx, enc_states.device))
    return state


# ---------------------------------------------------------------------------
# Decoder forward
# ---------------------------------------------------------------------------


def _fused_ok(params: dict, cfg: EncDecConfig, b: int, t: int) -> bool:
    """The JAX package's condition for the fused one-token step
    (``encoder_decoder.py:515-531``): one token, at most 8 rows, the fused
    ``wqkv``, int8 packs for every projection, and the whole-MLP kernel's
    budget (``decoder.mlp_fused_supported``)."""
    l0 = params["dec_layers"][0]
    packs = (l0["self_attn"].get("wqkv"), l0["self_attn"].get("wo"), l0["cross_attn"].get("wq"),
             l0["cross_attn"].get("wo"), l0["mlp"].get("w_up"), l0["mlp"].get("w_down"))
    return (t == 1 and b <= MAX_ROWS and all(isinstance(p, dict) and "qt" in p for p in packs)
            and decoder.mlp_fused_supported(cfg.d_model, cfg.d_ff))


def _gemv_ln(x, pack, bias, ln, eps, **kw):
    """A one-token GEMV with the LayerNorm ``ln`` fused in."""
    return quant_gemv_int8(x, pack["qt"], pack["s"], bias, norm="layernorm", norm_scale=ln["scale"],
                           norm_bias=ln["bias"], norm_eps=eps, **kw)


def _lm_head(params: dict, cfg: EncDecConfig, x, mode: str, dense: bool = False):
    """``dec_ln`` + the tied int8 ``lm_head_q`` of the rows x [M, d]: f32
    logits [M, vocab] or (``mode="argmax"``) the greedy tokens int32 [M].
    Up to 8 rows through ``quant_gemv_int8`` with the norm fused (its argmax
    over the first ``vocab_size`` columns), more through the norm and
    ``quant_matmul_int8``. On the dense route, the norm and ``x @
    tok_emb``ᵀ in IEEE f32 (``decoder._dense_lm_head``)."""
    if dense:
        return decoder._dense_lm_head({"final_norm": params["dec_ln"], "tok_emb": params["tok_emb"]}, cfg, x, mode)
    head, ln = _pack(params, "lm_head_q"), params["dec_ln"]
    if x.shape[0] <= MAX_ROWS:
        if mode == "argmax":
            return _gemv_ln(x, head, None, ln, cfg.layer_norm_eps, argmax_n=cfg.vocab_size)
        return _gemv_ln(x, head, None, ln, cfg.layer_norm_eps, out_dtype=torch.float32)[:, : cfg.vocab_size]
    logits = _proj(decoder._norm(x, ln, cfg), head, out_dtype=torch.float32)[:, : cfg.vocab_size]
    return logits.argmax(-1).to(torch.int32) if mode == "argmax" else logits


def decode(params: dict, cfg: EncDecConfig, tokens, state: dict, *, lm_head_mode="logits",
           last_only: bool = False, fuse: bool = True):
    """Decoder forward of ``tokens`` [B, T] appended at ``state["len"]``
    (the self-attention cache is written in place, lengths advanced).

    Returns ``(result, state)``: f32 logits [B, T, vocab] (not rounded to
    the model dtype, unlike the JAX package's), or with
    ``lm_head_mode="argmax"`` the greedy tokens int32 [B, T]; with
    ``last_only`` the lm_head runs on the last position only ([B, 1, …]).
    IndexError, before any kernel runs, when the T tokens do not fit.
    ``fuse=False`` takes the unfused structure at any row count (the JAX
    package's ``fused=False``)."""
    if lm_head_mode not in ("logits", "argmax"):
        raise ValueError(f"lm_head_mode must be 'logits' or 'argmax', got {lm_head_mode!r}")
    b, t = tokens.shape
    h, d, eps = cfg.n_heads, cfg.d_model, cfg.layer_norm_eps
    decoder._check_room(state, t)
    start = state["len"]
    positions = start[:, None] + torch.arange(t, device=start.device)
    x = params["tok_emb"].index_select(0, tokens.reshape(-1)) + params["pos_emb"].index_select(
        0, positions.reshape(-1))
    dense = _is_dense(params)
    fused = fuse and not dense and _fused_ok(params, cfg, b, t)
    int8 = "k_scale" in state
    for li, layer in enumerate(params["dec_layers"]):
        a, c, m = layer["self_attn"], layer["cross_attn"], layer["mlp"]
        # Self attention.
        if fused:
            qkv = _gemv_ln(x, a["wqkv"], a.get("bqkv"), layer["ln1"], eps)
        else:
            xn = decoder._norm(x, layer["ln1"], cfg)
            if "wqkv" in a:
                qkv = _proj(xn, a["wqkv"], a.get("bqkv"))
            else:
                qkv = torch.cat([_proj(xn, _weight(a, "wq", dense), a["bq"]), _proj(xn, _weight(a, "wk", dense)),
                                 _proj(xn, _weight(a, "wv", dense), a["bv"])], 1)
        qkv = qkv.view(b, t, 3, h, cfg.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # [B, T, H, D]
        if t == 1:
            ops = (q[:, 0], k[:, 0], v[:, 0])
            if int8:
                attn = decode_attention_int8(ops, state["k"][li], state["v"][li], state["k_scale"][li],
                                             state["v_scale"][li], start)
            else:
                attn = decode_attention(ops, state["k"][li], state["v"][li], start)
        else:
            attn = decoder._attention(q, k, v, state, li, start, start + t)
        wo = _weight(a, "wo", dense)
        if fused:
            x = quant_gemv_int8(attn, wo["qt"], wo["s"], a["bo"], residual=x)
        else:
            x = x + _proj(attn, wo, a["bo"])
        # Cross attention over the precomputed encoder K/V.
        wq_x, wo_x = _weight(c, "wq", dense), _weight(c, "wo", dense)
        if fused:
            qx = _gemv_ln(x, wq_x, c["bq"], layer["ln_x"], eps)
        else:
            qx = _proj(decoder._norm(x, layer["ln_x"], cfg), wq_x, c["bq"])
        attn_x = _unheads(flash_attention(_heads(qx, b, t, h), state["cross_k"][li], state["cross_v"][li],
                                          causal=False))
        if fused:
            x = quant_gemv_int8(attn_x, wo_x["qt"], wo_x["s"], c["bo"], residual=x)
        else:
            x = x + _proj(attn_x, wo_x, c["bo"])
        # MLP.
        up, down = _weight(m, "w_up", dense), _weight(m, "w_down", dense)
        if fused:
            x = quant_mlp_int8(x, up["qt"], up["s"], down["qt"], down["s"], m["b_up"], m["b_down"],
                               activation="gelu", norm="layernorm", norm_scale=layer["ln2"]["scale"],
                               norm_bias=layer["ln2"]["bias"], norm_eps=eps, residual=x)
        else:
            hidden = _proj(decoder._norm(x, layer["ln2"], cfg), up, m["b_up"], activation="gelu")
            x = x + _proj(hidden, down, m["b_down"])

    head_in = x.view(b, t, d)[:, -1] if last_only and t > 1 else x
    result = _lm_head(params, cfg, head_in.contiguous(), lm_head_mode, dense)
    result = result.reshape(b, 1 if last_only else t, *result.shape[1:])
    state["len"].add_(t)
    state["host_len"] += t
    return result, state


decode_step = decode
