"""GPT-2-class decoder on PyTorch and CUDA: INT8 weight-only greedy decode
over a preallocated KV cache.

Counterpart of ``rten_tpu/models/decoder.py`` for its decode configuration:
every forward takes one token per row (T = 1) and runs the fused decode
structure of the TPU path, three hand-written kernels per layer:

- layer 0's qkv: ``quant_gemv_int8`` with ln1 fused in;
- each layer's attention: ``decode_attention`` on the packed q|k|v, with
  the in-place cache append and the fused int8 wo + bias + residual;
- each layer's MLP: ``quant_mlp_int8`` (ln2, up, GELU, down, residual),
  which in every layer but the last also computes the next layer's ln1 and
  qkv;
- the lm_head: ``quant_gemv_int8`` with the final norm fused in, returning
  the greedy token (fused argmax) or the logits.

A prompt goes through the same step one token at a time (``prefill``);
multi-token prefill with its own two kernels comes later.

Parameters are plain dicts of tensors. Dense parameters mirror the JAX
package's names; ``quantize_params_int8`` (or ``params_from_jax`` of an
already quantized tree) gives the decode layout: int8 packs
``{"qt": int8 [N, K], "s": f32 [N]}`` (``kernels.quant_matmul.int8_pack``),
the fused ``wqkv``/``bqkv``, the tied ``lm_head_q``, and every per-channel
vector as f32 ``[N]``. The KV cache is logical ``[B, H, S, D]`` per layer
and is updated in place.

Entry points default to ``device="cuda"`` and raise on a machine without
CUDA; ``device="cpu"`` runs the kernels' plain versions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rten_tpu_torch.kernels.decode_attention import decode_attention
from rten_tpu_torch.kernels.dispatch import resolve_device
from rten_tpu_torch.kernels.quant_matmul import (
    int8_pack,
    quant_gemv_int8,
    quant_mlp_int8,
    quantize_weights_int8,
)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """The fields of the JAX package's ``DecoderConfig`` that the decode path
    of this slice runs: MHA with learned positions. RoPE, grouped-query
    attention, SwiGLU, position offsets, untied lm_heads and the int8 KV
    cache come with later slices."""

    vocab_size: int = 50257
    n_layers: int = 12
    n_heads: int = 12
    d_model: int = 768
    d_ff: int = 3072
    max_seq: int = 1024
    norm: str = "layernorm"  # "layernorm" | "rmsnorm"
    activation: str = "gelu"  # "gelu" | "relu"
    layer_norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


GPT2_SMALL = DecoderConfig()

_QUANT_MIN_SIZE = 1 << 16  # a matrix is quantized at ≥ 2^16 elements (as in the JAX package)
_EMBEDDINGS = ("tok_emb", "pos_emb")
_MATRICES = ("wq", "wk", "wv", "wo", "w_up", "w_down", "wqkv", "lm_head_q")


def _check_supported(cfg: DecoderConfig) -> None:
    """The decode path of this slice: GPT-2-class blocks with a kernel
    epilogue activation and lane-aligned widths (no K padding of the int8
    packs)."""
    problems = []
    if cfg.activation not in ("gelu", "relu"):
        problems.append(f"activation={cfg.activation!r}")
    if cfg.norm not in ("layernorm", "rmsnorm"):
        problems.append(f"norm={cfg.norm!r}")
    if cfg.d_model % 128 or cfg.d_ff % 128:
        problems.append("d_model or d_ff not a multiple of 128")
    if problems:
        raise NotImplementedError(
            "rten_tpu_torch's decoder runs GPT-2-class models only so far; "
            "unsupported: " + ", ".join(problems)
        )


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_params(seed: int, cfg: DecoderConfig, device="cuda") -> dict:
    """Random dense params of a GPT-2-class config from a numpy seed (normal
    0.02 weights, zero biases, unit norm scales), in ``cfg.dtype`` on
    ``device``."""
    dev = resolve_device(device)
    _check_supported(cfg)
    rng = np.random.default_rng(seed)

    def dense(shape):
        w = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
        return torch.from_numpy(w).to(dev, cfg.dtype)

    def zeros(n):
        return torch.zeros(n, dtype=cfg.dtype, device=dev)

    def norm_params():
        p = {"scale": torch.ones(cfg.d_model, dtype=cfg.dtype, device=dev)}
        if cfg.norm == "layernorm":
            p["bias"] = zeros(cfg.d_model)
        return p

    d, ff, hd = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.head_dim
    params: dict = {
        "tok_emb": dense((cfg.vocab_size, d)),
        "pos_emb": dense((cfg.max_seq, d)),
        "final_norm": norm_params(),
        "layers": [],
    }
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "ln1": norm_params(), "ln2": norm_params(),
            "wq": dense((d, hd)), "wk": dense((d, hd)), "wv": dense((d, hd)), "wo": dense((hd, d)),
            "bq": zeros(hd), "bk": zeros(hd), "bv": zeros(hd), "bo": zeros(d),
            "w_up": dense((d, ff)), "b_up": zeros(ff), "w_down": dense((ff, d)), "b_down": zeros(d),
        })
    return params


def _np_f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t, np.float32)


def quantize_params_int8(params: dict, device="cuda") -> dict:
    """Weight-only INT8 decode params from dense ones, by the JAX package's
    rules (``rten_tpu/models/decoder.py`` ``quantize_params_int8``): every
    2-D matrix of ≥ 2^16 elements is quantized per output channel after
    zero-padding K to a multiple of 128 and N to a multiple of 1024 (N ≥
    8192) or 128; smaller matrices stay dense; q|k|v fuse into ``wqkv``
    (and their biases into ``bqkv``) when their width is a multiple of 128;
    tied embeddings get their own ``lm_head_q``. Embeddings stay dense in
    their dtype; every vector becomes f32 ``[N]``."""
    dev = resolve_device(device)
    dtype = params["tok_emb"].dtype

    def matrix(arr: np.ndarray):
        if arr.ndim == 2 and arr.size >= _QUANT_MIN_SIZE:
            pad_k = -arr.shape[0] % 128
            pad_n = -arr.shape[1] % (1024 if arr.shape[1] >= 8192 else 128)
            if pad_k or pad_n:
                arr = np.pad(arr, ((0, pad_k), (0, pad_n)))
            return int8_pack(*quantize_weights_int8(arr, axis=-1), device=dev)
        return torch.from_numpy(arr).to(dev, dtype)

    def vector(t):
        return torch.from_numpy(_np_f32(t).reshape(-1)).to(dev)

    def walk(node, key=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, key) for v in node]
        if key in _EMBEDDINGS:
            return node.to(dev)
        if key in _MATRICES:
            return matrix(_np_f32(node))
        return vector(node)

    src_layers = params["layers"]
    out = walk({k: v for k, v in params.items() if k != "layers"})
    out["layers"] = []
    for src in src_layers:
        layer = {}
        widths = [src[k].shape[1] for k in ("wq", "wk", "wv")]
        fuse = sum(widths) % 128 == 0
        for k, v in src.items():
            if fuse and k in ("wq", "wk", "wv", "bq", "bk", "bv"):
                continue
            layer[k] = walk(v, k)
        if fuse:
            layer["wqkv"] = matrix(np.concatenate([_np_f32(src[k]) for k in ("wq", "wk", "wv")], 1))
            if "bq" in src:
                layer["bqkv"] = torch.cat([vector(src[k]) for k in ("bq", "bk", "bv")])
        out["layers"].append(layer)
    out["lm_head_q"] = matrix(_np_f32(params["tok_emb"]).T.copy())
    return out


def params_from_jax(tree: dict, cfg: DecoderConfig, device="cuda") -> dict:
    """Carry a JAX package params tree across (leaves as numpy arrays or
    anything ``np.asarray`` takes). A dense tree gives dense port params in
    ``cfg.dtype``; a quantized tree (``rten_tpu`` ``quantize_params_int8``)
    gives the port's decode layout directly: row-major ``[K, N]`` and tiled
    ``[S, K, bn]`` packs become ``int8_pack``s, the ``slabs`` duplicates are
    dropped, and ``[1, N]`` vectors become f32 ``[N]``."""
    dev = resolve_device(device)
    if "lm_head" in tree:
        raise NotImplementedError("an untied lm_head is not ported yet: the decode path ties it to tok_emb")

    def is_pack(node):
        return isinstance(node, dict) and set(node) == {"q", "s"}

    def has_pack(node):
        if is_pack(node):
            return True
        if isinstance(node, dict):
            return any(has_pack(v) for v in node.values())
        if isinstance(node, list):
            return any(has_pack(v) for v in node)
        return False

    quantized = has_pack(tree)

    def conv(node, key=""):
        if is_pack(node):
            return int8_pack(np.asarray(node["q"]), np.asarray(node["s"]), device=dev)
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items() if k != "slabs"}
        if isinstance(node, list):
            return [conv(v, key) for v in node]
        arr = np.asarray(node, np.float32)
        if key in _EMBEDDINGS or key in _MATRICES:
            return torch.from_numpy(arr.copy()).to(dev, cfg.dtype)
        vec = torch.from_numpy(arr.reshape(-1).copy()).to(dev)
        return vec if quantized else vec.to(cfg.dtype)

    return conv(tree)


def from_hf_gpt2(hf_state: dict, cfg: DecoderConfig, dtype=None, device="cuda") -> dict:
    """Dense port params from a HuggingFace ``GPT2LMHeadModel``/``GPT2Model``
    state dict (torch tensors or numpy arrays). GPT-2's Conv1D weights are
    already ``[in, out]``, so nothing is transposed."""
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype

    def g(name):
        key = name if name in hf_state else "transformer." + name
        return torch.from_numpy(_np_f32(hf_state[key]).copy()).to(dev, dtype)

    params: dict = {
        "tok_emb": g("wte.weight"),
        "pos_emb": g("wpe.weight"),
        "final_norm": {"scale": g("ln_f.weight"), "bias": g("ln_f.bias")},
        "layers": [],
    }
    d = cfg.d_model
    for i in range(cfg.n_layers):
        p = f"h.{i}."
        c_attn_w = g(p + "attn.c_attn.weight")  # [D, 3D]
        c_attn_b = g(p + "attn.c_attn.bias")
        params["layers"].append(
            {
                "ln1": {"scale": g(p + "ln_1.weight"), "bias": g(p + "ln_1.bias")},
                "ln2": {"scale": g(p + "ln_2.weight"), "bias": g(p + "ln_2.bias")},
                "wq": c_attn_w[:, :d].contiguous(),
                "bq": c_attn_b[:d].contiguous(),
                "wk": c_attn_w[:, d : 2 * d].contiguous(),
                "bk": c_attn_b[d : 2 * d].contiguous(),
                "wv": c_attn_w[:, 2 * d :].contiguous(),
                "bv": c_attn_b[2 * d :].contiguous(),
                "wo": g(p + "attn.c_proj.weight"),
                "bo": g(p + "attn.c_proj.bias"),
                "w_up": g(p + "mlp.c_fc.weight"),
                "b_up": g(p + "mlp.c_fc.bias"),
                "w_down": g(p + "mlp.c_proj.weight"),
                "b_down": g(p + "mlp.c_proj.bias"),
            }
        )
    return params


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def init_cache(cfg: DecoderConfig, batch: int, max_len: int | None = None, device="cuda") -> dict:
    """Preallocated KV cache: per-layer k/v ``[B, H, S, D]`` in cfg.dtype
    and the valid length of each row, int32 ``[B]``, all on the device, and
    the same length kept on the host (``host_len``; every row advances
    together), so that ``forward`` refuses a full cache without reading the
    device. ``forward`` writes each new token in place and advances both."""
    dev = resolve_device(device)
    shape = (batch, cfg.n_heads, max_len or cfg.max_seq, cfg.head_dim)
    return {
        "k": [torch.zeros(shape, dtype=cfg.dtype, device=dev) for _ in range(cfg.n_layers)],
        "v": [torch.zeros(shape, dtype=cfg.dtype, device=dev) for _ in range(cfg.n_layers)],
        "len": torch.zeros(batch, dtype=torch.int32, device=dev),
        "host_len": 0,
    }


# ---------------------------------------------------------------------------
# Forward (T = 1)
# ---------------------------------------------------------------------------


def _pack(layer, key):
    pack = layer.get(key)
    if not (isinstance(pack, dict) and "qt" in pack):
        raise ValueError(
            f"{key} is not an int8 pack: the decode path needs quantize_params_int8 "
            "(or params_from_jax of quantized params), with every projection ≥ 2^16 elements"
        )
    return pack


def forward(params: dict, cfg: DecoderConfig, tokens, cache: dict, *, lm_head_mode="logits"):
    """One decode step: ``tokens`` [B, 1] are appended at ``cache["len"]``.

    Returns ``(result, cache)``, the cache updated in place. ``result`` is
    the f32 logits [B, 1, vocab] (``lm_head_mode="logits"``; not rounded to
    the model dtype, unlike the JAX package's), the int32
    greedy tokens [B, 1] from the lm_head kernel's fused argmax
    (``"argmax"``), or None (``None``: the lm_head is skipped, as for all
    but the last prompt token). Raises IndexError when the cache is full."""
    _check_supported(cfg)
    b, t = tokens.shape
    if t != 1:
        raise NotImplementedError(
            "forward runs one token per row (the decode step); multi-token "
            "prefill (quant_matmul_int8 + flash_attention) is slice 2 of the "
            "port. prefill() feeds a prompt one token at a time."
        )
    if lm_head_mode not in ("logits", "argmax", None):
        raise ValueError(f"lm_head_mode must be 'logits', 'argmax' or None, got {lm_head_mode!r}")
    h, hd, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    eps = cfg.layer_norm_eps
    s_max = cache["k"][0].shape[2]
    if cache["host_len"] >= s_max:
        raise IndexError(f"KV cache full: {cache['host_len']} tokens fill its {s_max} positions")
    start = cache["len"]
    x = params["tok_emb"].index_select(0, tokens.reshape(-1)) + params["pos_emb"].index_select(0, start)

    layers = params["layers"]
    first = layers[0]
    wqkv = _pack(first, "wqkv")
    qkv = quant_gemv_int8(
        x, wqkv["qt"], wqkv["s"], first.get("bqkv"), norm=cfg.norm,
        norm_scale=first["ln1"]["scale"], norm_bias=first["ln1"].get("bias"), norm_eps=eps,
    )
    for li, layer in enumerate(layers):
        wo = _pack(layer, "wo")
        x = decode_attention(
            qkv.view(b, 3, h, 1, hd), cache["k"][li], cache["v"][li], start,
            wo["qt"], wo["s"], layer.get("bo"), residual=x,
        )
        nxt = layers[li + 1] if li + 1 < len(layers) else None
        next_qkv = None
        if nxt is not None:
            nq = _pack(nxt, "wqkv")
            next_qkv = (nq["qt"], nq["s"], nxt.get("bqkv"), nxt["ln1"]["scale"], nxt["ln1"].get("bias"))
        up, down = _pack(layer, "w_up"), _pack(layer, "w_down")
        out = quant_mlp_int8(
            x, up["qt"], up["s"], down["qt"], down["s"], layer.get("b_up"), layer.get("b_down"),
            activation=cfg.activation, norm=cfg.norm, norm_scale=layer["ln2"]["scale"],
            norm_bias=layer["ln2"].get("bias"), norm_eps=eps, residual=x, next_qkv=next_qkv,
        )
        if next_qkv is None:
            x = out
        else:
            x, qkv = out

    result = None
    if lm_head_mode is not None:
        head = _pack(params, "lm_head_q")
        fn = params["final_norm"]
        kw = dict(norm=cfg.norm, norm_scale=fn["scale"], norm_bias=fn.get("bias"), norm_eps=eps)
        if lm_head_mode == "argmax":
            result = quant_gemv_int8(x, head["qt"], head["s"], argmax_n=cfg.vocab_size, **kw)
            result = result.view(b, 1)
        else:
            # The epilogue writes f32 logits (the JAX package rounds them to
            # the model dtype first; a sampler wants them unrounded).
            logits = quant_gemv_int8(x, head["qt"], head["s"], out_dtype=torch.float32, **kw)
            result = logits[:, : cfg.vocab_size].reshape(b, 1, cfg.vocab_size)
    cache["len"].add_(1)
    cache["host_len"] += 1
    return result, cache


decode_step = forward


def prefill(params: dict, cfg: DecoderConfig, tokens, cache: dict, *, lm_head_mode="logits",
            last_only: bool = False):
    """Feed ``tokens`` [B, T] through ``forward`` one position at a time.
    Returns ``(result [B, T, …], cache)`` or, with ``last_only``, only the
    last position's result ``[B, 1, …]`` (the lm_head runs once)."""
    n = tokens.shape[1]
    outs = []
    for i in range(n):
        mode = lm_head_mode if (not last_only or i == n - 1) else None
        res, cache = forward(params, cfg, tokens[:, i : i + 1], cache, lm_head_mode=mode)
        if res is not None:
            outs.append(res)
    return torch.cat(outs, dim=1), cache


def generate_greedy(params: dict, cfg: DecoderConfig, cache: dict, last_tokens, n_steps: int):
    """``n_steps`` greedy decode steps from ``last_tokens`` [B, 1], each
    token taken by the lm_head kernel's fused argmax and fed straight back
    on the device. Counterpart of ``generate_scan``'s greedy branch.
    Returns ``(tokens [B, n_steps] int32, cache)``."""
    tok = last_tokens
    out = []
    for _ in range(n_steps):
        tok, cache = forward(params, cfg, tok, cache, lm_head_mode="argmax")
        out.append(tok)
    return torch.cat(out, dim=1), cache
