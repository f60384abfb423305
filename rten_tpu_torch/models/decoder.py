"""GPT-2-class and Llama/Qwen2-class decoders on PyTorch and CUDA: INT8
prefill and decode over a preallocated KV cache, weight-only or
(``cfg.w8a8``) W8A8.

Counterpart of ``rten_tpu/models/decoder.py`` ``forward`` (:584): a forward
takes T ≥ 1 tokens per row, with a cache (appended at its length) or
without (a plain full-sequence forward). The config switches cover GPT-2
(learned positions, LayerNorm, GELU), OPT (learned positions at an offset
of 2, ReLU) and Llama / Qwen2 (RoPE, RMSNorm, SwiGLU, grouped-query
attention with ``n_kv_heads``, an untied lm_head, Qwen2's q/k/v biases).
As on the TPU path, the number of rows B·T picks the structure:

- **B·T ≤ 8: the fused decode structure.** Layer 0's qkv is
  ``quant_gemv_int8`` with ln1 fused in. A GELU/ReLU layer's MLP is
  ``quant_mlp_int8`` (ln2, up, activation, down, residual) when its int8
  weights fit the JAX package's whole-MLP budget (``mlp_fused_supported``),
  and then also computes the next layer's ln1 and qkv when those fit too;
  past the budget it is the up GEMV (ln2 and the activation fused), then
  the down GEMV with the residual. A SwiGLU layer's MLP is the ``w_gu``
  GEMV (or ``w_gate`` and ``w_up``) with ln2 fused, ``silu(gate) · up``,
  then the down GEMV with the residual. Attention at T = 1 with a
  bf16/f32 cache is ``decode_attention`` with the in-place cache append and
  the fused int8 wo + bias + residual; at T > 1 (or without a cache) it is
  ``flash_attention`` over the cache, then wo through ``quant_gemv_int8``
  with the residual fused.
- **B·T > 8: the prefill structure.** Plain-PyTorch norms (``_norm``),
  ``quant_matmul_int8`` for qkv, wo, up (GELU in its epilogue) and down
  (or gate|up and down), the residual adds outside, and causal
  ``flash_attention`` over the cache; one token a row (T = 1, B > 8) takes
  the cache's KV kernel instead (``decode_attention`` without its wo on a
  bf16/f32 cache, ``decode_attention_int8``, the paged pair), then wo
  through the prefill projection, as the JAX package does.

RoPE rotates q and k (rotate-half, in f32, rounded to the model dtype)
after the qkv projection and before any cache append, at each row's own
positions; q, k_new and v_new then reach the attention kernels as separate
operands (``decode_attention``'s unpacked mode), as they do for
grouped-query attention.

The KV cache is bf16/f32 or, with ``cfg.int8_kv``, int8 with one f32
scale per (token, kv head); each row holds its own length. One token per
row on an int8 cache runs ``decode_attention_int8``, on a paged pool's
state (``serve.paged``) ``paged_decode_attention(_int8)``, at any B, each
then wo (``quant_gemv_int8`` with the residual up to 8 rows); more tokens
on an int8 cache take the eager branch (quantize, write, attend over the
prefix dequantized to the model dtype).

**The whole-block decode** (``cfg.mega``; the JAX package's
``RTEN_DECODE_FUSE=mega``): one token at batch 1 on a bf16/f32 cache runs
each layer as one ``decode_block`` kernel (attention, wo, ln2, up,
activation, down, and the next layer's ln1 + qkv), on the layers the JAX
package takes its mega kernel on (``mega_block_supported``, the same weight
shapes and activations gelu, relu or silu; never SwiGLU); every other
forward is unchanged. Its numbers differ from the two-kernel step where the
JAX package's do: the block's hidden state after wo stays f32. Under W8A8
the block stays weight-only (the TPU kernel has no W8A8 mode), while layer
0's qkv and the lm_head run W8A8. MHA without RoPE hands ``decode_block``
the packed q|k|v row, a GQA / MQA or RoPE config its RoPE'd q, k and v
(the JAX package's ``packed_ok`` rule).

The lm_head (the untied ``lm_head`` or the tied ``lm_head_q``) is
``quant_gemv_int8`` with the final norm fused in, returning the greedy
token (fused argmax) or f32 logits, for up to 8 rows, and the final norm
plus ``quant_matmul_int8`` (f32 out) for more. ``prefill`` is one forward;
with ``last_only`` its lm_head runs on the last position only.

**W8A8** (``cfg.w8a8``; the JAX package's ``RTEN_W_CONVERT=w8a8``, read
there once at import): activations are quantized per row to int8 before
each product, which runs s8 × s8 → s32. The JAX package's choices are
mirrored exactly. In the decode structure every GEMV and MLP call runs in
its ``w8a8`` mode, tiled packs included; the int8 wo fused into
``decode_attention`` stays weight-only (the TPU kernel has no such mode).
In the prefill structure every projection is ``quant_matmul_w8a8``, except
packs the JAX package stores tiled (``pack["tiled"]``: its ``_proj`` keeps
them on ``quant_matmul_int8``); that includes its lm_head at ≤ 8 rows
(``last_only``), which runs ``_norm`` and the prefill projection as the
JAX package runs it on every row.

**The per-projection route** (a tree with any dense projection, or with
unfused q/k/v: ``init_params``, ``from_hf_*``, ``params_from_jax`` of a
dense tree, ``models.lift``, ``quantize_params_int8`` below its 2^16-element
threshold or with ``fuse=False``): the JAX package's ``_proj`` on each
matrix as it finds it, which its fused int8 kernel branches (the GEMV with
the norm fused, the MLP, mega, W8A8, the fused wo) never take. After the
plain norm each projection is, for a dense ``[K, N]`` matrix, a plain matmul
in IEEE f32 (``ieee.matmul``; the JAX package's ``dispatch.matmul`` at
HIGHEST precision, outside any Pallas kernel), its bias and activation added
outside, in the model dtype; for an int8 pack, ``quant_matmul_int8`` (the
GEMV at ≤ 8 rows) with its bias and activation in the kernel's epilogue
(``_proj``): the fused ``wqkv`` or ``wq``, ``wk`` and ``wv`` apart, ``wo``
and the MLP's down plus the residual, ``w_gu`` or SwiGLU's ``w_gate`` and
``w_up``. One token a row on a bf16/f32 cache is ``decode_attention``
without its wo, a prompt causal ``flash_attention``; the int8 and paged
caches take their KV kernels as above. The head is the params' ``lm_head``
or tied ``lm_head_q`` (a pack through ``quant_matmul_int8`` in f32, a dense
matrix through ``x @ head``), else the tied ``x @ tok_emb``ᵀ, then the
argmax. ``mega``, ``w8a8`` and ``fuse`` change nothing on this route, and
``d_model`` need not be a multiple of 128. A tree whose every projection is
a pack and whose q/k/v are fused keeps the fused int8 route above.

**Head dims.** One token a row takes the KV kernels at a head dim that
divides 128 (``kv_head_dim_supported``, the JAX rule's head-dim terms); at
any other (80, 96, ...) it is appended to the cache and attends through
``flash_attention`` at Tq 1, as the JAX decoder runs a step its decode
kernels refuse (under a CUDA graph capture over the cache's whole S, as
the speculative verify forward does: ``_attention``). The whole-block kernel takes
every head dim the JAX mega rule admits (every divisor of 128), so a mega
layer runs ``decode_block`` wherever the JAX decoder runs its mega kernel.

Parameters are plain dicts of tensors. Dense parameters mirror the JAX
package's names; ``quantize_params_int8`` (or ``params_from_jax`` of an
already quantized tree) gives the decode layout: int8 packs
``{"qt": int8 [N, K], "s": f32 [N]}`` (``kernels.quant_matmul.int8_pack``,
K and N zero-padded as the JAX package pads them), the fused
``wqkv``/``bqkv`` and (SwiGLU) ``w_gu``, the untied ``lm_head`` or the tied
``lm_head_q``, and every per-channel vector as f32 ``[N]``. The KV cache is
logical ``[B, Hk, S, D]`` per layer (scales ``[B, Hk, S]``) and is updated
in place.

``generate_scan`` runs n one-token decode steps, greedy or sampled, each
token fed straight back on the device; on the card it captures the steps
once as one CUDA graph and replays it. The other decode paths that the JAX
package runs as one compiled program (the backends' one-token step, the
serving engines' tick and step, the speculative rounds) capture through the
same helper (``capture``, ``graph_for``, ``step_graph``; ``_capturable``
decides).

Entry points default to ``device="cuda"`` and raise on a machine without
CUDA; ``device="cpu"`` runs the kernels' plain versions.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from rten_tpu_torch.kernels.activations import ACTIVATIONS
from rten_tpu_torch.kernels.attention import flash_attention
from rten_tpu_torch.kernels.decode_attention import (
    decode_attention,
    decode_attention_int8,
    decode_block,
    dequantize_kv,
    kv_head_dim_supported,
    mega_block_supported,
    quantize_kv,
)
from rten_tpu_torch.kernels import dispatch
from rten_tpu_torch.kernels.dispatch import resolve_device
from rten_tpu_torch.kernels.paged_attention import paged_decode_attention, paged_decode_attention_int8
from rten_tpu_torch.kernels.quant_matmul import (
    MAX_ROWS,
    int8_pack,
    quant_gemv_int8,
    quant_matmul_int8,
    quant_matmul_w8a8,
    quant_mlp_int8,
    quantize_weights_int8,
)
from rten_tpu_torch.models import ieee


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """The JAX package's ``DecoderConfig`` (``rten_tpu/models/decoder.py:81``)
    with the port's own switches after it: ``int8_kv`` (``init_cache``
    makes an int8 cache with per-(token, kv head) f32 scales), ``w8a8``, the
    W8A8 mode, which the JAX package takes from ``RTEN_W_CONVERT=w8a8``
    (default off, as its ``"direct"``), and ``mega``, the whole-block decode
    kernel, which it takes from ``RTEN_DECODE_FUSE=mega`` (default off, as
    its ``"1"``). ``tie_embeddings`` only tells ``init_params`` whether to
    make an ``lm_head``: a forward uses the params' ``lm_head`` where they
    have one."""

    vocab_size: int = 50257
    n_layers: int = 12
    n_heads: int = 12
    n_kv_heads: int | None = None  # None → MHA (= n_heads)
    d_model: int = 768
    d_ff: int = 3072
    max_seq: int = 1024
    pos_encoding: str = "learned"  # "learned" | "rope"
    pos_offset: int = 0  # learned-position table offset (OPT reserves 2 rows)
    norm: str = "layernorm"  # "layernorm" | "rmsnorm"
    activation: str = "gelu"  # "gelu" | "relu" | "silu" | "swiglu"
    rope_theta: float = 10000.0
    layer_norm_eps: float = 1e-5
    tie_embeddings: bool = True
    int8_kv: bool = False
    w8a8: bool = False
    mega: bool = False
    dtype: torch.dtype = torch.bfloat16

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


GPT2_SMALL = DecoderConfig()
LLAMA_TINY = DecoderConfig(  # a copy of the JAX package's (decoder.py:109)
    vocab_size=32000, n_layers=4, n_heads=8, n_kv_heads=4, d_model=512, d_ff=1376, max_seq=2048,
    pos_encoding="rope", norm="rmsnorm", activation="swiglu", tie_embeddings=False,
)

_QUANT_MIN_SIZE = 1 << 16  # a matrix is quantized at ≥ 2^16 elements (as in the JAX package)
_TILE_BN = 1024  # the JAX package's default tiled-GEMV stripe width (RTEN_TILE_GEMV)
_MLP_FUSED_BYTES = 8 << 20  # its whole-MLP kernel's weight budget (quant_matmul.py MLP_FUSED_VMEM_LIMIT)
_EMBEDDINGS = ("tok_emb", "pos_emb")
_MATRICES = ("wq", "wk", "wv", "wo", "w_up", "w_down", "w_gate", "wqkv", "w_gu", "lm_head", "lm_head_q")


def mlp_fused_supported(d: int, ff: int, n_qkv: int = 0) -> bool:
    """Whether the JAX package runs a layer's whole MLP (and, with
    ``n_qkv``, the next layer's qkv too) as its one MLP kernel: a copy of
    ``rten_tpu/kernels/quant_matmul.py:925``, its int8 weights within
    ``_MLP_FUSED_BYTES``, so that the port routes every decode MLP as the
    JAX package does (``quant_mlp_int8`` itself has no such limit)."""
    return d * ff * 2 + d * n_qkv <= _MLP_FUSED_BYTES


def _check_supported(cfg: DecoderConfig, dense: bool = False) -> None:
    """The ported path: GPT-2, OPT and Llama/Qwen2-class blocks with a
    kernel epilogue activation or SwiGLU, whole groups of query heads; with
    int8 packs d_model a multiple of 128 (the K of every projection but the
    down one). Any head dim: one token a row takes the KV kernels at a head
    dim that divides 128, and ``flash_attention`` at Tq 1 at any other."""
    problems = []
    if cfg.activation not in ("gelu", "relu", "silu", "swiglu"):
        problems.append(f"activation={cfg.activation!r}")
    if cfg.norm not in ("layernorm", "rmsnorm"):
        problems.append(f"norm={cfg.norm!r}")
    if cfg.pos_encoding not in ("learned", "rope"):
        problems.append(f"pos_encoding={cfg.pos_encoding!r}")
    if cfg.d_model % 128 and not dense:
        problems.append("d_model not a multiple of 128")
    if cfg.n_heads % cfg.kv_heads:
        problems.append(f"n_heads {cfg.n_heads} not a multiple of n_kv_heads {cfg.kv_heads}")
    if problems:
        raise NotImplementedError("rten_tpu_torch's decoder does not run this config; unsupported: "
                                  + ", ".join(problems))


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def init_params(seed: int, cfg: DecoderConfig, device="cuda") -> dict:
    """Random dense params from a numpy seed (normal 0.02 weights, zero
    biases, unit norm scales), in ``cfg.dtype`` on ``device``, in the JAX
    package's branches (``rten_tpu/models/decoder.py:129``): no ``pos_emb``
    under RoPE, an ``lm_head`` when untied, ``w_gate`` / ``w_up`` /
    ``w_down`` without biases for SwiGLU (and then no attention biases),
    ``wk`` / ``wv`` of width ``kv_heads·head_dim``."""
    dev = resolve_device(device)
    _check_supported(cfg, dense=True)
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

    d, ff = cfg.d_model, cfg.d_ff
    hq, hkv = cfg.n_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
    params: dict = {"tok_emb": dense((cfg.vocab_size, d)), "final_norm": norm_params(), "layers": []}
    if cfg.pos_encoding == "learned":
        params["pos_emb"] = dense((cfg.max_seq, d))
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((d, cfg.vocab_size))
    for _ in range(cfg.n_layers):
        layer = {"ln1": norm_params(), "ln2": norm_params(),
                 "wq": dense((d, hq)), "wk": dense((d, hkv)), "wv": dense((d, hkv)), "wo": dense((hq, d))}
        if cfg.activation == "swiglu":
            layer.update(w_gate=dense((d, ff)), w_up=dense((d, ff)), w_down=dense((ff, d)))
        else:
            layer.update(w_up=dense((d, ff)), b_up=zeros(ff), w_down=dense((ff, d)), b_down=zeros(d),
                         bq=zeros(hq), bk=zeros(hkv), bv=zeros(hkv), bo=zeros(d))
        params["layers"].append(layer)
    return params


def _np_f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).numpy()
    return np.asarray(t, np.float32)


def _pick_block(dim: int, preferred: int) -> int:
    """Largest 128-multiple ≤ preferred that divides ``dim`` (else
    preferred): a copy of the JAX package's ``pick_block``
    (``rten_tpu/kernels/matmul_pallas.py:86``)."""
    if dim % 128 != 0:
        return min(preferred, max(128, -(-dim // 128) * 128))
    for cand in range(min(preferred, dim), 127, -128):
        if dim % cand == 0:
            return cand
    return preferred


def _is_pack(node) -> bool:
    return isinstance(node, dict) and "qt" in node


def _mark_tiled(params: dict, tile_bn: int) -> None:
    """Set ``pack["tiled"]`` where the JAX package's ``quantize_params_int8``
    stores the pack as ``[S, K, bn]`` stripes at ``tile_bn``
    (``_tile_gemv_packs``, ``rten_tpu/models/decoder.py:339-414``): the
    lm_head (untied or tied) when wider than ``tile_bn``; SwiGLU's ``w_gu``,
    ``w_gate`` and ``w_up`` always, its ``w_down`` never; a GELU/ReLU
    layer's ``w_up`` and ``w_down`` only when its whole-MLP kernel cannot
    hold them (``mlp_fused_supported``); layer 0's ``wqkv``, a SwiGLU
    layer's, and a later layer's when it cannot ride the previous layer's
    MLP kernel; ``wo`` never. Layer packs tile only where a divisor width
    splits them. At GPT-2-small's widths and 1024 that is the lm_head and
    layer 0's wqkv."""

    def kn(pack):
        return pack["qt"].shape[1], pack["qt"].shape[0]

    def mark(pack):
        n = kn(pack)[1]
        bn = _pick_block(n, tile_bn)
        pack["tiled"] = bn < n and n % bn == 0

    head = params.get("lm_head_q", params.get("lm_head"))
    if _is_pack(head):
        head["tiled"] = kn(head)[1] > tile_bn
    for li, layer in enumerate(params["layers"]):
        swiglu = "w_gu" in layer or "w_gate" in layer
        wu, wd, wqkv = layer.get("w_up"), layer.get("w_down"), layer.get("wqkv")
        for key in ("w_gu", "w_gate", "w_up") if swiglu else ():
            if _is_pack(layer.get(key)):
                mark(layer[key])
        mlp = not swiglu and _is_pack(wu) and _is_pack(wd)
        if mlp and not mlp_fused_supported(*kn(wu)):
            mark(wu)
            mark(wd)
        if _is_pack(wqkv) and not (li > 0 and mlp and mlp_fused_supported(*kn(wu), kn(wqkv)[1])):
            mark(wqkv)


def quantize_params_int8(params: dict, device="cuda", *, fuse: bool = True) -> dict:
    """INT8 decode params from dense ones, by the JAX package's rules
    (``rten_tpu/models/decoder.py`` ``quantize_params_int8``): every 2-D
    matrix of ≥ 2^16 elements is quantized per output channel after
    zero-padding K to a multiple of 128 and N to a multiple of 1024 (N ≥
    8192) or 128; smaller matrices stay dense; q|k|v fuse into ``wqkv``
    (and their biases into ``bqkv``) when their width is a multiple of 128,
    SwiGLU's gate|up into ``w_gu`` when 2·d_ff is; an untied ``lm_head`` is
    quantized in place, tied embeddings get their own ``lm_head_q``.
    Embeddings stay dense in their dtype; every vector becomes f32 ``[N]``.
    The packs the JAX package would tile at its default width (``_TILE_BN``)
    are marked ``tiled`` (``_mark_tiled``); the port's layout is the same.

    ``fuse=False`` leaves ``wq`` / ``wk`` / ``wv`` and ``w_gate`` / ``w_up``
    apart and marks nothing tiled, as the JAX package's ``fuse=False`` (the
    tree that tensor parallelism shards by columns, ``parallel.mesh``)."""
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

    def concat(src, keys):
        return np.concatenate([_np_f32(src[k]) for k in keys], 1)

    src_layers = params["layers"]
    out = walk({k: v for k, v in params.items() if k != "layers"})
    out["layers"] = []
    for src in src_layers:
        fuse_qkv = fuse and sum(src[k].shape[1] for k in ("wq", "wk", "wv")) % 128 == 0
        fuse_gu = fuse and "w_gate" in src and (2 * src["w_gate"].shape[1]) % 128 == 0
        skip = (("wq", "wk", "wv", "bq", "bk", "bv") if fuse_qkv else ()) + (("w_gate", "w_up") if fuse_gu else ())
        layer = {k: walk(v, k) for k, v in src.items() if k not in skip}
        if fuse_qkv:
            layer["wqkv"] = matrix(concat(src, ("wq", "wk", "wv")))
            if "bq" in src:
                layer["bqkv"] = torch.cat([vector(src[k]) for k in ("bq", "bk", "bv")])
        if fuse_gu:
            layer["w_gu"] = matrix(concat(src, ("w_gate", "w_up")))
        out["layers"].append(layer)
    if "lm_head" not in params:
        out["lm_head_q"] = matrix(_np_f32(params["tok_emb"]).T.copy())
    if fuse:
        _mark_tiled(out, _TILE_BN)
    return out


def params_from_jax(tree: dict, cfg: DecoderConfig, device="cuda") -> dict:
    """Carry a JAX package params tree across (leaves as numpy arrays or
    anything ``np.asarray`` takes). A dense tree gives dense port params in
    ``cfg.dtype``; a quantized tree (``rten_tpu`` ``quantize_params_int8``)
    gives the port's decode layout directly: row-major ``[K, N]`` and tiled
    ``[S, K, bn]`` packs (K-padded ones, the untied ``lm_head``, ``w_gu``
    and ``w_gate`` among them) become ``int8_pack``s (a tiled one marked
    ``tiled``), the ``slabs`` duplicates are dropped, and ``[1, N]`` vectors
    become f32 ``[N]``. A tree that mixes packs and dense matrices (the JAX
    quantizer's output below its size threshold) or keeps q/k/v apart
    (``fuse=False``) is carried as it is, for the per-projection route."""
    return carry_tree(tree, cfg.dtype, _EMBEDDINGS + _MATRICES, resolve_device(device))


def carry_tree(tree: dict, dtype: torch.dtype, dense_keys, dev: torch.device) -> dict:
    """A JAX params tree as port tensors on ``dev``: ``{"q", "s"}`` packs
    (row-major or tiled) as ``int8_pack``s, leaves under ``dense_keys`` as
    tensors in ``dtype``, every other leaf a vector ``[N]``: f32 in a
    quantized tree, ``dtype`` in a dense one; ``slabs`` dropped."""

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
        if key in dense_keys:
            return torch.from_numpy(arr.copy()).to(dev, dtype)
        vec = torch.from_numpy(arr.reshape(-1).copy()).to(dev)
        return vec if quantized else vec.to(dtype)

    return conv(tree)


def _hf_getter(hf_state: dict, prefixes, dev, dtype):
    def g(name):
        for prefix in prefixes:
            if prefix + name in hf_state:
                return torch.from_numpy(_np_f32(hf_state[prefix + name]).copy()).to(dev, dtype)
        raise KeyError(name)

    return g


def from_hf_gpt2(hf_state: dict, cfg: DecoderConfig, dtype=None, device="cuda") -> dict:
    """Dense port params from a HuggingFace ``GPT2LMHeadModel``/``GPT2Model``
    state dict (torch tensors or numpy arrays). GPT-2's Conv1D weights are
    already ``[in, out]``, so nothing is transposed."""
    g = _hf_getter(hf_state, ("", "transformer."), resolve_device(device), dtype or cfg.dtype)
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


def from_hf_opt(hf_state: dict, cfg: DecoderConfig, dtype=None, device="cuda") -> dict:
    """Dense port params from a HuggingFace ``OPTForCausalLM``/``OPTModel``
    state dict: a copy of ``rten_tpu/models/decoder.py:1328`` (ReLU MLP,
    learned positions at the OPT offset of 2 rows, ``cfg.pos_offset=2``,
    the pre-norm layout; the ``project_in``/``project_out`` variants such as
    opt-350m are refused). nn.Linear weights are ``[out, in]``, so they are
    transposed."""
    if any("project_in" in k for k in hf_state):
        raise ValueError("OPT project_in/out variants (opt-350m) unsupported")
    g = _hf_getter(hf_state, ("", "model.", "model.decoder.", "decoder."), resolve_device(device),
                   dtype or cfg.dtype)

    def t(name):
        return g(name).t().contiguous()

    params: dict = {
        "tok_emb": g("embed_tokens.weight"),
        "pos_emb": g("embed_positions.weight"),
        "final_norm": {"scale": g("final_layer_norm.weight"), "bias": g("final_layer_norm.bias")},
        "layers": [],
    }
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        params["layers"].append(
            {
                "ln1": {"scale": g(p + "self_attn_layer_norm.weight"), "bias": g(p + "self_attn_layer_norm.bias")},
                "ln2": {"scale": g(p + "final_layer_norm.weight"), "bias": g(p + "final_layer_norm.bias")},
                "wq": t(p + "self_attn.q_proj.weight"), "bq": g(p + "self_attn.q_proj.bias"),
                "wk": t(p + "self_attn.k_proj.weight"), "bk": g(p + "self_attn.k_proj.bias"),
                "wv": t(p + "self_attn.v_proj.weight"), "bv": g(p + "self_attn.v_proj.bias"),
                "wo": t(p + "self_attn.out_proj.weight"), "bo": g(p + "self_attn.out_proj.bias"),
                "w_up": t(p + "fc1.weight"), "b_up": g(p + "fc1.bias"),
                "w_down": t(p + "fc2.weight"), "b_down": g(p + "fc2.bias"),
            }
        )
    return params


def from_hf_llama(hf_state: dict, cfg: DecoderConfig, dtype=None, device="cuda") -> dict:
    """Dense port params from a HuggingFace ``LlamaForCausalLM``/``LlamaModel``
    (or Qwen2) state dict: a copy of ``rten_tpu/models/decoder.py:1384``
    (RoPE, RMSNorm, SwiGLU, grouped-query attention). An ``lm_head`` is
    always written: the checkpoint's, or a copy of the tied embedding;
    Qwen2's q/k/v biases are kept where the checkpoint has them. nn.Linear
    weights are ``[out, in]``, so they are transposed."""
    g = _hf_getter(hf_state, ("", "model."), resolve_device(device), dtype or cfg.dtype)

    def t(name):
        return g(name).t().contiguous()

    params: dict = {"tok_emb": g("embed_tokens.weight"), "final_norm": {"scale": g("norm.weight")}, "layers": []}
    tied = not any(k.endswith("lm_head.weight") for k in hf_state)
    params["lm_head"] = t("embed_tokens.weight" if tied else "lm_head.weight")
    for i in range(cfg.n_layers):
        p = f"layers.{i}."
        layer = {
            "ln1": {"scale": g(p + "input_layernorm.weight")},
            "ln2": {"scale": g(p + "post_attention_layernorm.weight")},
            "wq": t(p + "self_attn.q_proj.weight"),
            "wk": t(p + "self_attn.k_proj.weight"),
            "wv": t(p + "self_attn.v_proj.weight"),
            "wo": t(p + "self_attn.o_proj.weight"),
            "w_gate": t(p + "mlp.gate_proj.weight"),
            "w_up": t(p + "mlp.up_proj.weight"),
            "w_down": t(p + "mlp.down_proj.weight"),
        }
        for ours, theirs in (("bq", "q_proj"), ("bk", "k_proj"), ("bv", "v_proj")):
            name = p + f"self_attn.{theirs}.bias"
            if name in hf_state or "model." + name in hf_state:
                layer[ours] = g(name)
        params["layers"].append(layer)
    return params


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def init_cache(cfg: DecoderConfig, batch: int, max_len: int | None = None, device="cuda") -> dict:
    """Preallocated KV cache: per-layer k/v ``[B, Hk, S, D]`` in cfg.dtype
    (with ``cfg.int8_kv``: int8 codes, and per-(token, kv head) f32 scales
    ``k_scale``/``v_scale`` ``[B, Hk, S]``) and the valid length of each
    row, int32 ``[B]``, on the device. ``host_len`` keeps on the host, for
    each row, a length at least the device's (numpy int64 ``[B]``), so that
    ``forward`` refuses a full row without reading the device; a caller
    that pins a row's device length (the serving engine's inactive rows)
    pins it here too. ``forward`` writes each row's new k/v in place at its
    own length and advances both."""
    dev = resolve_device(device)
    shape = (batch, cfg.kv_heads, max_len or cfg.max_seq, cfg.head_dim)
    kv_dtype = torch.int8 if cfg.int8_kv else cfg.dtype
    cache = {
        "k": [torch.zeros(shape, dtype=kv_dtype, device=dev) for _ in range(cfg.n_layers)],
        "v": [torch.zeros(shape, dtype=kv_dtype, device=dev) for _ in range(cfg.n_layers)],
        "len": torch.zeros(batch, dtype=torch.int32, device=dev),
        "host_len": np.zeros(batch, np.int64),
    }
    if cfg.int8_kv:
        for key in ("k_scale", "v_scale"):
            cache[key] = [torch.zeros(shape[:3], dtype=torch.float32, device=dev) for _ in range(cfg.n_layers)]
    return cache


_CACHE_LAYERS = ("k", "v", "k_scale", "v_scale")  # the per-layer lists of a contiguous cache


def row_view(cache: dict, row: int) -> dict:
    """A batch-1 cache whose tensors are views of row ``row`` of ``cache``
    (contiguous: the row is the leading axis): a forward on it writes that
    row of ``cache`` in place, and advances that row's device length."""
    view = {key: [t[row : row + 1] for t in cache[key]] for key in _CACHE_LAYERS if key in cache}
    view["len"] = cache["len"][row : row + 1]
    view["host_len"] = cache["host_len"][row : row + 1]  # a numpy view: advances with the row
    return view


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _pack(layer, key):
    pack = layer.get(key)
    if not _is_pack(pack):
        raise ValueError(
            f"{key} is not an int8 pack: the decoder needs quantize_params_int8 "
            "(or params_from_jax of quantized params), with every projection ≥ 2^16 elements"
        )
    return pack


_PROJECTIONS = ("wqkv", "wq", "wk", "wv", "wo", "w_gu", "w_gate", "w_up", "w_down")


def _is_dense(params: dict) -> bool:
    """Whether ``params`` takes the per-projection route: a layer without
    the fused ``wqkv`` (``fuse=False``, or a dense tree), or any projection
    or head that is a dense matrix. Every other tree, packs throughout with
    q/k/v fused, takes the fused int8 route."""
    head = params.get("lm_head_q", params.get("lm_head"))
    if head is not None and not _is_pack(head):
        return True
    return any("wqkv" not in layer or any(k in layer and not _is_pack(layer[k]) for k in _PROJECTIONS)
               for layer in params["layers"])


def _dense_proj(x, w, bias=None, activation=None, n: int | None = None, out_dtype=None):
    """``x @ w (+ bias)`` of the rows x [M, K] as the JAX package's ``_proj``
    (``decoder.py:502-550``) runs it on the matrix it finds, sliced to ``n``
    columns where given (a pack's N may be padded). A dense ``[K, N]``
    matrix: the product in IEEE f32 (``ieee.matmul``) in the model dtype,
    then the bias, then the activation in f32 rounded to the model dtype
    (GELU the exact erf one). An int8 pack: x zero-padded to the pack's K,
    then ``quant_matmul_int8`` (the GEMV at ≤ 8 rows), its bias and
    activation in the kernel's epilogue when the pack has ``n`` columns,
    else added outside after the slice. ``out_dtype`` (no bias or
    activation): the product in that dtype, unrounded (the tensor-parallel
    path's f32 partials)."""
    if _is_pack(w):
        k, n_pack = w["qt"].shape[1], w["qt"].shape[0]
        if x.shape[1] < k:
            x = F.pad(x, (0, k - x.shape[1]))
        if n is None or n == n_pack:
            return quant_matmul_int8(x, w["qt"], w["s"], bias, activation=activation, out_dtype=out_dtype)
        out = quant_matmul_int8(x, w["qt"], w["s"])[:, :n]
    else:
        out = ieee.matmul(x, w) if out_dtype is None else ieee.matmul(x.to(out_dtype), w.to(out_dtype))
        if n is not None:
            out = out[:, :n]
    if bias is not None:
        out = (out + bias).to(x.dtype)
    if activation is None:
        return out
    if activation == "gelu":
        return F.gelu(out.float()).to(x.dtype)
    return ACTIVATIONS[activation](out.float()).to(x.dtype)


def _dense_qkv(layer: dict, cfg: DecoderConfig, x, b: int, t: int, rope):
    """q [B, T, H, D], k and v [B, T, Hk, D] of the rows x through ln1 and
    the fused ``wqkv`` (sliced apart) or the separate ``wq``, ``wk``, ``wv``
    (and their biases), RoPE'd with ``rope``'s tables where given."""
    h, hk, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    xn = _norm(x, layer["ln1"], cfg)
    if "wqkv" in layer:
        qkv = _dense_proj(xn, layer["wqkv"], layer.get("bqkv"), n=(h + 2 * hk) * hd)
        return _split_heads(qkv, cfg, b, t, rope)
    q, k, v = (_dense_proj(xn, layer[w], layer.get(bias), n=n * hd).view(b, t, n, hd)
               for w, bias, n in (("wq", "bq", h), ("wk", "bk", hk), ("wv", "bv", hk)))
    if rope is not None:
        q, k = _rope(q, rope), _rope(k, rope)
    return q, k, v


def _dense_mlp(layer: dict, cfg: DecoderConfig, x):
    """The MLP half of a layer on the per-projection route: ln2, up (its
    bias and activation) or SwiGLU's ``silu(gate) · up`` (``w_gu`` sliced
    apart, or ``w_gate`` and ``w_up``), down, its bias, the residual."""
    ff = cfg.d_ff
    xn = _norm(x, layer["ln2"], cfg)
    if cfg.activation == "swiglu":
        if "w_gu" in layer:
            gu = _dense_proj(xn, layer["w_gu"], n=2 * ff)
            gate, up = gu[:, :ff], gu[:, ff:]
        else:
            gate, up = _dense_proj(xn, layer["w_gate"], n=ff), _dense_proj(xn, layer["w_up"], n=ff)
        hidden = F.silu(gate.float()).to(x.dtype) * up
    else:
        hidden = _dense_proj(xn, layer["w_up"], layer.get("b_up"), cfg.activation, n=ff)
    return x + _dense_proj(hidden, layer["w_down"], layer.get("b_down"), n=cfg.d_model)


def head_logits(params: dict, xn):
    """f32 logits of the normalized rows xn through the params' ``lm_head``
    or tied ``lm_head_q`` (a pack through ``quant_matmul_int8`` with f32
    logits; a dense matrix ``xn @ head`` in the model dtype, then f32) or
    the tied ``xn @ tok_emb``ᵀ (``decoder.py:1123-1125``); every column the
    head has, padded ones included."""
    head = params.get("lm_head", params.get("lm_head_q"))
    if head is None:
        head = params["tok_emb"].t()
    if _is_pack(head):
        return _dense_proj(xn, head, out_dtype=torch.float32)
    return ieee.matmul(xn, head).float()


def _dense_lm_head(params: dict, cfg: DecoderConfig, x, mode: str):
    """The final norm and ``head_logits``, as f32 logits [M, vocab] or
    (``mode="argmax"``) the greedy tokens int32 [M] (the lowest index among
    equal maxima, as ``jnp.argmax``)."""
    logits = head_logits(params, _norm(x, params["final_norm"], cfg))[:, : cfg.vocab_size]
    return logits.argmax(-1).to(torch.int32) if mode == "argmax" else logits


def _norm(x, p, cfg: DecoderConfig):
    """Row norm of the prefill structure, the counterpart of the JAX
    package's ``_norm`` (``decoder.py:491``): statistics and normalization
    in f32, the normalized rows rounded to the model dtype, then scaled
    (and shifted); returned in x.dtype."""
    xf = x.float()
    if cfg.norm == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + cfg.layer_norm_eps)
        return (y.to(x.dtype) * p["scale"]).to(x.dtype)
    y = F.layer_norm(xf, (xf.shape[-1],), eps=cfg.layer_norm_eps)
    return (y.to(x.dtype) * p["scale"] + p["bias"]).to(x.dtype)


def _proj(cfg: DecoderConfig, x, pack, bias=None, **kw):
    """A projection of the prefill structure, the JAX package's ``_proj``
    (``decoder.py:502``): x zero-padded to the pack's K, then
    ``quant_matmul_w8a8`` under ``cfg.w8a8``, except for a pack the JAX
    package stores tiled (its ``_proj`` keeps those on the weight-only
    kernel, ``decoder.py:526``); else ``quant_matmul_int8``."""
    k = pack["qt"].shape[1]
    if x.shape[1] < k:
        x = F.pad(x, (0, k - x.shape[1]))
    matmul = quant_matmul_w8a8 if cfg.w8a8 and not pack["tiled"] else quant_matmul_int8
    return matmul(x, pack["qt"], pack["s"], bias, **kw)


def _residual_proj(cfg: DecoderConfig, src, pack, bias, residual, small: bool):
    """``src @ W + bias + residual`` as the JAX package's ``_fproj`` runs it
    (``decoder.py:632-671``): in the fused decode structure, when the pack's
    K is ``src``'s width, one ``quant_gemv_int8`` with the residual fused;
    otherwise (the prefill structure, or a K-padded pack) ``_proj``, its
    output rounded to the model dtype, plus the residual in the model
    dtype."""
    if small and pack["qt"].shape[1] == src.shape[1]:
        return quant_gemv_int8(src, pack["qt"], pack["s"], bias, residual=residual, w8a8=cfg.w8a8)
    return _proj(cfg, src, pack, bias) + residual


def _gemv_norm(cfg: DecoderConfig, x, pack, bias, norm_p, **kw):
    """A decode-structure GEMV with the row norm ``norm_p`` fused in."""
    return quant_gemv_int8(x, pack["qt"], pack["s"], bias, norm=cfg.norm, norm_scale=norm_p["scale"],
                           norm_bias=norm_p.get("bias"), norm_eps=cfg.layer_norm_eps, w8a8=cfg.w8a8, **kw)


def _rope_tables(positions, head_dim: int, theta: float):
    """(cos, sin) f32 [B, T, 1, D/2] of the rotary embedding at positions
    int [B, T], as the JAX package's ``_rope`` (``decoder.py:572``) computes
    them; a forward computes them once for every layer's q and k."""
    freqs = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim))
    angles = positions[:, :, None, None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def _rope(x, tables):
    """Rotary embeddings of x [B, T, H, D] (rotate-half in f32, rounded to
    x.dtype: the JAX package's ``_rope``) with ``_rope_tables``' (cos, sin)."""
    cos, sin = tables
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _split_heads(qkv, cfg: DecoderConfig, b: int, t: int, rope):
    """q [B, T, H, D], k and v [B, T, Hk, D] of the projection ``qkv``
    [B·T, (H + 2·Hk)·D] (views, or with RoPE, whose ``_rope_tables`` are
    ``rope``, the rotated q and k)."""
    h, hk, hd = cfg.n_heads, cfg.kv_heads, cfg.head_dim
    q = qkv[:, : h * hd].view(b, t, h, hd)
    k = qkv[:, h * hd : (h + hk) * hd].view(b, t, hk, hd)
    v = qkv[:, (h + hk) * hd : (h + 2 * hk) * hd].view(b, t, hk, hd)
    if rope is not None:
        q, k = _rope(q, rope), _rope(k, rope)
    return q, k, v


def _attention(q, k, v, cache, li: int, q_offset, kv_len, whole: bool | None = None):
    """Causal attention of the T new rows, q [B, T, H, D], k and v [B, T,
    Hk, D] → [B·T, H·D]. With a cache, each row's new k/v are written in
    place at its own length (``q_offset``, on the device), and the queries
    attend to the cache's valid prefix; without, to the T rows themselves.
    An int8 cache takes the new rows quantized per (token, kv head), and the
    queries attend to its prefix dequantized to the model dtype (the JAX
    package's eager int8 branch, ``decoder.py:812-845``).

    The prefix read is the cache's first ``int(host_len.max()) + T``
    positions (no row's reaches past them), or with ``whole`` (by default:
    while a CUDA graph is being captured, which must not bake a host length
    into its launches) all S of them, as the JAX decoder's static shapes
    read them; ``flash_attention`` bounds each row by its device ``kv_len``
    either way. Its split-KV plan sizes for S in both, so the two give the
    same bits and the same launches."""
    b, t, h, hd = q.shape
    if cache is not None:
        k_cache, v_cache = cache["k"][li], cache["v"][li]
        s = k_cache.shape[2]
        if whole is None:
            whole = q.is_cuda and torch.cuda.is_current_stream_capturing()
        n = s if whole else int(cache["host_len"].max()) + t
        rows = torch.arange(b, device=q.device)[:, None]
        pos = q_offset.long()[:, None] + torch.arange(t, device=q.device)  # [B, T]
        if "k_scale" in cache:
            out = []
            for new, codes, scales in ((k, k_cache, cache["k_scale"][li]), (v, v_cache, cache["v_scale"][li])):
                q8, s8 = quantize_kv(new)  # [B, T, Hk, D], [B, T, Hk]
                codes[rows, :, pos] = q8
                scales[rows, :, pos] = s8
                out.append(dequantize_kv(codes[:, :, :n], scales[:, :, :n], q.dtype))
            k, v = out
        else:
            k_cache[rows, :, pos] = k
            v_cache[rows, :, pos] = v
            k, v = k_cache[:, :, :n], v_cache[:, :, :n]
        attn = flash_attention(q.transpose(1, 2), k, v, causal=True, q_offset=q_offset, kv_len=kv_len, plan_len=s)
    else:
        attn = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), causal=True,
                               q_offset=q_offset, kv_len=kv_len)
    return attn.transpose(1, 2).reshape(b * t, h * hd)


def _kv_decode_attention(ops, cache, li: int):
    """One token per row against a paged or int8 cache: the attention
    vector [B, H·D] (the output projection is the caller's, as in the JAX
    package's ``_fproj`` after these kernels)."""
    if "k_pages" in cache:
        pages = (cache["k_pages"][li], cache["v_pages"][li])
        if "k_scale_pages" in cache:
            return paged_decode_attention_int8(ops, *pages, cache["k_scale_pages"][li], cache["v_scale_pages"][li],
                                               cache["page_table"], cache["len"])
        return paged_decode_attention(ops, *pages, cache["page_table"], cache["len"])
    return decode_attention_int8(ops, cache["k"][li], cache["v"][li], cache["k_scale"][li], cache["v_scale"][li],
                                 cache["len"])


def _mega_layer(params: dict, cfg: DecoderConfig, li: int, cache: dict):
    """``(mlp, next_qkv)`` of ``decode_block`` for layer ``li`` where the
    JAX package's decoder runs that layer through its mega kernel
    (``rten_tpu/models/decoder.py:859-921``: the MLP packs of the config's
    shapes, the next layer's qkv of (Hq + 2·Hk)·D columns when it has one,
    and ``mega_block_supported`` over this layer's kv heads and cache), else
    None."""
    layers = params["layers"]
    layer = layers[li]
    d, ff, h, hk, hd = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    up, down = _pack(layer, "w_up"), _pack(layer, "w_down")
    if tuple(up["qt"].shape) != (ff, d) or tuple(down["qt"].shape) != (d, ff):
        return None
    qkv_dim = (h + 2 * hk) * hd
    next_qkv = None
    nxt = layers[li + 1] if li + 1 < len(layers) else None
    if nxt is not None and tuple(_pack(nxt, "wqkv")["qt"].shape) == (qkv_dim, d):
        nq = nxt["wqkv"]
        next_qkv = (nq["qt"], nq["s"], nxt.get("bqkv"), nxt["ln1"]["scale"], nxt["ln1"].get("bias"))
    k_cache = cache["k"][li]
    if not mega_block_supported(
            d, ff, qkv_dim if next_qkv is not None else 0, hk, hd, k_cache.shape[2], kv_bytes=k_cache.element_size()):
        return None
    mlp = (up["qt"], up["s"], down["qt"], down["s"], layer.get("b_up"), layer.get("b_down"),
           layer["ln2"]["scale"], layer["ln2"].get("bias"))
    return mlp, next_qkv


def _mlp(params: dict, cfg: DecoderConfig, li: int, x, small: bool):
    """The MLP half of layer ``li`` on the rows x (the block output after
    attention): ``(x, next layer's qkv or None)``, routed as the JAX
    package's ``forward`` routes it (``decoder.py:1026-1120``)."""
    layers = params["layers"]
    layer = layers[li]
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.activation == "swiglu":
        if small:
            if "w_gu" in layer:
                gu = _gemv_norm(cfg, x, _pack(layer, "w_gu"), None, layer["ln2"])[:, : 2 * ff]
                gate, up = gu[:, :ff], gu[:, ff:]
            else:
                gate = _gemv_norm(cfg, x, _pack(layer, "w_gate"), None, layer["ln2"])
                up = _gemv_norm(cfg, x, _pack(layer, "w_up"), None, layer["ln2"])
        else:
            xn = _norm(x, layer["ln2"], cfg)
            if "w_gu" in layer:
                gu = _proj(cfg, xn, _pack(layer, "w_gu"))[:, : 2 * ff]
                gate, up = gu[:, :ff], gu[:, ff:]
            else:
                gate, up = _proj(cfg, xn, _pack(layer, "w_gate")), _proj(cfg, xn, _pack(layer, "w_up"))
        hidden = F.silu(gate.float()).to(x.dtype) * up
        return _residual_proj(cfg, hidden, _pack(layer, "w_down"), None, x, small), None
    up, down = _pack(layer, "w_up"), _pack(layer, "w_down")
    if not small:
        hidden = _proj(cfg, _norm(x, layer["ln2"], cfg), up, layer.get("b_up"), activation=cfg.activation)
        return _residual_proj(cfg, hidden, down, layer.get("b_down"), x, small), None
    if tuple(up["qt"].shape) == (ff, d) and tuple(down["qt"].shape) == (d, ff) and mlp_fused_supported(d, ff):
        # The whole MLP as one kernel, and the next layer's ln1 + qkv with it
        # when those weights fit its budget too.
        nxt = layers[li + 1] if li + 1 < len(layers) else None
        qkv_dim = (cfg.n_heads + 2 * cfg.kv_heads) * cfg.head_dim
        next_qkv = None
        if nxt is not None and _is_pack(nxt.get("wqkv")) and tuple(nxt["wqkv"]["qt"].shape) == (qkv_dim, d) \
                and mlp_fused_supported(d, ff, qkv_dim):
            nq = nxt["wqkv"]
            next_qkv = (nq["qt"], nq["s"], nxt.get("bqkv"), nxt["ln1"]["scale"], nxt["ln1"].get("bias"))
        out = quant_mlp_int8(
            x, up["qt"], up["s"], down["qt"], down["s"], layer.get("b_up"), layer.get("b_down"),
            activation=cfg.activation, norm=cfg.norm, norm_scale=layer["ln2"]["scale"],
            norm_bias=layer["ln2"].get("bias"), norm_eps=cfg.layer_norm_eps, residual=x, next_qkv=next_qkv,
            w8a8=cfg.w8a8,
        )
        return out if next_qkv is not None else (out, None)
    # Past the budget: the up GEMV with ln2 and the activation fused (its
    # output rounded to the model dtype), then the down GEMV with the residual.
    hidden = _gemv_norm(cfg, x, up, layer.get("b_up"), layer["ln2"], activation=cfg.activation)
    return _residual_proj(cfg, hidden, down, layer.get("b_down"), x, small), None


def _lm_head(params: dict, cfg: DecoderConfig, x, mode: str, small: bool):
    """Final norm + int8 lm_head (``lm_head_q``, tied, or the untied
    ``lm_head``) of the rows ``x`` [M, D]: f32 logits [M, vocab] or
    (``mode="argmax"``) the greedy tokens int32 [M]. Up to 8 rows go
    through ``quant_gemv_int8`` with the norm fused (and the argmax fused
    too); more through ``_norm`` and the prefill projection. Under W8A8 a
    prefill-structure forward (``small`` False) takes the latter at any row
    count, as the JAX package runs its lm_head on every row."""
    head = _pack(params, "lm_head_q" if "lm_head_q" in params else "lm_head")
    fn = params["final_norm"]
    if x.shape[0] <= MAX_ROWS and (small or not cfg.w8a8):
        if mode == "argmax":
            return _gemv_norm(cfg, x, head, None, fn, argmax_n=cfg.vocab_size)
        # The epilogue writes f32 logits (the JAX package rounds them to the
        # model dtype first; a sampler wants them unrounded).
        return _gemv_norm(cfg, x, head, None, fn, out_dtype=torch.float32)[:, : cfg.vocab_size]
    logits = _proj(cfg, _norm(x, fn, cfg), head, out_dtype=torch.float32)[:, : cfg.vocab_size]
    return logits.argmax(-1).to(torch.int32) if mode == "argmax" else logits


def forward(params: dict, cfg: DecoderConfig, tokens, cache: dict | None = None, *,
            lm_head_mode="logits", last_only: bool = False, fuse: bool = True):
    """One forward of ``tokens`` [B, T], T ≥ 1: appended at ``cache["len"]``
    with a cache, or a plain full-sequence forward (positions 0..T-1)
    without one.

    Returns ``(result, cache)``, the cache updated in place (None without
    one). ``result`` is the f32 logits [B, T, vocab] (``lm_head_mode=
    "logits"``; not rounded to the model dtype, unlike the JAX package's)
    or the int32 greedy tokens [B, T] (``"argmax"``). With ``last_only``
    the final norm and the lm_head run on the last position only and
    ``result`` is [B, 1, …]. Raises IndexError, before any kernel runs,
    when the T new tokens do not fit in a row of the cache.

    The cache is one ``init_cache`` makes (bf16/f32 or int8) or a paged
    pool's state ``{"k_pages", "v_pages", ["k_scale_pages",
    "v_scale_pages"], "page_table", "len"}`` (``serve.paged``), which takes
    one token per row, each row's page of ``len`` allocated by the caller.
    One token a row on an int8 or paged cache runs ``decode_attention_int8``
    or ``paged_decode_attention(_int8)`` at any B, then wo through
    ``quant_gemv_int8`` with the residual (the prefill projection above 8
    rows).

    ``fuse=False`` runs the prefill structure at any row count (the JAX
    package's ``RTEN_DECODE_FUSE=0``): the serving engines admit a W8A8
    prompt so, as the JAX engines' bucketed admission (≥ 32 rows) does. One
    token a row on a bf16/f32 cache then takes ``decode_attention`` without
    its fused wo, as it does at more than 8 rows."""
    dense = _is_dense(params)
    _check_supported(cfg, dense)
    if lm_head_mode not in ("logits", "argmax"):
        raise ValueError(f"lm_head_mode must be 'logits' or 'argmax', got {lm_head_mode!r}")
    b, t = tokens.shape
    rows = b * t
    # The fused decode structure (JAX decoder.py:614-625); dense weights never take it.
    small = fuse and rows <= MAX_ROWS and not dense
    paged = cache is not None and "k_pages" in cache
    one_token = t == 1 and cache is not None
    # One token a row takes a KV kernel at any B (JAX decoder.py:740-812):
    # the paged / int8 decode kernels, or decode_attention on a bf16/f32
    # cache, its wo fused in the decode structure, else left to the prefill
    # projection. At a head dim the KV kernels do not take (one that does not
    # divide 128), the token is appended and attends through flash_attention
    # at Tq 1, as the JAX decoder runs a step its decode kernels refuse
    # (decoder.py:739-752, :1009-1020).
    kv_ok = kv_head_dim_supported(cfg.head_dim)
    kv_decode = one_token and (paged or ("k_scale" in cache and kv_ok))
    decode = one_token and not paged and "k_scale" not in cache and kv_ok
    mega = decode and small and b == 1 and cfg.mega and cfg.activation in ("gelu", "relu", "silu")
    q_offset = kv_len = None
    if paged and not kv_decode:
        raise ValueError(f"a paged cache takes one token per row, got {b}x{t}")
    if cache is not None:
        _check_room(cache, t)
        start = cache["len"]
        positions = start[:, None] + torch.arange(t, device=start.device)  # [B, T]
        if not decode:
            q_offset, kv_len = start, start + t
    else:
        positions = torch.arange(t, device=tokens.device).expand(b, t)
    x = params["tok_emb"].index_select(0, tokens.reshape(-1))
    rope = None
    if cfg.pos_encoding == "learned":
        x = x + params["pos_emb"].index_select(0, positions.reshape(-1) + cfg.pos_offset)
    else:
        rope = _rope_tables(positions, cfg.head_dim, cfg.rope_theta)

    layers = params["layers"]
    qkv = None  # this layer's qkv when the previous layer's MLP kernel computed it
    for li, layer in enumerate(layers):
        if dense:
            q, k, v = _dense_qkv(layer, cfg, x, b, t, rope)
        elif qkv is None:
            wqkv = _pack(layer, "wqkv")
            if small:
                qkv = _gemv_norm(cfg, x, wqkv, layer.get("bqkv"), layer["ln1"])
            else:
                qkv = _proj(cfg, _norm(x, layer["ln1"], cfg), wqkv, layer.get("bqkv"))
        if not dense:
            q, k, v = _split_heads(qkv, cfg, b, t, rope)
            wo = _pack(layer, "wo")
        if mega:  # the whole layer, and the next layer's qkv, in one kernel
            block = _mega_layer(params, cfg, li, cache)
            if block is not None:
                # MHA without RoPE: the packed row (JAX decoder.py:929-933 packed_ok).
                packed = cfg.kv_heads == cfg.n_heads and rope is None
                ops = qkv.view(b, 3, cfg.n_heads, 1, cfg.head_dim) if packed else (q[:, 0], k[:, 0], v[:, 0])
                out = decode_block(ops, cache["k"][li], cache["v"][li], cache["len"], wo["qt"], wo["s"],
                                   layer.get("bo"), x, *block, activation=cfg.activation, norm=cfg.norm,
                                   norm_eps=cfg.layer_norm_eps)
                x, qkv = out if block[1] is not None else (out, None)
                continue
        ops = (q[:, 0], k[:, 0], v[:, 0]) if one_token else None
        if decode and small:
            x = decode_attention(ops, cache["k"][li], cache["v"][li], cache["len"], wo["qt"], wo["s"],
                                 layer.get("bo"), residual=x)
        else:
            if decode:
                attn = decode_attention(ops, cache["k"][li], cache["v"][li], cache["len"])
            elif kv_decode:
                attn = _kv_decode_attention(ops, cache, li)
            else:
                attn = _attention(q, k, v, cache, li, q_offset, kv_len)
            if dense:
                x = x + _dense_proj(attn, layer["wo"], layer.get("bo"), n=cfg.d_model)
            else:
                x = _residual_proj(cfg, attn, wo, layer.get("bo"), x, small)
        if dense:
            x = _dense_mlp(layer, cfg, x)
        else:
            x, qkv = _mlp(params, cfg, li, x, small)

    head_in = (x.view(b, t, cfg.d_model)[:, -1] if last_only and t > 1 else x).contiguous()
    if dense:
        result = _dense_lm_head(params, cfg, head_in, lm_head_mode)
    else:
        result = _lm_head(params, cfg, head_in, lm_head_mode, small)
    result = result.reshape(b, 1 if last_only else t, *result.shape[1:])
    if cache is not None:
        cache["len"].add_(t)
        if not paged:
            cache["host_len"] += t
    return result, cache


decode_step = forward


def prefill(params: dict, cfg: DecoderConfig, tokens, cache: dict, *, lm_head_mode="logits",
            last_only: bool = False, fuse: bool = True):
    """Feed a prompt ``tokens`` [B, T] into the cache as one forward.
    Returns ``(result [B, T, …], cache)`` or, with ``last_only``, only the
    last position's result ``[B, 1, …]`` (the lm_head runs once per row)."""
    return forward(params, cfg, tokens, cache, lm_head_mode=lm_head_mode, last_only=last_only, fuse=fuse)


def _check_room(cache: dict, n_steps: int) -> None:
    """IndexError unless every row of a contiguous cache holds ``n_steps``
    more tokens (on the host mirror ``host_len``: no device read); a paged
    pool's rows get their pages from the caller."""
    if "host_len" not in cache:
        return
    s_max = cache["k"][0].shape[2]
    full = np.flatnonzero(cache["host_len"] + n_steps > s_max)
    if full.size:
        r = int(full[0])
        raise IndexError(
            f"KV cache full: row {r} holds {int(cache['host_len'][r])} tokens + {n_steps} new, "
            f"past its {s_max} positions"
        )


def _scan_steps(params: dict, cfg: DecoderConfig, cache: dict, tok, rng, n_steps: int, sampler):
    """The decode loop of ``generate_scan``: ``n_steps`` one-token forwards
    from ``tok`` [B, 1], each token fed straight back on the device. Greedy
    (``sampler`` None) takes the lm_head kernel's fused argmax; a sampler
    gets the step's f32 logits and ``rng``. Returns the tokens [B, n_steps]."""
    out = []
    for _ in range(n_steps):
        if sampler is None:
            tok, cache = forward(params, cfg, tok, cache, lm_head_mode="argmax")
        else:
            logits, cache = forward(params, cfg, tok, cache)
            tok = sampler.sample(rng, logits[:, -1])[:, None]
        out.append(tok)
    return torch.cat(out, dim=1)


def _capturable(device, sampled: bool) -> bool:
    """Whether a decode path on ``device`` runs as a captured CUDA graph:
    on a CUDA device, and for a graph that samples (draws from a
    ``torch.Generator``) only where the installed torch can advance the
    generator at every replay (``CUDAGraph.register_generator_state``).
    Every path decides it before any capture, never by catching a capture
    error; a path that does not capture runs its steps eagerly, as on the
    CPU."""
    return torch.device(device).type == "cuda" and (
        not sampled or hasattr(torch.cuda.CUDAGraph, "register_generator_state"))


# The capture helper of the decode paths (``generate_scan``, the backends'
# one-token step, the serving engines' tick and step, the speculative
# rounds). It has no counterpart in the JAX package, where ``jax.jit`` and
# ``lax.scan`` make these loops one device program.


class Captured:
    """A callable captured as one CUDA graph: the static inputs it reads,
    its static outputs, the kernels' launch counts of one replay, and the
    objects whose device memory it reads (params, a generator) kept alive
    with it."""

    def __init__(self, graph, inputs, outputs, launches, keep):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.launches, self.keep = launches, keep

    def replay(self, *inputs):
        """Copy ``inputs`` into the static inputs, replay on the current
        stream and add one replay's launches to ``dispatch.LAUNCHES``.
        Returns the static outputs, which the next replay overwrites."""
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)
        self.graph.replay()
        dispatch.LAUNCHES.update(self.launches)
        return self.outputs


# Captured graphs by the state they read (weakly, on one of its tensors: a
# state's graphs go with it), then by the caller's key and the addresses
# and shapes of the state's tensors.
_GRAPHS = WeakIdKeyDictionary()
_CAPTURE_STREAMS: dict = {}


def state_tensors(state: dict) -> list:
    """Every tensor of a cache or decoder state (per-layer lists included),
    in key order: what a graph over the state reads and writes."""
    out = []
    for key in sorted(state):
        leaf = state[key]
        out += [t for t in (leaf if isinstance(leaf, list) else [leaf]) if isinstance(t, torch.Tensor)]
    return out


def scratch_like(state: dict) -> dict:
    """A state of the same kind, shapes and lengths with zero contents (a
    warm-up target that leaves the real one untouched)."""
    scratch = {key: [torch.zeros_like(t) for t in leaf] for key, leaf in state.items() if isinstance(leaf, list)}
    for key in ("len", "page_table"):
        if key in state:
            scratch[key] = state[key].clone()
    if "host_len" in state:
        scratch["host_len"] = state["host_len"].copy()
    return scratch


def graph_for(anchor, key: tuple, tensors, capture_fn) -> Captured:
    """The graph cached under ``key`` and the addresses and shapes of
    ``tensors`` (the state it reads), held weakly on the tensor ``anchor``;
    ``capture_fn()`` captures it at first use. A state whose tensors moved
    gets a graph of its own: no graph replays on stale addresses."""
    graphs = _GRAPHS.setdefault(anchor, {})
    key = (*key, tuple((t.data_ptr(), tuple(t.shape)) for t in tensors))
    entry = graphs.get(key)
    if entry is None:
        entry = graphs[key] = capture_fn()
    return entry


def capture(fn, inputs, warm, *, rng=None, states=(), keep=()) -> Captured:
    """Capture ``fn(*static_inputs)`` (a tensor or a tuple of tensors
    out) on the device's capture stream. ``warm()`` runs first on that
    stream, on scratch state: each kernel's first use (its build, its plan,
    the GEMV argmax's work buffer of the stream) must not happen under
    capture. Then the generator ``rng``, where given, is registered with
    the graph, so its state advances at every replay. The launch counters
    are put back as they were (a replay adds the captured counts), and the
    ``host_len`` of each cache in ``states`` as it was: the capture's own
    forwards added to it, a replay's caller adds what it advanced. Raises
    whatever the capture raises."""
    dev = inputs[0].device
    stream = _CAPTURE_STREAMS.get(dev)
    if stream is None:
        stream = _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    before = collections.Counter(dispatch.LAUNCHES)
    host_lens = [(st["host_len"], st["host_len"].copy()) for st in states if "host_len" in st]
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        warm()
    stream.synchronize()
    warmed = collections.Counter(dispatch.LAUNCHES)
    graph = torch.cuda.CUDAGraph()
    if rng is not None:
        graph.register_generator_state(rng)
    static = [x.clone() for x in inputs]
    with torch.cuda.graph(graph, stream=stream):
        outputs = fn(*static)
    launches = collections.Counter(dispatch.LAUNCHES)
    launches.subtract(warmed)
    dispatch.LAUNCHES.clear()
    dispatch.LAUNCHES.update(before)
    for host_len, saved in host_lens:
        host_len[:] = saved
    return Captured(graph, static, outputs, +launches, keep)


def step_graph(fn, params, cfg, tokens, state: dict, mode: str):
    """One forward ``fn(params, cfg, tokens, state, lm_head_mode=mode,
    last_only=True)`` of one token a row (``tokens`` [B, 1] on the card)
    as a replay of its captured graph, keyed on (fn, params, cfg, B, mode)
    and the state's tensors: the backends' decode step (the JAX package
    jits ``decode_step``). Checks the room on the host first, as ``fn``
    does, and advances ``host_len`` by one after the replay. Returns a copy
    of the graph's result [B, 1(, vocab)]."""
    _check_room(state, 1)

    def capture_fn():
        def warm():
            fn(params, cfg, tokens.clone(), scratch_like(state), lm_head_mode=mode, last_only=True)

        return capture(lambda t: fn(params, cfg, t, state, lm_head_mode=mode, last_only=True)[0], (tokens,), warm,
                       states=(state,), keep=(params,))

    entry = graph_for(state["len"], (fn, id(params), cfg, tokens.shape[0], mode), state_tensors(state), capture_fn)
    out = entry.replay(tokens).clone()
    state["host_len"] += 1
    return out


def generate_scan(params: dict, cfg: DecoderConfig, cache: dict, last_tokens, rng=None, *, n_steps: int,
                  sampler=None):
    """``n_steps`` decode steps from ``last_tokens`` [B, 1] int32 (the
    tokens to feed first), each step's token fed straight back on the
    device: the counterpart of the JAX package's ``generate_scan``
    (``rten_tpu/models/decoder.py:1226``, one ``lax.scan``). Returns
    ``(tokens [B, n_steps] int32, cache)``, the cache advanced in place.

    Greedy (``sampler`` None or an ``ArgMaxSampler``) takes each token from
    the lm_head kernel's fused argmax. Any other sampler gets each step's
    f32 logits (the lm_head GEMV without its argmax at ≤ 8 rows, the
    prefill projection above) and ``rng``, a ``torch.Generator`` on the
    cache's device (ValueError without one).

    The cache must hold ``n_steps`` more tokens in every row, checked once
    on the host before any step (IndexError, nothing run).

    On the card the steps are captured once into a ``torch.cuda.CUDAGraph``
    (``capture``; cached on the cache, the params, cfg, B, n_steps, the
    sampler and the generator) and replayed: each call copies
    ``last_tokens`` into the graph's static input and returns a copy of its
    static output. The generator is registered with the graph, so its state
    advances with every replay and the same seed gives the same tokens
    captured and eager. Replays run on the caller's current stream, in
    order: graphs captured on one device share its capture stream's GEMV
    argmax work buffer. Where the installed torch cannot advance a sampled
    graph's generator (``_capturable``) the steps run eagerly, as they do
    on the CPU."""
    from rten_tpu_torch.generate.sampler import ArgMaxSampler

    if isinstance(sampler, ArgMaxSampler):
        sampler = None
    if sampler is not None and rng is None:
        raise ValueError(f"{type(sampler).__name__} requires an rng (a torch.Generator)")
    _check_room(cache, n_steps)
    if not _capturable(last_tokens.device, sampler is not None):
        return _scan_steps(params, cfg, cache, last_tokens, rng, n_steps, sampler), cache

    def capture_fn():
        def warm():
            warm_rng = None if sampler is None else torch.Generator(device=last_tokens.device).manual_seed(0)
            _scan_steps(params, cfg, scratch_like(cache), last_tokens.clone(), warm_rng, 1, sampler)

        return capture(lambda tok: _scan_steps(params, cfg, cache, tok, rng, n_steps, sampler), (last_tokens,), warm,
                       rng=rng if sampler is not None else None, states=(cache,), keep=(params, rng))

    key = (id(params), cfg, last_tokens.shape[0], n_steps, sampler, None if sampler is None else id(rng))
    entry = graph_for(cache["len"], key, state_tensors(cache), capture_fn)
    tokens = entry.replay(last_tokens).clone()
    if "host_len" in cache:
        cache["host_len"] += n_steps
    return tokens, cache


def generate_greedy(params: dict, cfg: DecoderConfig, cache: dict, last_tokens, n_steps: int):
    """``n_steps`` greedy decode steps from ``last_tokens`` [B, 1]:
    ``generate_scan`` without a sampler. Returns ``(tokens [B, n_steps]
    int32, cache)``."""
    return generate_scan(params, cfg, cache, last_tokens, n_steps=n_steps)
