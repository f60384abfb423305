"""Decode attention: one query token against a preallocated KV cache, with
the new token's k/v appended in place and the int8 output projection, its
bias and the residual fused in. Kernel wrapper beside its plain version.

Counterpart of ``rten_tpu/kernels/decode_attention.py`` ``decode_attention``
(:734) in the mode the decoder's decode step uses: packed q|k|v
``[B, 3, H, 1, D]`` (MHA), in-place append at ``kv_len``, fused int8
``wo`` + bias + residual. Its folded cache layout and lane padding exist
for Mosaic only; here the cache is logical ``[B, H, S, D]``.

Numerics (those of the Pallas kernel): scores, softmax statistics and the
attention vector are f32; the scale is ``1/sqrt(D)``; the output
projection multiplies the f32 attention vector by the int8 weights in f32
(no bf16 rounding), then ``* scales + bias + residual``.
"""

from __future__ import annotations

import math

import torch

from rten_tpu_torch.kernels import _build
from rten_tpu_torch.kernels.dispatch import LAUNCHES, PLAIN, use_kernel
from rten_tpu_torch.kernels.quant_matmul import (
    MAX_ROWS,
    _check_weight,
    _ptr,
    _stream,
    _vec_f32,
)

CHUNK = 64  # cache positions per split-KV block (csrc/decode_attention.cu ATTN_CHUNK)
HEAD_DIMS = (64, 128)


def _unpack(packed_qkv):
    b, three, h, one, d = packed_qkv.shape
    if three != 3 or one != 1:
        raise ValueError(f"packed_qkv must be [B, 3, H, 1, D], got {tuple(packed_qkv.shape)}")
    return b, h, d


def decode_attention_ref(
    packed_qkv, k_cache, v_cache, kv_len, wo_t, wo_scales, wo_bias=None, residual=None,
):
    """Plain version of ``decode_attention`` (same signature, result and
    in-place cache update). Reads ``kv_len`` on the host."""
    PLAIN["decode_attention"] += 1
    b, h, d = _unpack(packed_qkv)
    sm_scale = 1.0 / math.sqrt(d)
    q, kn, vn = packed_qkv[:, 0, :, 0], packed_qkv[:, 1, :, 0], packed_qkv[:, 2, :, 0]
    rows = []
    for bi, length in enumerate(kv_len.tolist()):
        k_cache[bi, :, length] = kn[bi].to(k_cache.dtype)
        v_cache[bi, :, length] = vn[bi].to(v_cache.dtype)
        keys = k_cache[bi, :, : length + 1].float()  # [H, L+1, D]
        vals = v_cache[bi, :, : length + 1].float()
        s = torch.einsum("hd,hsd->hs", q[bi].float(), keys) * sm_scale
        p = torch.softmax(s, dim=-1)
        rows.append(torch.einsum("hs,hsd->hd", p, vals).reshape(-1))
    attn = torch.stack(rows)  # [B, H·D] f32
    out = (attn @ wo_t.float().t()) * wo_scales.float()
    if wo_bias is not None:
        out = out + wo_bias.float()
    if residual is not None:
        out = out + residual.float()
    return out.to(packed_qkv.dtype)


def decode_attention(
    packed_qkv, k_cache, v_cache, kv_len, wo_t, wo_scales, wo_bias=None, residual=None,
):
    """``softmax(q·kᵀ/sqrt(D))·v`` over the valid prefix plus the new
    token, then the int8 output projection:

        out = attn @ W_o * wo_scales + wo_bias + residual

    packed_qkv: [B, 3, H, 1, D] (q | k_new | v_new, MHA); k_cache, v_cache:
    [B, H, S, D] of packed_qkv's dtype; kv_len: int32 [B], the valid length
    BEFORE this token, below S; wo_t: int8 [Dm, H·D] (``int8_pack``);
    residual [B, Dm]. Writes k_new/v_new into the caches at ``kv_len`` in
    place and returns out [B, Dm]. A row whose cache is full (``kv_len`` ≥
    S) raises IndexError in the plain version; the kernel, which does not
    read ``kv_len`` on the host, leaves the caches alone and returns NaN
    for that row (``decoder.forward`` refuses a full cache beforehand).

    CUDA tensors launch ``csrc/decode_attention.cu`` (split-KV scores and
    partial softmax, combine, output GEMV); CPU tensors run
    ``decode_attention_ref``."""
    b, h, d = _unpack(packed_qkv)
    dm = wo_t.shape[0]
    if b > MAX_ROWS:
        raise ValueError(f"decode_attention takes at most {MAX_ROWS} rows, got {b}")
    if k_cache.shape != v_cache.shape or k_cache.dim() != 4 or tuple(k_cache.shape[:2]) != (b, h) \
            or k_cache.shape[3] != d:
        raise ValueError(
            f"caches {tuple(k_cache.shape)} do not fit packed_qkv {tuple(packed_qkv.shape)}"
        )
    if tuple(wo_t.shape) != (dm, h * d):
        raise ValueError(f"wo {tuple(wo_t.shape)} does not fit {h} heads of {d}")
    if residual is not None and tuple(residual.shape) != (b, dm):
        raise ValueError(f"residual shape {tuple(residual.shape)} != {(b, dm)}")
    if not use_kernel(packed_qkv, k_cache, v_cache, kv_len, wo_t, wo_scales, wo_bias, residual):
        return decode_attention_ref(
            packed_qkv, k_cache, v_cache, kv_len, wo_t, wo_scales, wo_bias, residual
        )
    dtype = packed_qkv.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_attention: activations must be float32 or bfloat16, got {dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel supports head_dim in {HEAD_DIMS}, got {d}")
    for name, t in (("packed_qkv", packed_qkv), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype}")
    if kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (b,) or not kv_len.is_contiguous():
        raise ValueError("kv_len must be a contiguous int32 [B] tensor")
    if residual is not None and (residual.dtype != dtype or not residual.is_contiguous()):
        raise ValueError("residual must be contiguous and of the activations' dtype")
    _check_weight(wo_t, h * d, "decode_attention wo")
    s_max = k_cache.shape[2]
    n_chunks = -(-s_max // CHUNK)
    dev = packed_qkv.device
    part_m = torch.empty((b, h, n_chunks), dtype=torch.float32, device=dev)
    part_l = torch.empty((b, h, n_chunks), dtype=torch.float32, device=dev)
    part_acc = torch.empty((b, h, n_chunks, d), dtype=torch.float32, device=dev)
    attn = torch.empty((b, h * d), dtype=torch.float32, device=dev)
    out = torch.empty((b, dm), dtype=dtype, device=dev)
    scales = _vec_f32(wo_scales, dm, "wo scales")
    bias = _vec_f32(wo_bias, dm, "wo bias")
    rc = _build.library().rt_decode_attention(
        packed_qkv.data_ptr(), int(dtype == torch.bfloat16), b, h, d,
        k_cache.data_ptr(), v_cache.data_ptr(), s_max, kv_len.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(), attn.data_ptr(), n_chunks,
        wo_t.data_ptr(), scales.data_ptr(), _ptr(bias), dm,
        _ptr(residual), out.data_ptr(),
        1.0 / math.sqrt(d),
        _stream(packed_qkv),
    )
    _build.check(rc, "decode_attention")
    LAUNCHES["decode_attention"] += 1
    return out
