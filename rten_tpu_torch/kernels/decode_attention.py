"""Decode attention: one query token against a preallocated KV cache, with
the new token's k/v appended in place and, optionally, the int8 output
projection, its bias and the residual fused in; ``decode_block``, the same
with the rest of the transformer block (ln2, up, activation, down,
residual, and the next layer's ln1 + qkv) in one kernel; and
``decode_attention_int8``, attention over an int8 cache with per-(token, kv
head) scales (the output projection left to the caller). Kernel wrappers
beside their plain versions.

Counterpart of ``rten_tpu/kernels/decode_attention.py`` ``decode_attention``
(:734) in the modes the decoder's decode step uses: packed q|k|v
``[B, 3, H, 1, D]`` (MHA without RoPE) or unpacked ``(q [B, Hq, D], k_new
[B, Hk, D], v_new [B, Hk, D])`` with grouped-query heads (every RoPE or GQA
model; ``split_qkv``), in-place append at ``kv_len``, with the fused int8
``wo`` + bias + residual or without it (the attention vector of an unfused
step); with ``mlp=`` / ``next_qkv=`` (the whole-block "mega" mode, batch 1,
packed or unpacked) that is ``decode_block``. Its folded cache layout and
lane padding exist for Mosaic only; here the cache is logical
``[B, Hk, S, D]``. Each mode counts its launches under its own name
(``mode_name``): ``decode_attention``, ``decode_attention:gqa`` (Hq > Hk)
and ``decode_attention:no_wo``; ``decode_attention_int8`` and
``decode_attention_int8:gqa``; ``decode_block``, a grouped-query block
also under ``decode_block:gqa``.

The TPU kernels' ``batched=True`` modes (``_decode_attn_kernel_batched``,
``_decode_attn_int8_kernel_batched``: every row in one grid cell, with
per-row lengths) compute, row by row, what their per-row modes compute;
they exist to pay a TPU grid cell's fixed costs (its DMA chain, the
block-0 latency, the append's round trips) once for all rows instead of
once per row. A CUDA grid pays no such cost per row, so here both modes are
the one launch over all B rows that ``decode_attention`` and
``decode_attention_int8`` always make (a cluster of ``attention.kv_plan``
blocks a (kv head, row); the fused wo, a second launch, reads W_o once for
all rows).

Numerics (those of the Pallas kernel): scores, softmax statistics and the
attention vector are f32; the scale is ``1/sqrt(D)``; the output
projection multiplies the f32 attention vector by the int8 weights in f32
(no bf16 rounding), then ``* scales + bias + residual``.
"""

from __future__ import annotations

import functools
import math

import torch

from rten_tpu_torch.kernels import _build
from rten_tpu_torch.kernels.activations import ACTIVATIONS, activation_code
from rten_tpu_torch.kernels.attention import KV_CHUNK, kv_plan
from rten_tpu_torch.kernels.dispatch import LAUNCHES, PLAIN, use_kernel
from rten_tpu_torch.kernels.quant_matmul import (
    _NORM_CODES,
    MAX_ROWS,
    MAX_SPLIT,
    _check_weight,
    _device_index,
    _dot_operand,
    _norm_rows_f32,
    _ptr,
    _qdot,
    _stream,
    _vec_f32,
    gemv_device_plan,
    sm_count,
)

CHUNK = KV_CHUNK  # cache positions per split-KV chunk (csrc/kv_attention.cuh KV_CHUNK)
_LANES = 128  # the TPU's lane width, in the copied support rules below
# Head dims decode_block takes (csrc/decode_block.cu block_dim_ok): every
# divisor of 128, as the JAX mega rule admits; 8, 4, 2 and 1 run the 16
# instance with narrow rows.
BLOCK_HEAD_DIMS = (1, 2, 4, 8, 16, 32, 64, 128)


def kv_head_dim_supported(head_dim: int) -> bool:
    """Head dims the four KV kernels take: the head-dim terms of the JAX
    package's ``decode_attention_supported``
    (``rten_tpu/kernels/decode_attention.py:684``), a divisor of 128. Their
    S terms (the TPU's 128-lane folding) do not apply: the kernels take any
    S. Head dims 128, 64 and 32 have kernel instances; 16, 8, 4, 2 and 1
    run the 16 one (csrc/kv_attention.cuh)."""
    return 0 < head_dim <= _LANES and _LANES % head_dim == 0


def kv_mode_names(name: str, hq: int, hk: int, d: int, wo: bool = True) -> list[str]:
    """The launch counters a KV kernel's call adds one to: its mode
    (``mode_name``) and, at a head dim other than 64 and 128,
    ``name:d<D>``."""
    names = [mode_name(name, hq, hk, wo)]
    if d not in (64, 128):
        names.append(f"{name}:d{d}")
    return names


def _unpack(packed_qkv):
    b, three, h, one, d = packed_qkv.shape
    if three != 3 or one != 1:
        raise ValueError(f"packed_qkv must be [B, 3, H, 1, D], got {tuple(packed_qkv.shape)}")
    return b, h, d


def split_qkv(qkv):
    """The three operands of the KV kernels as ``(q [B, Hq, D], k_new [B,
    Hk, D], v_new [B, Hk, D])``. ``qkv`` is either a packed MHA tensor
    ``[B, 3, H, 1, D]`` (returned as three views of it, no copy) or the
    tuple ``(q, k_new, v_new)`` itself, with Hq a multiple of Hk: the
    unpacked operands of grouped-query attention and of RoPE, whose q and k
    are rotated after the projection. Query head h reads kv head
    h // (Hq / Hk)."""
    if isinstance(qkv, torch.Tensor):
        _unpack(qkv)
        return qkv[:, 0, :, 0], qkv[:, 1, :, 0], qkv[:, 2, :, 0]
    q, k_new, v_new = qkv
    if (q.dim() != 3 or k_new.dim() != 3 or k_new.shape != v_new.shape or q.shape[0] != k_new.shape[0]
            or q.shape[2] != k_new.shape[2] or q.shape[1] % k_new.shape[1]):
        raise ValueError(
            f"q {tuple(q.shape)}, k_new {tuple(k_new.shape)}, v_new {tuple(v_new.shape)} must be "
            "[B, Hq, D], [B, Hk, D], [B, Hk, D] with Hq a multiple of Hk"
        )
    return q, k_new, v_new


def mode_name(name: str, hq: int, hk: int, wo: bool = True) -> str:
    """The launch counter of a KV kernel's mode: ``name:no_wo`` for
    ``decode_attention`` without its fused wo, ``name:gqa`` for
    grouped-query heads (Hq > Hk), else ``name``."""
    if not wo:
        return name + ":no_wo"
    return name + ":gqa" if hq > hk else name


def attend_ref(q, keys, vals, sm_scale: float):
    """Softmax attention of one query per head in f32: q [Hq, D], keys and
    vals [Hk, L, D] (query head h reads kv head h // (Hq / Hk)) → [Hq·D]."""
    group = q.shape[0] // keys.shape[0]
    keys, vals = keys.float().repeat_interleave(group, 0), vals.float().repeat_interleave(group, 0)
    p = torch.softmax(torch.einsum("hd,hsd->hs", q.float(), keys) * sm_scale, dim=-1)
    return torch.einsum("hs,hsd->hd", p, vals).reshape(-1)


def _append_attend(ops, k_cache, v_cache, kv_len):
    """Append each row's new k/v at its ``kv_len`` in place and attend over
    the prefix and the new token: the f32 attention vector [B, Hq·D] of the
    plain versions. Reads ``kv_len`` on the host; a full row raises
    IndexError."""
    q, kn, vn = ops
    sm_scale = 1.0 / math.sqrt(q.shape[-1])
    rows = []
    for bi, length in enumerate(kv_len.tolist()):
        k_cache[bi, :, length] = kn[bi].to(k_cache.dtype)
        v_cache[bi, :, length] = vn[bi].to(v_cache.dtype)
        rows.append(attend_ref(q[bi], k_cache[bi, :, : length + 1], v_cache[bi, :, : length + 1], sm_scale))
    return torch.stack(rows)


def _project_wo(attn, wo_t, wo_scales, wo_bias, residual):
    out = (attn @ wo_t.float().t()) * wo_scales.float()
    if wo_bias is not None:
        out = out + wo_bias.float()
    if residual is not None:
        out = out + residual.float()
    return out


def decode_attention_ref(
    qkv, k_cache, v_cache, kv_len, wo_t=None, wo_scales=None, wo_bias=None, residual=None,
):
    """Plain version of ``decode_attention`` (same signature, result and
    in-place cache update). Reads ``kv_len`` on the host."""
    q, kn, vn = split_qkv(qkv)
    PLAIN[mode_name("decode_attention", q.shape[1], kn.shape[1], wo_t is not None)] += 1
    attn = _append_attend((q, kn, vn), k_cache, v_cache, kv_len)
    if wo_t is None:
        return attn.to(q.dtype)
    return _project_wo(attn, wo_t, wo_scales, wo_bias, residual).to(q.dtype)


def _operand_args(name: str, ops, d: int) -> list:
    """The kernels' leading arguments for q, k_new and v_new (pointers, then
    row strides in elements), checked: one dtype, f32 or bf16, each row's
    heads contiguous."""
    dtype = ops[0].dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: activations must be float32 or bfloat16, got {dtype}")
    if not kv_head_dim_supported(d):
        raise ValueError(f"{name}: head dim {d} does not divide 128, the head-dim rule of "
                         "rten_tpu/kernels/decode_attention.py:684 decode_attention_supported")
    for what, t in zip(("q", "k_new", "v_new"), ops):
        if t.dtype != dtype or t.stride(2) != 1 or (t.shape[1] > 1 and t.stride(1) != d):
            raise ValueError(f"{name}: {what} must be {dtype} with each row's heads contiguous")
    return [t.data_ptr() for t in ops] + [t.stride(0) for t in ops]


def decode_attention(
    qkv, k_cache, v_cache, kv_len, wo_t=None, wo_scales=None, wo_bias=None, residual=None,
):
    """``softmax(q·kᵀ/sqrt(D))·v`` over the valid prefix plus the new
    token, then (with ``wo_t``) the int8 output projection:

        out = attn @ W_o * wo_scales + wo_bias + residual

    qkv: the packed MHA ``[B, 3, H, 1, D]`` (q | k_new | v_new) or the tuple
    ``(q [B, Hq, D], k_new [B, Hk, D], v_new [B, Hk, D])`` of grouped-query
    attention and RoPE (``split_qkv``); k_cache, v_cache: [B, Hk, S, D] of
    the operands' dtype; kv_len: int32 [B], the valid length BEFORE this
    token, below S; wo_t: int8 [Dm, Hq·D] (``int8_pack``); residual [B, Dm].
    Writes k_new/v_new into the caches at ``kv_len`` in place, once per kv
    head, and returns out [B, Dm], or without ``wo_t`` the attention vector
    [B, Hq·D] in the operands' dtype (the JAX decoder's unfused step). A
    row whose cache is full (``kv_len`` ≥ S) raises IndexError in the plain
    version; the kernel, which does not read ``kv_len`` on the host, leaves
    the caches alone and returns NaN for that row (``decoder.forward``
    refuses a full cache beforehand).

    All B rows run in one launch, each at its own length: the port's
    counterpart of the TPU kernel's ``batched=True`` mode as well as of its
    per-row mode (see the module docstring). With the fused wo B is at most
    8; without it, any B.

    CUDA tensors launch ``csrc/decode_attention.cu`` (the clustered
    split-KV attention over (kv head, row), then with wo the output GEMV);
    CPU tensors run ``decode_attention_ref``."""
    q, kn, vn = split_qkv(qkv)
    b, hq, d = q.shape
    hk = kn.shape[1]
    with_wo = wo_t is not None
    if with_wo and b > MAX_ROWS:
        raise ValueError(f"decode_attention with the fused wo takes at most {MAX_ROWS} rows, got {b}")
    if k_cache.shape != v_cache.shape or k_cache.dim() != 4 or tuple(k_cache.shape[:2]) != (b, hk) \
            or k_cache.shape[3] != d:
        raise ValueError(
            f"caches {tuple(k_cache.shape)} do not fit q {tuple(q.shape)} and k_new {tuple(kn.shape)}"
        )
    dm = wo_t.shape[0] if with_wo else 0
    if with_wo and tuple(wo_t.shape) != (dm, hq * d):
        raise ValueError(f"wo {tuple(wo_t.shape)} does not fit {hq} heads of {d}")
    if residual is not None and tuple(residual.shape) != (b, dm):
        raise ValueError(f"residual shape {tuple(residual.shape)} != {(b, dm)}")
    if not use_kernel(q, kn, vn, k_cache, v_cache, kv_len, wo_t, wo_scales, wo_bias, residual):
        return decode_attention_ref(
            (q, kn, vn), k_cache, v_cache, kv_len, wo_t, wo_scales, wo_bias, residual
        )
    name = "decode_attention"
    ops = _operand_args(name, (q, kn, vn), d)
    dtype = q.dtype
    for what, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous {dtype}")
    if kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (b,) or not kv_len.is_contiguous():
        raise ValueError("kv_len must be a contiguous int32 [B] tensor")
    if residual is not None and (residual.dtype != dtype or not residual.is_contiguous()):
        raise ValueError("residual must be contiguous and of the activations' dtype")
    s_max = k_cache.shape[2]
    dev = q.device
    split = kv_device_plan("rt_decode_attention", q, hk, s_max, int(with_wo))
    attn = scales = bias = wo_plan = None
    work = 0
    if with_wo:
        _check_weight(wo_t, hq * d, "decode_attention wo")
        attn = torch.empty((b, hq * d), dtype=torch.float32, device=dev)
        out = torch.empty((b, dm), dtype=dtype, device=dev)
        scales = _vec_f32(wo_scales, dm, "wo scales")
        bias = _vec_f32(wo_bias, dm, "wo bias")
        wo_plan, work = gemv_device_plan(q, b, "f32", ((dm, hq * d, False, 4),))
        wo_plan = wo_plan.ints
    else:
        out = torch.empty((b, hq * d), dtype=dtype, device=dev)
    rc = _build.library().rt_decode_attention(
        *ops, int(dtype == torch.bfloat16), b, hq, hk, d,
        k_cache.data_ptr(), v_cache.data_ptr(), s_max, kv_len.data_ptr(), _ptr(attn), split,
        _ptr(wo_t), _ptr(scales), _ptr(bias), dm,
        _ptr(residual), out.data_ptr(),
        1.0 / math.sqrt(d),
        wo_plan, work or None, _stream(q),
    )
    _build.check(rc, name)
    for mode in kv_mode_names(name, hq, hk, d, with_wo):
        LAUNCHES[mode] += 1
    return out


# ---------------------------------------------------------------------------
# The whole block in one kernel (the TPU kernel's "mega" mode, batch 1)
# ---------------------------------------------------------------------------


def decode_attention_supported(head_dim: int, s_max: int, block_s: int = 256) -> bool:
    """The JAX package's shape gate of its decode attention kernel (a copy
    of ``rten_tpu/kernels/decode_attention.py:684``: 128-lane folding, an
    8-row append window), used here only inside ``mega_block_supported``."""
    bs = min(block_s, s_max)
    return (
        head_dim <= _LANES
        and _LANES % head_dim == 0
        and s_max % bs == 0
        and (bs * head_dim) % _LANES == 0
        and (s_max * head_dim) % (8 * _LANES) == 0
    )


def mega_block_supported(d_model: int, ff: int, n_qkv: int, hk: int, head_dim: int, s_max: int,
                         kv_bytes: int = 2, block_s: int = 256) -> bool:
    """Whether the JAX package runs a layer through its whole-block kernel:
    a copy of ``rten_tpu/kernels/decode_attention.py:697``
    ``mega_block_supported``, its TPU VMEM budget included (the attention
    double buffers plus the int8 MLP and next-qkv weights within 12 MB), so
    that the port takes ``decode_block`` on exactly the layers the JAX
    package takes its mega kernel on. ``decode_block`` itself has no such
    budget: its shared memory does not grow with the cache."""
    if not decode_attention_supported(head_dim, s_max, block_s):
        return False
    bs = min(block_s, s_max)
    rows = bs * head_dim // _LANES
    attn_bufs = 2 * 2 * hk * rows * _LANES * kv_bytes
    attn_bufs += 2 * 2 * hk * 8 * _LANES * kv_bytes
    weights = d_model * ff * 2 + d_model * n_qkv
    return attn_bufs + weights <= (12 << 20)


def decode_block_ref(
    qkv, k_cache, v_cache, kv_len, wo_t, wo_scales, wo_bias, residual, mlp, next_qkv=None, *,
    activation="gelu", norm="layernorm", norm_eps=1e-5,
):
    """Plain version of ``decode_block`` (same signature, result and in-place
    cache update), line by line the TPU kernel's mega branch
    (``decode_attention.py:337-405``). Reads ``kv_len`` on the host."""
    q, kn, vn = ops = split_qkv(qkv)
    PLAIN["decode_block"] += 1
    if q.shape[1] > kn.shape[1]:
        PLAIN[mode_name("decode_block", q.shape[1], kn.shape[1])] += 1
    dtype = q.dtype
    bf16 = dtype == torch.bfloat16
    attn = _append_attend(ops, k_cache, v_cache, kv_len)
    hidden = _project_wo(attn, wo_t, wo_scales, wo_bias, residual)  # f32, not rounded
    w_up_t, up_scales, w_down_t, down_scales, b_up, b_down, ln2_scale, ln2_bias = mlp
    xn = _norm_rows_f32(hidden, norm, norm_eps, ln2_scale, ln2_bias)
    up = _qdot(_dot_operand(xn, bf16), w_up_t, up_scales)
    if b_up is not None:
        up = up + b_up.float()
    up = ACTIVATIONS[activation](up)
    down = _qdot(_dot_operand(up, bf16), w_down_t, down_scales)
    if b_down is not None:
        down = down + b_down.float()
    down = down + hidden  # the block residual, f32
    out = down.to(dtype)
    if next_qkv is None:
        return out
    w_qkv_t, qkv_scales, qkv_bias, nns, nnb = next_qkv
    xq = _norm_rows_f32(down, norm, norm_eps, nns, nnb)
    nxt = _qdot(_dot_operand(xq, bf16), w_qkv_t, qkv_scales)
    if qkv_bias is not None:
        nxt = nxt + qkv_bias.float()
    return out, nxt.to(dtype)


def _aligned(n: int) -> int:
    return -(-n // 64) * 64  # 256-byte segments of the f32 scratch


BLOCK_STAMPS = 20  # %globaltimer stamps a block of decode_block_timed records (csrc/decode_block.cu DB_STAMPS)


def block_grid(device_index: int) -> int:
    """Blocks of a ``decode_block`` launch: one a SM, so that the blocks'
    shared memory together holds the layer's weights (a smaller grid gives
    the same bits; the card tests launch one)."""
    return sm_count(device_index)


def block_region() -> int:
    """Bytes of a block's shared memory ``decode_block`` may give its
    weights; 0: as many as fit beside the rest. A smaller region makes the
    kernel bring the weights in waves (the card tests set it so)."""
    return 0


def decode_block(
    qkv, k_cache, v_cache, kv_len, wo_t, wo_scales, wo_bias, residual, mlp, next_qkv=None, *,
    activation="gelu", norm="layernorm", norm_eps=1e-5,
):
    """A whole transformer block of one decode token (batch 1) in one
    kernel, the JAX package's ``decode_attention(..., mlp=, next_qkv=)``
    (the "mega" mode its decoder takes under ``RTEN_DECODE_FUSE=mega``):

        h   = decode_attention(...)                 in f32, not rounded
        out = act(norm(h) @ W_up · s + b_up) @ W_down · s + b_down + h
        qkv = norm_next(out) @ W_qkv · s + b_qkv    (with ``next_qkv``)

    qkv: the packed MHA ``[1, 3, H, 1, D]`` or the tuple ``(q [1, Hq, D],
    k_new [1, Hk, D], v_new [1, Hk, D])`` of grouped-query attention and
    RoPE (``split_qkv``); k_cache / v_cache [1, Hk, S, D]; kv_len int32
    [1]; wo_t int8 [Dm, Hq·D], wo_scales, wo_bias and residual [1, Dm] as
    in ``decode_attention``; ``mlp = (w_up_t int8 [FF, Dm], up_scales,
    w_down_t int8 [Dm, FF], down_scales, b_up|None, b_down|None, ln2_scale,
    ln2_bias|None)``; ``next_qkv = (w_qkv_t int8 [Nq, Dm], scales,
    bias|None, next_ln_scale, next_ln_bias|None)`` with Nq = (Hq + 2·Hk)·D
    for the decoder's next layer (any Nq here). Appends the new k/v at
    kv_len in place, once per kv head. Returns out [1, Dm], or (out, qkv
    [1, Nq]), in the operands' dtype.

    Its numbers are the TPU kernel's, not those of ``decode_attention``
    then ``quant_mlp_int8``: h stays f32 into ln2 and into the down
    projection's residual; the normalised row, the activated up row and the
    next-qkv input are rounded to the model dtype before their int8 dots;
    the next qkv normalises the f32 out. A full row (kv_len ≥ S) raises
    IndexError in the plain version; the kernel writes nothing and returns
    NaN.

    CUDA tensors launch ``csrc/decode_block.cu`` (one persistent cooperative
    kernel of ``block_grid`` blocks); CPU tensors run ``decode_block_ref``.
    Launches count under ``decode_block``, and also under
    ``decode_block:gqa`` for Hq > Hk (``mode_name``)."""
    return _decode_block(qkv, k_cache, v_cache, kv_len, wo_t, wo_scales, wo_bias, residual, mlp, next_qkv,
                         activation=activation, norm=norm, norm_eps=norm_eps, stamps=None)


def decode_block_timed(stamps, *args, **kw):
    """``decode_block(*args, **kw)`` through the kernel's measurement build,
    for timing its phases: ``stamps``, an int64 [grid, BLOCK_STAMPS] CUDA
    tensor, takes each block's %globaltimer stamps at its phases' steps and
    grid-wide waits, in the order ``decode_block_kernel`` lists them. bf16
    and head dim 64 only; the same results and bits as ``decode_block``."""
    if stamps is None or not stamps.is_cuda:
        raise ValueError("decode_block_timed: stamps must be a CUDA tensor")
    return _decode_block(*args, **kw, stamps=stamps)


def _decode_block(
    qkv, k_cache, v_cache, kv_len, wo_t, wo_scales, wo_bias, residual, mlp, next_qkv=None, *,
    activation="gelu", norm="layernorm", norm_eps=1e-5, stamps=None,
):
    q, kn, vn = ops = split_qkv(qkv)
    b, hq, d = q.shape
    hk = kn.shape[1]
    if b != 1:
        raise ValueError(f"decode_block runs batch 1 (the TPU kernel's mega mode), got {b} rows")
    w_up_t, up_scales, w_down_t, down_scales, b_up, b_down, ln2_scale, ln2_bias = mlp
    dm, ff = wo_t.shape[0], w_up_t.shape[0]
    if tuple(wo_t.shape) != (dm, hq * d) or tuple(w_up_t.shape) != (ff, dm) or tuple(w_down_t.shape) != (dm, ff):
        raise ValueError(
            f"block weights wo {tuple(wo_t.shape)}, up {tuple(w_up_t.shape)}, down {tuple(w_down_t.shape)} "
            f"do not fit {hq} heads of {d}"
        )
    if k_cache.shape != v_cache.shape or k_cache.dim() != 4 or tuple(k_cache.shape[:2]) != (1, hk) \
            or k_cache.shape[3] != d:
        raise ValueError(f"caches {tuple(k_cache.shape)} do not fit q {tuple(q.shape)} and k_new {tuple(kn.shape)}")
    if tuple(residual.shape) != (1, dm):
        raise ValueError(f"residual shape {tuple(residual.shape)} != {(1, dm)}")
    if norm not in ("layernorm", "rmsnorm"):
        raise ValueError(f"decode_block needs the fused norm (layernorm or rmsnorm), got {norm!r}")
    extra = list(next_qkv) if next_qkv is not None else []
    if not use_kernel(*ops, k_cache, v_cache, kv_len, wo_t, wo_scales, wo_bias, residual, *mlp, *extra):
        return decode_block_ref(ops, k_cache, v_cache, kv_len, wo_t, wo_scales, wo_bias, residual, mlp,
                                next_qkv, activation=activation, norm=norm, norm_eps=norm_eps)
    name = "decode_block"
    if d not in BLOCK_HEAD_DIMS:
        raise ValueError(f"decode_block: head dim {d} is not one of {BLOCK_HEAD_DIMS}, the head dims of "
                         "rten_tpu/kernels/decode_attention.py:697 mega_block_supported")
    _operand_args(name, ops, d)
    dtype = q.dtype
    for what, t in (("k_cache", k_cache), ("v_cache", v_cache), ("residual", residual)):
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"decode_block: {what} must be contiguous {dtype}")
    if kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (1,) or not kv_len.is_contiguous():
        raise ValueError("decode_block: kv_len must be a contiguous int32 [1] tensor")
    _check_weight(wo_t, hq * d, "decode_block wo")
    _check_weight(w_up_t, dm, "decode_block w_up")
    _check_weight(w_down_t, ff, "decode_block w_down")
    s_max = k_cache.shape[2]
    n_chunks = -(-s_max // CHUNK)
    dev = q.device
    grid = block_grid(_device_index(q))
    if stamps is not None and (stamps.dtype != torch.int64 or tuple(stamps.shape) != (grid, BLOCK_STAMPS)
                               or stamps.device != dev):
        raise ValueError(f"decode_block: stamps must be an int64 [{grid}, {BLOCK_STAMPS}] tensor on {dev}")
    # One f32 scratch: each (query head, chunk)'s P.V, max and sum (d + 4
    # floats; 16 + 4 for the narrow rows of d < 16), h, the up row and the
    # f32 block output, each 256-byte aligned.
    sizes = (hq * n_chunks * (max(d, 16) + 4), dm, ff, dm)
    scratch = torch.empty(sum(_aligned(n) for n in sizes), dtype=torch.float32, device=dev)
    ptrs, off = [], 0
    for n in sizes:
        ptrs.append(scratch.data_ptr() + 4 * off)
        off += _aligned(n)
    part, h_buf, u_buf, out_f32 = ptrs
    out = torch.empty((1, dm), dtype=dtype, device=dev)
    # Every converted vector stays bound to a name until the launch is
    # enqueued, so the allocator cannot hand its memory to the next one.
    sw, bw = _vec_f32(wo_scales, dm, "wo scales"), _vec_f32(wo_bias, dm, "wo bias")
    su, bu = _vec_f32(up_scales, ff, "up scales"), _vec_f32(b_up, ff, "b_up")
    sd, bd = _vec_f32(down_scales, dm, "down scales"), _vec_f32(b_down, dm, "b_down")
    ns, nb = _vec_f32(ln2_scale, dm, "ln2 scale"), _vec_f32(ln2_bias, dm, "ln2 bias")
    wq = sq = bq = qns = qnb = nxt = None
    nq = 0
    if next_qkv is not None:
        wq, sq, bq, qns, qnb = next_qkv
        nq = wq.shape[0]
        _check_weight(wq, dm, "decode_block next qkv")
        sq, bq = _vec_f32(sq, nq, "next qkv scales"), _vec_f32(bq, nq, "next qkv bias")
        qns, qnb = _vec_f32(qns, dm, "next norm scale"), _vec_f32(qnb, dm, "next norm bias")
        nxt = torch.empty((1, nq), dtype=dtype, device=dev)
    rc = _build.library().rt_decode_block(
        q.data_ptr(), kn.data_ptr(), vn.data_ptr(), int(dtype == torch.bfloat16), hq, hk, d,
        k_cache.data_ptr(), v_cache.data_ptr(), s_max, kv_len.data_ptr(),
        part, n_chunks,
        wo_t.data_ptr(), sw.data_ptr(), _ptr(bw), dm,
        residual.data_ptr(), h_buf,
        w_up_t.data_ptr(), su.data_ptr(), _ptr(bu), ff, u_buf,
        w_down_t.data_ptr(), sd.data_ptr(), _ptr(bd),
        ns.data_ptr(), _ptr(nb), _NORM_CODES[norm], float(norm_eps), activation_code(activation),
        out.data_ptr(), out_f32,
        _ptr(wq), _ptr(sq), _ptr(bq), nq, _ptr(qns), _ptr(qnb), _ptr(nxt),
        1.0 / math.sqrt(d), grid, block_region(), _ptr(stamps), _stream(q),
    )
    _build.check(rc, name)
    LAUNCHES[name] += 1
    if hq > hk:
        LAUNCHES[mode_name(name, hq, hk)] += 1
    if d not in (64, 128):
        LAUNCHES[f"{name}:d{d}"] += 1
    return out if next_qkv is None else (out, nxt)


# ---------------------------------------------------------------------------
# INT8 KV cache
# ---------------------------------------------------------------------------


def quantize_kv(x):
    """Per-(token, head) absmax int8 quantization over the last axis: x
    [..., D] → (int8 codes [..., D], f32 scales [...]). A copy of the JAX
    package's ``quantize_kv`` (``rten_tpu/models/encoder_decoder.py:313``),
    which the TPU kernels also apply to the new token: scale = absmax / 127
    (1 where absmax is 0), codes = round(x / scale) half to even, clipped to
    ±127. The port keeps scales without the trailing axis of length 1."""
    xf = x.float()
    absmax = xf.abs().amax(-1)
    # A tensor divisor keeps the division IEEE on every device: PyTorch's
    # CUDA division by a Python scalar multiplies by its reciprocal instead.
    scales = torch.where(absmax == 0, torch.ones_like(absmax), absmax / torch.full_like(absmax, 127.0))
    codes = torch.clamp(torch.round(xf / scales[..., None]), -127, 127).to(torch.int8)
    return codes, scales


def dequantize_kv(codes, scales, dtype):
    """``codes * scales`` in f32, then cast to ``dtype``
    (``encoder_decoder.py:321``)."""
    return (codes.float() * scales[..., None].float()).to(dtype)


def decode_attention_int8_ref(qkv, k_cache, v_cache, k_scale, v_scale, kv_len):
    """Plain version of ``decode_attention_int8`` (same signature, result and
    in-place cache update). Reads ``kv_len`` on the host."""
    q, kn, vn = split_qkv(qkv)
    PLAIN[mode_name("decode_attention_int8", q.shape[1], kn.shape[1])] += 1
    s_max = k_cache.shape[2]
    (knq, kns), (vnq, vns) = quantize_kv(kn), quantize_kv(vn)
    rows = []
    for bi, length in enumerate(kv_len.tolist()):
        if not 0 <= length < s_max:
            raise IndexError(f"decode_attention_int8: row {bi} holds {length} of {s_max} positions")
        k_cache[bi, :, length], k_scale[bi, :, length] = knq[bi], kns[bi]
        v_cache[bi, :, length], v_scale[bi, :, length] = vnq[bi], vns[bi]
        n = length + 1
        keys = dequantize_kv(k_cache[bi, :, :n], k_scale[bi, :, :n], torch.float32)
        vals = dequantize_kv(v_cache[bi, :, :n], v_scale[bi, :, :n], torch.float32)
        rows.append(attend_ref(q[bi], keys, vals, 1.0 / math.sqrt(q.shape[-1])))
    return torch.stack(rows).to(q.dtype)


def check_kv_operands(name, qkv, payload, scales, heads_axis: int):
    """Shared wrapper checks of the KV kernels (kv_attention.cuh): the
    operands of ``split_qkv``, a payload with Hk at ``heads_axis`` and D
    last, and (int8) f32 scales of the payload's shape without D. Returns
    the operands (q, k_new, v_new)."""
    q, kn, vn = ops = split_qkv(qkv)
    k, v = payload
    if k.shape != v.shape or k.dim() != 4 or k.shape[heads_axis] != kn.shape[1] or k.shape[3] != q.shape[2]:
        raise ValueError(f"{name}: KV {tuple(k.shape)} does not fit q {tuple(q.shape)} and k_new {tuple(kn.shape)}")
    if scales is not None:
        for s in scales:
            if tuple(s.shape) != tuple(k.shape[:3]):
                raise ValueError(f"{name}: scales {tuple(s.shape)} must be {tuple(k.shape[:3])}")
    return ops


@functools.lru_cache(maxsize=64)
def kv_cluster_capacity(device_index: int, entry: str, *variant: int) -> tuple[int, ...]:
    """``fits`` of ``attention.kv_plan`` for the kernel that the KV entry
    point ``entry`` launches in ``variant`` (its ``*_clusters`` arguments
    before the cluster size: bf16, head dim, GQA, and for
    ``rt_decode_attention`` the fused wo): the clusters of 1..MAX_SPLIT
    blocks this device holds at once (``cudaOccupancyMaxActiveClusters``),
    queried once."""
    fn = getattr(_build.library(), entry + "_clusters")
    with torch.cuda.device(device_index):
        fits = tuple(int(fn(*variant, c)) for c in range(1, MAX_SPLIT + 1))
    for c, n in enumerate(fits, 1):
        if n < 0:
            _build.check(-n, f"{entry} cluster capacity ({variant}, cluster {c})")
    return fits


def kv_device_plan(entry: str, q, hk: int, cap: int, *extra: int) -> int:
    """``attention.kv_plan`` of a KV kernel's launch over q [B, Hq, D] on
    q's card, with its SM count and the launched kernel's cluster capacity
    (``extra``: ``rt_decode_attention``'s fused-wo flag)."""
    b, hq, d = q.shape
    idx = _device_index(q)
    fits = kv_cluster_capacity(idx, entry, int(q.dtype == torch.bfloat16), d, int(hq > hk), *extra)
    return kv_plan(b, hk, hq // hk, cap, sm_count(idx), fits)


def launch_kv_attention(name, entry, ops, tensors, kv_len, cap: int, scalars, modes=()):
    """Launch one of the KV kernels (kv_attention.cuh) on CUDA tensors:
    ``ops`` (q, k_new, v_new) as ``split_qkv`` gives them, ``tensors`` the
    (payload k, v, [scales k, v]) whose dtypes are checked, ``scalars`` the
    entry's arguments between the scales and ``kv_len``, ``modes`` launch
    counters it adds one to beside ``kv_mode_names``'. Returns the
    attention vector [B, Hq·D] in the operands' dtype."""
    q, kn, _vn = ops
    b, hq, d = q.shape
    hk = kn.shape[1]
    args = _operand_args(name, ops, d)
    dtype = q.dtype
    int8 = len(tensors) == 4
    for i, t in enumerate(tensors):
        want = (torch.int8 if i < 2 else torch.float32) if int8 else dtype
        if t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name}: cache operand {i} must be contiguous {want}, got {t.dtype}")
    if kv_len.dtype != torch.int32 or tuple(kv_len.shape) != (b,) or not kv_len.is_contiguous():
        raise ValueError(f"{name}: kv_len must be a contiguous int32 [B] tensor")
    split = kv_device_plan(entry, q, hk, cap)
    out = torch.empty((b, hq * d), dtype=dtype, device=q.device)
    rc = getattr(_build.library(), entry)(
        *args, int(dtype == torch.bfloat16), b, hq, hk, d,
        *(t.data_ptr() for t in tensors), *scalars, kv_len.data_ptr(), split,
        out.data_ptr(), 1.0 / math.sqrt(d), _stream(q),
    )
    _build.check(rc, name)
    for mode in (*kv_mode_names(name, hq, hk, d), *modes):
        LAUNCHES[mode] += 1
    return out


def decode_attention_int8(qkv, k_cache, v_cache, k_scale, v_scale, kv_len):
    """Decode attention over an int8 KV cache:

        attn = softmax(q·kᵀ/sqrt(D))·v  over the valid prefix and the new token

    qkv: the packed MHA ``[B, 3, H, 1, D]`` or the tuple ``(q [B, Hq, D],
    k_new [B, Hk, D], v_new [B, Hk, D])`` (``split_qkv``) in f32 or bf16;
    k_cache, v_cache: int8 [B, Hk, S, D]; k_scale, v_scale: f32 [B, Hk, S],
    one scale per (token, kv head); kv_len: int32 [B], the valid length
    before this token. The new token is quantized per kv head
    (``quantize_kv``) and written with its scales at ``kv_len`` in place;
    its score and value use the dequantized codes. The cache is dequantized
    in f32. Returns the attention vector [B, Hq·D] in the operands' dtype
    (the output projection is the caller's, as on the TPU path). A full row
    (``kv_len`` ≥ S) raises IndexError in the plain version; the kernel
    writes nothing and returns NaN for it.

    Counterpart of ``rten_tpu/kernels/decode_attention.py``
    ``decode_attention_int8`` (:1667) in its per-row mode and its
    ``batched=True`` mode, both the one launch over all B rows (see the
    module docstring), MHA and GQA. Its scale layout
    ``[B, Hk, 8, S·D/128]`` exists for Mosaic; here the scales are logical
    ``[B, Hk, S]``. CUDA tensors launch ``csrc/decode_attention_int8.cu``;
    CPU tensors run ``decode_attention_int8_ref``."""
    name = "decode_attention_int8"
    ops = check_kv_operands(name, qkv, (k_cache, v_cache), (k_scale, v_scale), 1)
    if k_cache.shape[0] != ops[0].shape[0]:
        raise ValueError(f"{name}: cache batch {k_cache.shape[0]} != {ops[0].shape[0]}")
    if not use_kernel(*ops, k_cache, v_cache, k_scale, v_scale, kv_len):
        return decode_attention_int8_ref(ops, k_cache, v_cache, k_scale, v_scale, kv_len)
    s_max = k_cache.shape[2]
    return launch_kv_attention(name, "rt_decode_attention_int8", ops,
                               (k_cache, v_cache, k_scale, v_scale), kv_len, s_max, (s_max,))
