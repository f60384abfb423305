"""INT8 weight-only decode kernels: ``quant_gemv_int8`` and
``quant_mlp_int8``, each beside its plain PyTorch version.

Counterpart of ``rten_tpu/kernels/quant_matmul.py`` (``quant_gemv_int8``
:339, ``quant_mlp_int8`` :935) for the weight-only decode path; its
``w8a8`` mode is not ported yet. Weights are int8 with per-output-channel
f32 scales; activations are f32 or bf16, and every sum is kept in f32.

Weight layout: the port stores every int8 matrix transposed, ``[N, K]`` with
K contiguous (``int8_pack``), so that a warp reads each output column's
weights as 16 contiguous bytes a thread. The JAX package's row-major
``[K, N]`` and tiled ``[S, K, bn]`` packs convert once at load time.

Numerics of both the kernels and the plain versions (those of the Pallas
kernels): the optional pre-norm runs in f32 on the whole row; with bf16
activations the normalized row is rounded to bf16 before the dot; the
epilogue order is ``acc * scale → + bias → activation → + residual``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from rten_tpu_torch.kernels import _build
from rten_tpu_torch.kernels.activations import ACTIVATIONS, activation_code
from rten_tpu_torch.kernels.dispatch import LAUNCHES, PLAIN, use_kernel

MAX_ROWS = 8  # decode GEMV rows (batch x tokens), as on the TPU
_NORM_CODES = {None: 0, "layernorm": 1, "rmsnorm": 2}
_ARGMAX_MASK = -3.389e38  # value of columns >= argmax_n (the TPU kernel's)


# ---------------------------------------------------------------------------
# Quantization and the port's weight layout (numpy; no device)
# ---------------------------------------------------------------------------


def quantize_weights_int8(w, axis: int = -1):
    """Symmetric per-channel int8 quantization of a weight matrix.

    Returns (w_int8, scales_f32) with ``w ≈ w_int8 * scales`` broadcast along
    ``axis`` (the output-channel axis keeps its own scale). A copy of the
    JAX package's numpy quantizer, so both give the same bits."""
    w = np.asarray(w, dtype=np.float32)
    reduce_axes = tuple(i for i in range(w.ndim) if i != (axis % w.ndim))
    absmax = np.abs(w).max(axis=reduce_axes, keepdims=True)
    scales = np.where(absmax == 0, 1.0, absmax / 127.0).astype(np.float32)
    q = np.clip(np.round(w / scales), -127, 127).astype(np.int8)
    return q, np.squeeze(scales, axis=reduce_axes).astype(np.float32)


def untile_gemv_weights(w_tiled, n: int | None = None) -> np.ndarray:
    """``[S, K, bn] → [K, S·bn]`` (sliced to n): undoes the JAX package's
    contiguous-stripe tiling of GEMV weights."""
    w = np.asarray(w_tiled)
    s, k, bn = w.shape
    out = w.transpose(1, 0, 2).reshape(k, s * bn)
    return out if n is None else out[:, :n]


def int8_pack(q, s, device="cpu") -> dict:
    """The port's int8 pack from a row-major ``[K, N]`` or tiled
    ``[S, K, bn]`` int8 matrix and its per-column scales:
    ``{"qt": int8 [N, K] (K contiguous), "s": f32 [N]}``."""
    q = np.asarray(q)
    if q.ndim == 3:
        q = untile_gemv_weights(q)
    if q.ndim != 2 or q.dtype != np.int8:
        raise ValueError(f"expected an int8 [K, N] or [S, K, bn] matrix, got {q.dtype} {q.shape}")
    s = np.asarray(s, np.float32).reshape(-1)
    if s.shape[0] != q.shape[1]:
        raise ValueError(f"{s.shape[0]} scales for {q.shape[1]} columns")
    return {
        "qt": torch.from_numpy(np.ascontiguousarray(q.T)).to(device),
        "s": torch.from_numpy(s.copy()).to(device),
    }


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _norm_rows_f32(x, norm, eps, scale, bias):
    """f32 row norm over the whole row (the kernels' prologue)."""
    if norm == "rmsnorm":
        x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    else:
        xc = x - x.mean(-1, keepdim=True)
        x = xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    x = x * scale.float()
    if bias is not None:
        x = x + bias.float()
    return x


def _dot_operand(x, bf16: bool):
    """The f32 rows as the dot sees them: rounded to bf16 when the model
    runs bf16 activations."""
    return x.to(torch.bfloat16).float() if bf16 else x


def _qdot(xs, w_t, scales):
    return (xs @ w_t.float().t()) * scales.float()


def quant_gemv_int8_ref(
    x, w_t, scales, bias=None, *, activation=None, norm=None, norm_scale=None,
    norm_bias=None, norm_eps=1e-5, residual=None, out_dtype=None, argmax_n=None,
):
    """Plain version of ``quant_gemv_int8`` (same signature and result)."""
    PLAIN["quant_gemv_int8"] += 1
    out_dtype = out_dtype or x.dtype
    xs = x.float()
    if norm is not None:
        xs = _norm_rows_f32(xs, norm, norm_eps, norm_scale, norm_bias)
    out = _qdot(_dot_operand(xs, x.dtype == torch.bfloat16), w_t, scales)
    if bias is not None:
        out = out + bias.float()
    out = ACTIVATIONS[activation](out)
    if residual is not None:
        out = out + residual.float()
    if argmax_n is not None:
        col = torch.arange(out.shape[1], device=out.device)
        out = torch.where(col < argmax_n, out, torch.full_like(out, _ARGMAX_MASK))
        return torch.argmax(out, dim=1).to(torch.int32)  # first index among equal maxima
    return out.to(out_dtype)


def quant_mlp_int8_ref(
    x, w_up_t, up_scales, w_down_t, down_scales, b_up=None, b_down=None, *,
    activation="gelu", norm=None, norm_scale=None, norm_bias=None, norm_eps=1e-5,
    residual=None, next_qkv=None,
):
    """Plain version of ``quant_mlp_int8`` (same signature and result)."""
    PLAIN["quant_mlp_int8"] += 1
    bf16 = x.dtype == torch.bfloat16
    xs = x.float()
    if norm is not None:
        xs = _norm_rows_f32(xs, norm, norm_eps, norm_scale, norm_bias)
    up = _qdot(_dot_operand(xs, bf16), w_up_t, up_scales)
    if b_up is not None:
        up = up + b_up.float()
    up = ACTIVATIONS[activation](up)
    down = _qdot(_dot_operand(up, bf16), w_down_t, down_scales)
    if b_down is not None:
        down = down + b_down.float()
    if residual is not None:
        down = down + residual.float()
    out = down.to(x.dtype)
    if next_qkv is None:
        return out
    w_qkv_t, qkv_scales, qkv_bias, nns, nnb = next_qkv
    # The next layer's norm reads the f32 block output, before its rounding.
    xq = _norm_rows_f32(down, norm, norm_eps, nns, nnb)
    qkv = _qdot(_dot_operand(xq, bf16), w_qkv_t, qkv_scales)
    if qkv_bias is not None:
        qkv = qkv + qkv_bias.float()
    return out, qkv.to(x.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(t) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _vec_f32(t, n: int, what: str):
    """A per-channel vector as the kernels read it: contiguous, 16-byte
    aligned f32 [n] (a copy only when the given one is not)."""
    if t is None:
        return None
    t = t.reshape(-1)
    if t.shape[0] != n:
        raise ValueError(f"{what}: expected {n} values, got {t.shape[0]}")
    if t.dtype != torch.float32 or not t.is_contiguous() or t.data_ptr() % 16:
        t = t.to(torch.float32, memory_format=torch.contiguous_format).clone()
    return t


def _check_act(x, what: str):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: activations must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16 or x.shape[-1] % 4:
        raise ValueError(
            f"{what}: activations must be contiguous, 16-byte aligned, with a row width "
            "that is a multiple of 4"
        )


def _check_weight(w_t, k: int, what: str):
    if w_t.dtype != torch.int8 or w_t.dim() != 2 or not w_t.is_contiguous():
        raise ValueError(f"{what}: weights must be a contiguous int8 [N, K] matrix (int8_pack)")
    if w_t.shape[1] != k or k % 16 or w_t.data_ptr() % 16:
        raise ValueError(
            f"{what}: weight K={w_t.shape[1]} must equal the row width {k}, be a multiple "
            "of 16, and be 16-byte aligned"
        )


@functools.cache
def max_blocks(device_index: int) -> int:
    """Capacity of the argmax partial buffers: the most blocks a GEMV
    launch uses on this device (8 per SM, as csrc/gemv.cuh plans it)."""
    with torch.cuda.device(device_index):
        return int(_build.library().rt_max_blocks())


def quant_gemv_int8(
    x, w_t, scales, bias=None, *, activation=None, norm=None, norm_scale=None,
    norm_bias=None, norm_eps=1e-5, residual=None, out_dtype=None, argmax_n=None,
):
    """Decode-path GEMV for M ≤ 8 rows:

        out = activation((norm(x) @ W) * scales + bias) + residual

    x: [M, K] f32/bf16; w_t: int8 [N, K] (``int8_pack``); scales [N] f32;
    bias [N]; norm_scale and norm_bias [K]; residual [M, N] in
    ``out_dtype`` (default x.dtype).
    Returns [M, N].

    With ``argmax_n`` (no activation, no residual) returns the greedy token
    int32 [M]: the lowest column index among the maxima of the first
    ``argmax_n`` columns.

    CUDA tensors launch ``csrc/quant_gemv.cu``; CPU tensors run
    ``quant_gemv_int8_ref``."""
    m, k = x.shape
    n = w_t.shape[0]
    if m > MAX_ROWS:
        raise ValueError(f"quant_gemv_int8 takes at most {MAX_ROWS} rows, got {m}")
    if argmax_n is not None and (activation is not None or residual is not None):
        raise ValueError("argmax_n excludes the activation and residual epilogues")
    out_dtype = out_dtype or x.dtype
    if residual is not None and tuple(residual.shape) != (m, n):
        raise ValueError(f"residual shape {tuple(residual.shape)} != {(m, n)}")
    if not use_kernel(x, w_t, scales, bias, norm_scale, norm_bias, residual):
        return quant_gemv_int8_ref(
            x, w_t, scales, bias, activation=activation, norm=norm,
            norm_scale=norm_scale, norm_bias=norm_bias, norm_eps=norm_eps,
            residual=residual, out_dtype=out_dtype, argmax_n=argmax_n,
        )
    _check_act(x, "quant_gemv_int8")
    _check_weight(w_t, k, "quant_gemv_int8")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quant_gemv_int8: out_dtype must be float32 or bfloat16, got {out_dtype}")
    scales = _vec_f32(scales, n, "scales")
    bias = _vec_f32(bias, n, "bias")
    ns = _vec_f32(norm_scale, k, "norm_scale") if norm is not None else None
    nb = _vec_f32(norm_bias, k, "norm_bias") if norm is not None else None
    if norm not in _NORM_CODES or (norm is not None and ns is None):
        raise ValueError(f"norm {norm!r} needs norm_scale (layernorm or rmsnorm)")
    if residual is not None:
        if residual.dtype != out_dtype or not residual.is_contiguous():
            raise ValueError("residual must be contiguous and of out_dtype")
    lib = _build.library()
    dev = x.device
    if argmax_n is not None:
        cap = max_blocks(dev.index if dev.index is not None else torch.cuda.current_device())
        part_max = torch.empty((m, cap), dtype=torch.float32, device=dev)
        part_idx = torch.empty((m, cap), dtype=torch.int32, device=dev)
        result = torch.empty((m,), dtype=torch.int32, device=dev)
        out = None
    else:
        part_max = part_idx = None
        out = result = torch.empty((m, n), dtype=out_dtype, device=dev)
    rc = lib.rt_quant_gemv(
        x.data_ptr(), int(x.dtype == torch.bfloat16), m,
        w_t.data_ptr(), scales.data_ptr(), n, k,
        _ptr(bias), _ptr(ns), _ptr(nb), _NORM_CODES[norm], float(norm_eps),
        activation_code(activation), _ptr(residual), _ptr(out), int(out_dtype == torch.bfloat16),
        int(argmax_n or 0), _ptr(part_max), _ptr(part_idx),
        result.data_ptr() if argmax_n is not None else None,
        _stream(x),
    )
    _build.check(rc, "quant_gemv_int8")
    LAUNCHES["quant_gemv_int8"] += 1
    return result


def quant_mlp_int8(
    x, w_up_t, up_scales, w_down_t, down_scales, b_up=None, b_down=None, *,
    activation="gelu", norm=None, norm_scale=None, norm_bias=None, norm_eps=1e-5,
    residual=None, next_qkv=None,
):
    """Whole transformer-MLP decode step for M ≤ 8 rows:

        out = norm(x) @ W_up (+b) → activation → @ W_down (+b) + residual

    x: [M, D]; w_up_t int8 [FF, D]; w_down_t int8 [D, FF] (``int8_pack``).
    With ``next_qkv = (w_qkv_t [Nq, D], scales, bias|None, next_norm_scale,
    next_norm_bias|None)`` it also returns the next layer's pre-norm + qkv
    projection of the f32 block output: ``(out, qkv [M, Nq])``. Outputs are
    in x.dtype.

    CUDA tensors launch ``csrc/quant_mlp.cu`` (three GEMV phases in one call:
    up into an f32 [M, FF] scratch, down, next qkv); CPU tensors run
    ``quant_mlp_int8_ref``."""
    m, d = x.shape
    ff = w_up_t.shape[0]
    if m > MAX_ROWS:
        raise ValueError(f"quant_mlp_int8 takes at most {MAX_ROWS} rows, got {m}")
    if tuple(w_up_t.shape) != (ff, d) or tuple(w_down_t.shape) != (d, ff):
        raise ValueError(
            f"MLP weights {tuple(w_up_t.shape)}, {tuple(w_down_t.shape)} do not fit d={d}"
        )
    if next_qkv is not None and norm is None:
        raise ValueError("next_qkv requires the fused norm")
    extra = list(next_qkv) if next_qkv is not None else []
    if not use_kernel(x, w_up_t, up_scales, w_down_t, down_scales, b_up, b_down,
                      norm_scale, norm_bias, residual, *extra):
        return quant_mlp_int8_ref(
            x, w_up_t, up_scales, w_down_t, down_scales, b_up, b_down,
            activation=activation, norm=norm, norm_scale=norm_scale,
            norm_bias=norm_bias, norm_eps=norm_eps, residual=residual,
            next_qkv=next_qkv,
        )
    _check_act(x, "quant_mlp_int8")
    _check_weight(w_up_t, d, "quant_mlp_int8 w_up")
    _check_weight(w_down_t, ff, "quant_mlp_int8 w_down")
    if norm not in _NORM_CODES:
        raise ValueError(f"unknown norm {norm!r}")
    if residual is not None and (
        residual.dtype != x.dtype or tuple(residual.shape) != (m, d) or not residual.is_contiguous()
    ):
        raise ValueError("residual must be a contiguous [M, D] tensor of x.dtype")
    dev = x.device
    up_buf = torch.empty((m, ff), dtype=torch.float32, device=dev)
    out = torch.empty((m, d), dtype=x.dtype, device=dev)
    h_buf = qkv = wq = sq = bq = qns = qnb = None
    nq = 0
    if next_qkv is not None:
        wq, sq, bq, qns, qnb = next_qkv
        nq = wq.shape[0]
        _check_weight(wq, d, "quant_mlp_int8 next qkv")
        if wq.shape[1] != d:
            raise ValueError(f"next qkv weight {tuple(wq.shape)} does not fit d={d}")
        sq, bq = _vec_f32(sq, nq, "next qkv scales"), _vec_f32(bq, nq, "next qkv bias")
        qns, qnb = _vec_f32(qns, d, "next norm scale"), _vec_f32(qnb, d, "next norm bias")
        h_buf = torch.empty((m, d), dtype=torch.float32, device=dev)
        qkv = torch.empty((m, nq), dtype=x.dtype, device=dev)
    # Every converted vector stays bound to a name until the launch is
    # enqueued, so the allocator cannot hand its memory to the next one.
    ns = _vec_f32(norm_scale, d, "norm_scale") if norm is not None else None
    nb = _vec_f32(norm_bias, d, "norm_bias") if norm is not None else None
    su, bu = _vec_f32(up_scales, ff, "up scales"), _vec_f32(b_up, ff, "b_up")
    sd, bd = _vec_f32(down_scales, d, "down scales"), _vec_f32(b_down, d, "b_down")
    rc = _build.library().rt_quant_mlp(
        x.data_ptr(), int(x.dtype == torch.bfloat16), m, d,
        w_up_t.data_ptr(), su.data_ptr(), _ptr(bu), ff,
        w_down_t.data_ptr(), sd.data_ptr(), _ptr(bd),
        _ptr(ns), _ptr(nb), _NORM_CODES[norm], float(norm_eps), activation_code(activation),
        _ptr(residual), out.data_ptr(), up_buf.data_ptr(), _ptr(h_buf),
        _ptr(wq), _ptr(sq), _ptr(bq), nq, _ptr(qns), _ptr(qnb), _ptr(qkv),
        _stream(x),
    )
    _build.check(rc, "quant_mlp_int8")
    LAUNCHES["quant_mlp_int8"] += 1
    return out if next_qkv is None else (out, qkv)
