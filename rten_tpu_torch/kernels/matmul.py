"""``matmul_fused``: a dense matmul with the bias and the activation fused
into its epilogue, beside its plain PyTorch version.

Counterpart of ``rten_tpu/kernels/matmul_pallas.py`` ``matmul_fused``
(:102; Pallas kernel ``_matmul_kernel`` :58): ``activation(x @ w + bias)``
with x [M, K] and w [K, N] dense, f32 accumulation, the bias added in f32
and the activation applied once after the whole K sum, then one rounding to
the output dtype. The TPU function pads every operand to its blocks; the
port takes any M, N and K and masks the edges in the kernel.

The kernel (``csrc/matmul_fused.cu``) has three routes, which the wrapper
picks by dtype and shape (``fused_route``), never on an error:

- ``wgmma``: bf16 operands whose rows are 16-byte multiples (K % 8 == 0,
  N % 8 == 0) on 16-byte aligned bases — ``wgmma`` from a TMA-fed ring,
  128 × 128 or 128 × 256 tiles, split-K across a cluster by ``fused_plan``;
- ``ragged``: other bf16 operands (rows TMA cannot address) — ``mma.sync``
  on 64 × 128 tiles, edges masked; also counts under
  ``matmul_fused:ragged``;
- ``f32``: exact f32 FMA on the CUDA cores (not TF32) on a ``cp.async``
  ring, 128 × 128 tiles, split-K as ``wgmma``.

A split-K launch also counts under ``matmul_fused:split_k``.
"""

from __future__ import annotations

import functools

import torch

from rten_tpu_torch.kernels import _build
from rten_tpu_torch.kernels.activations import ACTIVATIONS, activation_code
from rten_tpu_torch.kernels.dispatch import LAUNCHES, PLAIN, use_kernel
from rten_tpu_torch.kernels.quant_matmul import MAX_SPLIT, _device_index, _ptr, _stream, _vec_f32, sm_count, split_for

ROUTES = {"wgmma": 0, "ragged": 1, "f32": 2}  # the route codes of rt_matmul_fused
FUSED_BM = 128  # output rows a block (the wgmma and f32 routes)
FUSED_BK = {"wgmma": 64, "f32": 16}  # K of a ring stage


def fused_route(dtype: torch.dtype, k: int, n: int, aligned: bool = True) -> str:
    """The kernel route of operands of ``dtype`` with row widths ``k`` (x)
    and ``n`` (w); ``aligned``: both bases are 16-byte aligned."""
    if dtype == torch.float32:
        return "f32"
    return "wgmma" if k % 8 == 0 and n % 8 == 0 and aligned else "ragged"


def fused_columns(route: str, m: int, n: int, sms: int) -> int:
    """Output columns a block takes: 256 on the wgmma route where such
    blocks still fill at least 7/8 of the ``sms`` SMs in one wave (2048^3,
    4096^3), else 128 (measured on the H100: the wide block is 18-21%
    faster there and slower wherever its tiles are fewer)."""
    if route == "wgmma" and 8 * (-(-m // FUSED_BM) * -(-n // 256)) >= 7 * sms:
        return 256
    return 128


@functools.lru_cache(maxsize=1024)
def fused_plan(route: str, m: int, n: int, k: int, sms: int,
               fits: tuple[int, ...] | None = None) -> tuple[int, int]:
    """``(bn, split)`` of one ``matmul_fused`` launch on a card with ``sms``
    SMs: output columns a block (``fused_columns``) and the split-K
    cluster size, ``split_for`` over the 128 × bn output tiles and the
    route's K steps (``fits``: the device's cluster capacity for that
    block, ``fused_capacity``). The ragged route never splits."""
    bn = fused_columns(route, m, n, sms)
    if route == "ragged":
        return bn, 1
    tiles = -(-m // FUSED_BM) * -(-n // bn)
    return bn, split_for(tiles, -(-k // FUSED_BK[route]), sms, fits)


@functools.lru_cache(maxsize=8)
def fused_capacity(device_index: int, route: str, bn: int) -> tuple[int, ...]:
    """``fits`` of ``split_for`` for the route's block of ``bn`` columns on
    this device: clusters of 1..MAX_SPLIT blocks it holds at once, queried
    once."""
    lib = _build.library()
    with torch.cuda.device(device_index):
        fits = tuple(int(lib.rt_matmul_fused_clusters(ROUTES[route], bn, c)) for c in range(1, MAX_SPLIT + 1))
    for c, n in enumerate(fits, 1):
        if n < 0:
            _build.check(-n, f"matmul_fused cluster capacity ({route}, {bn} columns, cluster {c})")
    return fits


def device_fused_plan(x, w) -> tuple[str, int, int]:
    """``(route, bn, split)`` of ``matmul_fused(x, w)`` on x's card."""
    m, k = x.shape
    n = w.shape[1]
    route = fused_route(x.dtype, k, n, x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    idx = _device_index(x)
    sms = sm_count(idx)
    bn = fused_columns(route, m, n, sms)
    if route == "ragged":
        return route, bn, 1
    return (route, *fused_plan(route, m, n, k, sms, fused_capacity(idx, route, bn)))


def matmul_fused_ref(x, w, bias=None, *, activation=None, out_dtype=None):
    """Plain version of ``matmul_fused`` (same signature and result): the
    product of the operands in f32, ``+ bias``, the activation, then
    ``out_dtype``."""
    PLAIN["matmul_fused"] += 1
    out = x.float() @ w.float()
    if bias is not None:
        out = out + bias.float()
    return ACTIVATIONS[activation](out).to(out_dtype or x.dtype)


def matmul_fused(x, w, bias=None, *, activation=None, out_dtype=None):
    """``activation(x @ w + bias)``.

    x: [M, K] and w: [K, N], both f32 or both bf16; bias [N]; any M, N, K.
    Returns [M, N] in ``out_dtype`` (default x.dtype). Sums are f32; the
    order is ``acc → + bias → activation → out_dtype``; the activations are
    those of ``kernels.activations`` (none, relu, gelu, silu, sigmoid,
    tanh).

    CUDA tensors launch ``csrc/matmul_fused.cu`` on the route and split of
    ``device_fused_plan`` (module docstring); CPU tensors run
    ``matmul_fused_ref``."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul_fused expects x [M, K] and w [K, N], got {tuple(x.shape)} and {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    if not use_kernel(x, w, bias):
        return matmul_fused_ref(x, w, bias, activation=activation, out_dtype=out_dtype)
    out_dtype = out_dtype or x.dtype
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"matmul_fused: x and w must both be float32 or both bfloat16, got {x.dtype}, {w.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"matmul_fused: out_dtype must be float32 or bfloat16, got {out_dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("matmul_fused: x and w must be contiguous")
    if m == 0 or n == 0 or k == 0:
        raise ValueError(f"matmul_fused: empty operands {tuple(x.shape)} @ {tuple(w.shape)}")
    b = _vec_f32(bias, n, "matmul_fused bias")
    route, bn, split = device_fused_plan(x, w)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    rc = _build.library().rt_matmul_fused(
        x.data_ptr(), w.data_ptr(), _ptr(b), ROUTES[route], m, n, k,
        activation_code(activation), out.data_ptr(), int(out_dtype == torch.bfloat16), bn, split, _stream(x),
    )
    _build.check(rc, "matmul_fused")
    LAUNCHES["matmul_fused"] += 1
    if route == "ragged":
        LAUNCHES["matmul_fused:ragged"] += 1
    if split > 1:
        LAUNCHES["matmul_fused:split_k"] += 1
    return out
