"""Paged decode attention: one query token per row against KV pages of a
shared pool, found through a ``[B, max_pages]`` page table, with the new
token's k/v appended in place into the page that holds ``kv_len``; in bf16
or f32 pages, or in int8 pages with per-(token, head) f32 scale pages.
Kernel wrappers beside their plain versions.

Counterpart of ``rten_tpu/kernels/paged_attention.py``
``paged_decode_attention`` (:592) and ``paged_decode_attention_int8``
(:413), MHA and grouped-query (the operands as ``decode_attention.split_qkv``
takes them; a ``:gqa`` launch counter where Hq > Hk). Their folded pages
``[Hk, P, page·D/128, 128]`` and scale tiles ``[Hk, P, 8, 128]`` exist for
Mosaic's 128-lane rule; here a pool is logical ``[P, Hk, page, D]`` (scales
``[P, Hk, page]``), one extra page of it being the serving engine's scratch
page. Page table entries past a row's last page may hold anything: what
they name is never used.

Numerics (those of the Pallas kernels): scores, softmax statistics and the
attention vector in f32, scale ``1/sqrt(D)``, the output rounded to the
activations' dtype; int8 pages are dequantized in f32 (score ``q·k_int8 ·
scale``, value sum ``(p · scale)·v_int8``) and the new token is quantized
per head as ``decode_attention.quantize_kv`` does.
"""

from __future__ import annotations

import math

import torch

from rten_tpu_torch.kernels.decode_attention import (
    _LANES,
    CHUNK,
    attend_ref,
    check_kv_operands,
    dequantize_kv,
    launch_kv_attention,
    mode_name,
    quantize_kv,
    split_qkv,
)
from rten_tpu_torch.kernels.dispatch import PLAIN, use_kernel


def paged_attention_supported(head_dim: int, page_size: int) -> bool:
    """Pages the JAX package's paged kernel takes, and so the port's: a
    copy of ``rten_tpu/kernels/paged_attention.py:205``
    ``paged_attention_supported`` (a head dim that divides 128, pages of a
    multiple of 1024 / head dim positions: 8 at head dim 128, 16 at 64).
    The kernel finds each position's page, so a 64-position chunk of it may
    span pages (csrc/kv_attention.cuh)."""
    return head_dim <= _LANES and _LANES % head_dim == 0 and (page_size * head_dim) % (8 * _LANES) == 0


def paged_attention_int8_supported(head_dim: int, page_size: int) -> bool:
    """The int8 twin's rule: a copy of
    ``rten_tpu/kernels/paged_attention.py:213``
    ``paged_attention_int8_supported`` (its int8 windows and scale-page
    layout: pages of a multiple of 4096 / head dim positions, at most
    16384 / head dim, head dim at least 16)."""
    return (
        paged_attention_supported(head_dim, page_size)
        and (page_size * head_dim) % (32 * _LANES) == 0
        and page_size * head_dim // _LANES <= _LANES
        and _LANES // head_dim <= 8
    )


def _paged_ref(name, qkv, k_pages, v_pages, scales, page_table, kv_len):
    q, kn, vn = split_qkv(qkv)
    PLAIN[mode_name(name, q.shape[1], kn.shape[1])] += 1
    hk, page, d = k_pages.shape[1], k_pages.shape[2], q.shape[2]
    if scales is not None:
        (kn, kns), (vn, vns) = quantize_kv(kn), quantize_kv(vn)
    rows = []
    for bi, length in enumerate(kv_len.tolist()):
        if not 0 <= length < page_table.shape[1] * page:
            raise IndexError(f"{name}: row {bi} at {length} is past its {page_table.shape[1]} pages")
        pages = page_table[bi, : length // page + 1].tolist()  # the pages of positions 0..length
        at = (pages[-1], slice(None), length % page)
        k_pages[at], v_pages[at] = kn[bi], vn[bi]
        keys, vals = k_pages[pages], v_pages[pages]  # [n, Hk, page, D]
        if scales is not None:
            scales[0][at], scales[1][at] = kns[bi], vns[bi]
            keys = dequantize_kv(keys, scales[0][pages], torch.float32)
            vals = dequantize_kv(vals, scales[1][pages], torch.float32)

        def flat(t):
            return t.permute(1, 0, 2, 3).reshape(hk, -1, d)[:, : length + 1]

        rows.append(attend_ref(q[bi], flat(keys), flat(vals), 1.0 / math.sqrt(d)))
    return torch.stack(rows).to(q.dtype)


def _page_modes(name: str, page: int) -> tuple[str, ...]:
    """A launch over pages that are not whole 64-position chunks also counts
    under ``name:page<P>``."""
    return (f"{name}:page{page}",) if page % CHUNK else ()


def paged_decode_attention_ref(qkv, k_pages, v_pages, page_table, kv_len):
    """Plain version of ``paged_decode_attention`` (same signature, result
    and in-place page update). Reads the table and lengths on the host."""
    return _paged_ref("paged_decode_attention", qkv, k_pages, v_pages, None, page_table, kv_len)


def paged_decode_attention_int8_ref(qkv, k_pages, v_pages, k_scale_pages, v_scale_pages, page_table, kv_len):
    """Plain version of ``paged_decode_attention_int8``."""
    return _paged_ref("paged_decode_attention_int8", qkv, k_pages, v_pages,
                      (k_scale_pages, v_scale_pages), page_table, kv_len)


def _check_table(name, q, k_pages, page_table, kv_len, int8: bool = False):
    b = q.shape[0]
    if page_table.dim() != 2 or page_table.shape[0] != b or tuple(kv_len.shape) != (b,):
        raise ValueError(f"{name}: page_table must be [B, max_pages] and kv_len [B] for B={b}")
    rule, line = (paged_attention_int8_supported, 213) if int8 else (paged_attention_supported, 205)
    if not rule(q.shape[-1], k_pages.shape[2]):
        raise ValueError(f"{name}: pages of {k_pages.shape[2]} positions at head dim {q.shape[-1]} fail "
                         f"rten_tpu/kernels/paged_attention.py:{line} {rule.__name__}")
    if page_table.dtype != torch.int32 or not page_table.is_contiguous():
        raise ValueError(f"{name}: page_table must be a contiguous int32 tensor")


def paged_decode_attention(qkv, k_pages, v_pages, page_table, kv_len):
    """Decode attention over a paged KV pool:

        attn = softmax(q·kᵀ/sqrt(D))·v  over the row's valid prefix and the new token

    qkv: the packed MHA ``[B, 3, H, 1, D]`` or the tuple ``(q [B, Hq, D],
    k_new [B, Hk, D], v_new [B, Hk, D])`` (``split_qkv``), f32 or bf16;
    k_pages, v_pages: [P, Hk, page, D] of the operands' dtype; page_table:
    int32 [B, max_pages], physical page of each row's logical page;
    kv_len: int32 [B], each row's length before this token, whose page
    (``page_table[b, kv_len // page]``) must be allocated. Writes k_new and
    v_new there in place, once per kv head, and returns the attention vector
    [B, Hq·D] in the operands' dtype. A row at or past ``max_pages · page``
    raises IndexError in the plain version; the kernel writes nothing and
    returns NaN for it, and NaN for a row whose table names a page outside
    the pool.

    CUDA tensors launch ``csrc/paged_attention.cu``; CPU tensors run
    ``paged_decode_attention_ref``."""
    name = "paged_decode_attention"
    ops = check_kv_operands(name, qkv, (k_pages, v_pages), None, 1)
    _check_table(name, ops[0], k_pages, page_table, kv_len)
    if not use_kernel(*ops, k_pages, v_pages, page_table, kv_len):
        return paged_decode_attention_ref(ops, k_pages, v_pages, page_table, kv_len)
    n_pages, _, page, _ = k_pages.shape
    max_pages = page_table.shape[1]
    return launch_kv_attention(name, "rt_paged_attention", ops, (k_pages, v_pages), kv_len,
                               max_pages * page, (n_pages, page, page_table.data_ptr(), max_pages),
                               _page_modes(name, page))


def paged_decode_attention_int8(qkv, k_pages, v_pages, k_scale_pages, v_scale_pages, page_table, kv_len):
    """``paged_decode_attention`` over int8 pages [P, Hk, page, D] with f32
    scale pages [P, Hk, page]: the new token is quantized per kv head
    (``quantize_kv``) and written with its scales into its page; its score
    and value use the dequantized codes.

    CUDA tensors launch ``csrc/paged_attention_int8.cu``; CPU tensors run
    ``paged_decode_attention_int8_ref``."""
    name = "paged_decode_attention_int8"
    ops = check_kv_operands(name, qkv, (k_pages, v_pages), (k_scale_pages, v_scale_pages), 1)
    _check_table(name, ops[0], k_pages, page_table, kv_len, int8=True)
    if not use_kernel(*ops, k_pages, v_pages, k_scale_pages, v_scale_pages, page_table, kv_len):
        return paged_decode_attention_int8_ref(ops, k_pages, v_pages, k_scale_pages, v_scale_pages,
                                               page_table, kv_len)
    n_pages, _, page, _ = k_pages.shape
    max_pages = page_table.shape[1]
    return launch_kv_attention(name, "rt_paged_attention_int8", ops,
                               (k_pages, v_pages, k_scale_pages, v_scale_pages), kv_len,
                               max_pages * page, (n_pages, page, page_table.data_ptr(), max_pages),
                               _page_modes(name, page))
