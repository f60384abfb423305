"""Flash attention for prefill: tiled online-softmax attention of a block of
queries against keys and values, causal or not, with grouped-query heads,
a per-row query offset and a per-row valid KV length. Kernel wrapper beside
its plain version.

Counterpart of ``rten_tpu/kernels/attention.py`` ``flash_attention`` (:117;
Pallas kernel ``_flash_kernel`` :29), whose function the kernel keeps:
scores and softmax statistics in f32; the mask value ``-0.7 · f32 max``
(``MASK_VALUE``), not −inf; columns at or past ``kv_len`` and (causal)
right of the query's absolute position ``q_offset + row`` masked; P rounded
to v's dtype before P·V (so in f32 not at all), the softmax sum taken from
the unrounded P; and 0 for a row with no valid column (``kv_len`` 0). The
plain version is the counterpart of ``attention_reference`` (:222) with
those last two rules of the kernel, so both give the Pallas kernel's
result.

Also the launch plan of the split-KV decode attention engine
(``csrc/kv_attention.cuh``, the four KV kernels' one clustered launch):
``kv_plan``.
"""

from __future__ import annotations

import functools
import math

import torch

from rten_tpu_torch.kernels import _build
from rten_tpu_torch.kernels.dispatch import LAUNCHES, PLAIN, use_kernel
from rten_tpu_torch.kernels.quant_matmul import MAX_SPLIT, _sms, _stream, split_for

MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)
# Head dims the kernel has instances at (csrc/flash_attention.cu), bf16's;
# f32 has no 256 one (its tiles would not fit a block's shared memory), so
# its widest is FLASH_F32_WIDEST. A head dim between them runs the next one
# up with its columns past d zero, and a head dim above the widest runs it
# in slices of that many output columns.
FLASH_HEAD_DIMS = (16, 32, 64, 128, 256)
FLASH_F32_WIDEST = 128
# Launch plan of the kernel (flash_mma_kernel, both types): a block owns
# FB_ROWS (query, head of the GQA group) rows, query major, and walks KV
# tiles of FB_KV positions; a cluster of ``split`` blocks divides the tiles.
FB_ROWS, FB_KV = 64, 64


def flash_slices(d: int, bf16: bool = True) -> int:
    """Output slices of the widest instance's columns (256 in bf16,
    ``FLASH_F32_WIDEST`` in f32) a row tile of a head dim ``d`` launch
    takes: one block each, every block computing the scores over the whole
    d (1 up to the widest instance)."""
    return max(1, -(-d // (FLASH_HEAD_DIMS[-1] if bf16 else FLASH_F32_WIDEST)))


@functools.lru_cache(maxsize=1024)
def flash_plan(b: int, hq: int, hk: int, tq: int, s: int, sms: int, slices: int = 1) -> tuple[int, int]:
    """``(row_tiles, split)`` of one ``flash_attention`` launch (bf16 or
    f32) on a card with ``sms`` SMs: the 64-row tiles of a kv head's Tq ·
    (Hq / Hk) rows, and the split-KV cluster size (``split_for`` over the
    row tiles of every kv head, batch row and output slice
    (``flash_slices``), at most the tiles of ``s`` positions). The kernel
    divides the tiles the rows actually need (kv_len, q_offset: on the
    device) among the ranks, rank r of ``split`` taking ``[r n / split,
    (r + 1) n / split)`` of n tiles. ``split_for`` splits only where the
    blocks fill under half the SMs, and then to at most one block an SM:
    the capacity of the f32 instance at 128 columns, whose shared memory
    (222,208 bytes) admits one block an SM, the others two or more."""
    row_tiles = -(-tq * (hq // hk) // FB_ROWS)
    return row_tiles, split_for(row_tiles * hk * b * slices, -(-s // FB_KV), sms)


# The decode attention engine (csrc/kv_attention.cuh): a cluster of C
# blocks a (kv head, head tile, row), rank r walking the row's KV_CHUNK-
# position chunks r, r + C, ...; a head tile is up to KV_GROUP_TILE query
# heads of one kv head's group (MHA: one).
KV_CHUNK, KV_GROUP_TILE = 64, 8


def kv_tiles(group: int) -> int:
    """Head tiles of a GQA group of ``group`` query heads a kv head (one
    cluster each; 1 for MHA)."""
    return -(-group // KV_GROUP_TILE)


@functools.lru_cache(maxsize=1024)
def kv_plan(b: int, hk: int, group: int, cap: int, sms: int, fits: tuple[int, ...] | None = None) -> int:
    """Cluster size C of one launch of the KV attention engine over ``b``
    rows of ``hk`` kv heads of ``group`` query heads each, rows of ``cap``
    positions, on a card with ``sms`` SMs: the largest C (at most
    ``MAX_SPLIT``, at most the chunks of ``cap``: no rank idle on a full
    row) at which all ``b · hk · kv_tiles(group)`` clusters run at once,
    ``fits[C - 1]`` being the clusters of C blocks the device holds at once
    (``cudaOccupancyMaxActiveClusters``), or ``sms // C`` without ``fits``
    (one block an SM). C only spreads the work: a row's sums are ordered by
    its V = min(8, chunks of ``cap``) virtual ranks whatever C is, so a row
    gets the same bits in any batch and from any of the four kernels. The
    kernel reads kv_len on the device, so the plan sizes for ``cap``."""
    clusters = b * hk * kv_tiles(group)
    for split in range(min(MAX_SPLIT, -(-cap // KV_CHUNK)), 1, -1):
        if clusters <= (fits[split - 1] if fits is not None else sms // split):
            return split
    return 1


def _shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"expected q [B, Hq, Tq, D] and k, v [B, Hk, S, D]; got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, hq, tq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or hq % k.shape[1]:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q {tuple(q.shape)} (Hq a multiple of Hk)")
    return b, hq, tq, d, k.shape[1], k.shape[2]


def _per_row(t, b: int, what: str):
    if t is not None and tuple(t.shape) != (b,):
        raise ValueError(f"{what} must be an int32 [B] tensor, got shape {tuple(t.shape)}")
    return t


def flash_attention_ref(q, k, v, *, causal=True, sm_scale=None, q_offset=None, kv_len=None, plan_len=None):
    """Plain version of ``flash_attention`` (same signature and result,
    returned contiguous; ``plan_len`` sizes no plan here)."""
    PLAIN["flash_attention"] += 1
    b, hq, tq, d, hk, s = _shapes(q, k, v)
    _per_row(q_offset, b, "q_offset")
    _per_row(kv_len, b, "kv_len")
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    qf = q.float().reshape(b, hk, hq // hk, tq, d)  # q head h reads k/v head h // group
    scores = torch.einsum("bkgqd,bksd->bkgqs", qf, k.float()) * scale
    col = torch.arange(s, device=q.device)
    lens = torch.full((b,), s, device=q.device) if kv_len is None else kv_len.long()
    mask = (col[None, :] < lens[:, None])[:, None, None, None, :]  # [B, 1, 1, 1, S]
    if causal:
        off = torch.zeros(b, device=q.device, dtype=torch.long) if q_offset is None else q_offset.long()
        row = torch.arange(tq, device=q.device)[None, :] + off[:, None]  # [B, Tq]
        mask = mask & (col[None, None, :] <= row[:, :, None])[:, None, None]
    scores = torch.where(mask, scores, MASK_VALUE)
    p = torch.where(mask, torch.exp(scores - scores.amax(-1, keepdim=True)), 0.0)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bkgqs,bksd->bkgqd", p.to(v.dtype).float(), v.float())
    out = out / torch.where(l == 0, 1.0, l)
    return out.reshape(b, hq, tq, d).to(q.dtype)


def _strides(t, what: str):
    """(batch, head, position) element strides of a [B, H, T, D] operand
    with D contiguous (the kernel reads its rows in the largest pieces
    their alignment allows)."""
    if t.stride(3) != 1 and t.shape[3] > 1:
        raise ValueError(f"flash_attention {what}: D must be contiguous")
    return t.stride(0), t.stride(1), t.stride(2)


def flash_attention(q, k, v, *, causal=True, sm_scale=None, q_offset=None, kv_len=None, plan_len=None):
    """``softmax(q·kᵀ · sm_scale + mask) · v``, tiled.

    q: [B, Hq, Tq, D]; k, v: [B, Hk, S, D] with Hq a multiple of Hk (q head
    h reads k/v head h // (Hq / Hk)); any strides with D contiguous, so q
    may be a view of a packed qkv. ``sm_scale`` defaults to 1/sqrt(D).
    ``q_offset``: int32 [B], the absolute position of each row's first
    query (causal only; default 0). ``kv_len``: int32 [B], each row's valid
    KV prefix (default S; the kernel clamps it to [0, S]). Both stay on the
    device. Returns [B, Hq, Tq, D] in q's dtype; the kernel's result is a
    view of a [B, Tq, Hq, D] buffer, so ``transpose(1, 2)`` of it is
    contiguous. The split-KV plan reads S, or ``plan_len`` where given: a
    caller that passes a prefix ``k[:, :, :n]`` of a longer buffer (no
    row's prefix reaching past n) gives the buffer's length there, so the
    call splits, and sums, as it would over the whole buffer.

    CUDA tensors launch ``csrc/flash_attention.cu`` (f32 or bf16, any head
    dim: instances at ``FLASH_HEAD_DIMS``, a head dim between them on the
    next one up, a head dim above the widest (256 bf16, 128 f32) on that
    one in ``flash_slices`` output slices; on the tensor cores, f32 as six
    bf16 products of split operands, as exact as f32 FMA; split over the
    KV axis across a cluster by ``flash_plan``, such a launch also counted
    under ``flash_attention:split_kv``, and a head dim other than 64 and
    128 also under ``flash_attention:d<D>``); CPU tensors run
    ``flash_attention_ref``."""
    b, hq, tq, d, hk, s = _shapes(q, k, v)
    _per_row(q_offset, b, "q_offset")
    _per_row(kv_len, b, "kv_len")
    if not use_kernel(q, k, v, q_offset, kv_len):
        return flash_attention_ref(q, k, v, causal=causal, sm_scale=sm_scale, q_offset=q_offset,
                                   kv_len=kv_len)
    dtype = q.dtype
    if dtype not in (torch.float32, torch.bfloat16) or k.dtype != dtype or v.dtype != dtype:
        raise TypeError(f"flash_attention: q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q_offset", q_offset), ("kv_len", kv_len)):
        if t is not None and (t.dtype != torch.int32 or not t.is_contiguous()):
            raise ValueError(f"flash_attention: {name} must be a contiguous int32 [B] tensor")
    out = torch.empty((b, tq, hq, d), dtype=dtype, device=q.device).transpose(1, 2)
    scale = 1.0 / math.sqrt(d) if sm_scale is None else sm_scale
    split = flash_plan(b, hq, hk, tq, plan_len or s, _sms(q), flash_slices(d, dtype == torch.bfloat16))[1]
    rc = _build.library().rt_flash_attention(
        q.data_ptr(), *_strides(q, "q"), k.data_ptr(), *_strides(k, "k"),
        v.data_ptr(), *_strides(v, "v"), out.data_ptr(), *_strides(out, "out"),
        None if q_offset is None else q_offset.data_ptr(),
        None if kv_len is None else kv_len.data_ptr(),
        int(dtype == torch.bfloat16), b, hq, hk, tq, s, d, int(causal), float(scale), split,
        _stream(q),
    )
    _build.check(rc, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    if split > 1:
        LAUNCHES["flash_attention:split_kv"] += 1
    if d not in (64, 128):
        LAUNCHES[f"flash_attention:d{d}"] += 1
    return out
