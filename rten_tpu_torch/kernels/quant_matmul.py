"""INT8 matmul kernels: the decode ``quant_gemv_int8`` and
``quant_mlp_int8``, the prefill ``quant_matmul_int8`` and
``quant_matmul_w8a8`` (with its row quantizer ``quantize_rows_int8``), each
beside its plain PyTorch version.

Counterpart of ``rten_tpu/kernels/quant_matmul.py`` (``quant_gemv_int8``
:339, ``quant_matmul_int8`` :590, ``quant_matmul_w8a8`` :760,
``quant_mlp_int8`` :935). Weights are int8 with per-output-channel f32
scales; activations are f32 or bf16. Weight-only (the default), every sum
is kept in f32. ``w8a8=True`` on the GEMV and the MLP (the JAX package's
``w_convert="w8a8"``) and ``quant_matmul_w8a8`` quantize the activations
per row to int8 first (the JAX package's ``_act_quantize``, :124: the
prefill matmul inside its one launch, the GEMV and MLP inside theirs;
``quantize_rows_int8`` on its own, a yardstick on no model path) and take
s8 × s8 sums exactly in int32, rescaled as ``(acc · sx) · scale`` in f32.

Weight layout: the port stores every int8 matrix transposed, ``[N, K]`` with
K contiguous (``int8_pack``), so that a warp reads each output column's
weights as 16 contiguous bytes a thread. The JAX package's row-major
``[K, N]`` and tiled ``[S, K, bn]`` packs convert once at load time.

Numerics of both the kernels and the plain versions (those of the Pallas
kernels): the optional pre-norm runs in f32 on the whole row; with bf16
activations the normalized row is rounded to bf16 before a weight-only dot
(never before the W8A8 quantization, which takes the f32 row); the
epilogue order is ``acc * scale → + bias → activation → + residual``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

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
    ``{"qt": int8 [N, K] (K contiguous), "s": f32 [N], "tiled": bool}``.

    ``tiled`` records whether the JAX package stores this matrix as tiled
    ``[S, K, bn]`` stripes (here: whether ``q`` is; ``quantize_params_int8``
    sets it by the JAX package's rules). The layout is the TPU's, but it
    decides numbers: the JAX package's prefill keeps tiled packs
    weight-only under W8A8 (``rten_tpu/models/decoder.py:526``), and the
    port's decoder follows it."""
    q = np.asarray(q)
    tiled = q.ndim == 3
    if tiled:
        q = untile_gemv_weights(q)
    if q.ndim != 2 or q.dtype != np.int8:
        raise ValueError(f"expected an int8 [K, N] or [S, K, bn] matrix, got {q.dtype} {q.shape}")
    s = np.asarray(s, np.float32).reshape(-1)
    if s.shape[0] != q.shape[1]:
        raise ValueError(f"{s.shape[0]} scales for {q.shape[1]} columns")
    return {
        "qt": torch.from_numpy(np.ascontiguousarray(q.T)).to(device),
        "s": torch.from_numpy(s.copy()).to(device),
        "tiled": tiled,
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


def _act_quantize(x):
    """Per-row symmetric int8 quantization of f32 rows [M, K]: codes
    ``clip(round_half_even(x / sx), ±127)`` with ``sx = absmax / 127`` (1
    for an all-zero row), returned as (int8 [M, K], f32 [M, 1]). Both
    divisions have a tensor divisor, so they are IEEE divisions on every
    device, as in the kernels (PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal)."""
    absmax = x.abs().amax(-1, keepdim=True)
    sx = torch.where(absmax == 0, torch.ones_like(absmax), absmax / torch.full_like(absmax, 127.0))
    return torch.clamp(torch.round(x / sx), -127, 127).to(torch.int8), sx


def _qdot_w8a8(xs, w_t, scales):
    """The W8A8 product of f32 rows: codes @ W summed exactly (f64 holds
    every int8 · int8 sum of any realistic K exactly; CUDA PyTorch has no
    int32 matmul), rounded once to f32 like the kernels' int32 → f32, then
    ``(acc · sx) · scale`` in f32."""
    q, sx = _act_quantize(xs)
    acc = (q.double() @ w_t.double().t()).float()
    return (acc * sx) * scales.float()


def quantize_rows_int8_ref(x):
    """Plain version of ``quantize_rows_int8``: (codes int8 [M, K], sx f32
    [M, 1]) of the rows of x [M, K], f32 or bf16."""
    PLAIN["quantize_rows_int8"] += 1
    return _act_quantize(x.float())


def quant_gemv_int8_ref(
    x, w_t, scales, bias=None, *, activation=None, norm=None, norm_scale=None,
    norm_bias=None, norm_eps=1e-5, residual=None, out_dtype=None, argmax_n=None, w8a8=False,
):
    """Plain version of ``quant_gemv_int8`` (same signature and result)."""
    PLAIN["quant_gemv_int8:w8a8" if w8a8 else "quant_gemv_int8"] += 1
    out_dtype = out_dtype or x.dtype
    xs = x.float()
    if norm is not None:
        xs = _norm_rows_f32(xs, norm, norm_eps, norm_scale, norm_bias)
    if w8a8:
        out = _qdot_w8a8(xs, w_t, scales)
    else:
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


def quant_matmul_int8_ref(x, w_t, scales, bias=None, *, activation=None, out_dtype=None):
    """Plain version of ``quant_matmul_int8`` (same signature and result;
    no hand-off to the GEMV: any M)."""
    PLAIN["quant_matmul_int8"] += 1
    out = _qdot(_dot_operand(x.float(), x.dtype == torch.bfloat16), w_t, scales)
    if bias is not None:
        out = out + bias.float()
    return ACTIVATIONS[activation](out).to(out_dtype or x.dtype)


def quant_matmul_w8a8_ref(x, w_t, scales, bias=None, *, activation=None, out_dtype=None):
    """Plain version of ``quant_matmul_w8a8`` (same signature and result;
    no hand-off to the GEMV: any M)."""
    PLAIN["quant_matmul_w8a8"] += 1
    out = _qdot_w8a8(x.float(), w_t, scales)
    if bias is not None:
        out = out + bias.float()
    return ACTIVATIONS[activation](out).to(out_dtype or x.dtype)


def quant_mlp_int8_ref(
    x, w_up_t, up_scales, w_down_t, down_scales, b_up=None, b_down=None, *,
    activation="gelu", norm=None, norm_scale=None, norm_bias=None, norm_eps=1e-5,
    residual=None, next_qkv=None, w8a8=False,
):
    """Plain version of ``quant_mlp_int8`` (same signature and result)."""
    PLAIN["quant_mlp_int8:w8a8" if w8a8 else "quant_mlp_int8"] += 1
    bf16 = x.dtype == torch.bfloat16

    def qdot(rows, w_t, scales):
        if w8a8:
            return _qdot_w8a8(rows, w_t, scales)
        return _qdot(_dot_operand(rows, bf16), w_t, scales)

    xs = x.float()
    if norm is not None:
        xs = _norm_rows_f32(xs, norm, norm_eps, norm_scale, norm_bias)
    up = qdot(xs, w_up_t, up_scales)
    if b_up is not None:
        up = up + b_up.float()
    up = ACTIVATIONS[activation](up)
    down = qdot(up, w_down_t, down_scales)
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
    qkv = qdot(xq, w_qkv_t, qkv_scales)
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


# Launch plan of the decode GEMV engine (csrc/gemv.cuh gemv_kernel): output
# columns in tiles of GEMV_TILE, a tile's K in chunks of GEMV_CHUNK bytes cut
# into ``pieces`` contiguous ranges (a unit: one tile's piece), the tiles of
# each phase spread evenly over the blocks (a GEMV of its own with pieces > 1:
# over clusters of ``pieces`` blocks, rank r summing piece r), each unit
# summed by a team of ``team`` of the block's GEMV_WARPS warps; the weights
# stream through a ring of ``slots`` shared-memory slots of one unit each.
GEMV_TILE = 16
GEMV_CHUNK = 64
GEMV_WARPS = 8
GEMV_TEAM_BYTES = 2 * GEMV_WARPS * 32 * 16
GEMV_PIECE_BYTES = 32 * 16       # a piece's sum in its owner's inbox
GEMV_SMEM = 232448 - 2048        # a block's shared memory less the kernel's static arrays
GEMV_SMEM_PAIR = 233472 // 2 - 1024 - 2048  # each of two blocks on one SM
# A phase's x and norm vectors are staged in shared memory up to this (a
# GEMV of its own; the MLP, whose weights are resident, 48 KB) where the
# plan still fits; past it they are read from global memory.
GEMV_STAGE_MAX = 96 << 10
GEMV_STAGE_MAX_MLP = 48 << 10
SPLIT_TILES = 64                 # fewer tiles: a tile's K is cut over several blocks
SPLIT_UNITS = 128                # ... into about this many units
SPLIT_MIN_CHUNKS = 12            # ... of at least this many chunks a piece (the wo's K 768 stays whole)
PIECE_CHUNKS = 48                # the longest piece (3 KB a row: a slot of 48 KB)
# The argmax's work buffer (int32 words; csrc/gemv.cuh GV_WORK_ARGMAX): its
# ticket, then a (value, index) partial per row and block.
GEMV_MAX_GRID = 1024
GEMV_WORK_WORDS = 32 + 2 * MAX_ROWS * GEMV_MAX_GRID


def _range_lo(i: int, total: int, parts: int) -> int:
    """Start of part i of ``total`` things cut into ``parts`` (the kernel's
    ``range_lo``)."""
    return i * total // parts


def gemv_split(n: int, k: int, mlp: bool = False) -> tuple[int, int]:
    """``(pieces, team)`` of an [N, K] matrix: the K pieces of a tile (none
    longer than PIECE_CHUNKS chunks; with fewer than SPLIT_TILES tiles, in a
    GEMV launch of its own, enough for about SPLIT_UNITS units, at most 8
    and none shorter than SPLIT_MIN_CHUNKS: a cluster's barrier costs more
    than a short piece saves) and the warps that sum one unit (8 for up to
    256 units, 4, 2, then 1 from 1025; in the MLP's launch, one block an
    SM, 8 up to 128 units, 4 up to 256, ...; never more than the shortest
    piece's chunks, a power of two).
    In the MLP's launch (``mlp``) a few-tile matrix is not split further:
    its weights are in flight from kernel entry on every SM anyway, and its
    cooperative launch has no cluster to combine pieces in. Pieces that no
    cluster sums (``gemv_clustered``: the MLP's, and those of a tile whose
    K alone outgrows a slot) stay in one block, summed in order by one team
    of all 8 warps. A function of (n, k) and the launch's kind alone, so
    that a column's sum order does not depend on the rows, the grid or the
    card."""
    tiles = -(-n // GEMV_TILE)
    chunks = -(-k // GEMV_CHUNK)
    pieces = -(-chunks // PIECE_CHUNKS)
    if tiles < SPLIT_TILES and not mlp:
        pieces = max(pieces, min(chunks // SPLIT_MIN_CHUNKS, 8, -(-SPLIT_UNITS // tiles)))
    units = tiles * pieces
    team = 8 if units <= 256 else 4 if units <= 512 else 2 if units <= 1024 else 1
    if mlp:  # about one block an SM: a block's units side by side, not one after another
        team = 8 if units <= 128 else 4 if units <= 256 else 2 if units <= 512 else 1
    while team > 1 and team > chunks // pieces:
        team //= 2
    if pieces > 1 and not gemv_clustered(n, k, mlp):
        team = GEMV_WARPS
    return pieces, team


def gemv_clustered(n: int, k: int, mlp: bool = False) -> bool:
    """Whether a tile's pieces are summed by a cluster of as many blocks:
    a few-tile matrix (under SPLIT_TILES tiles) split in 2-8 pieces, in a
    GEMV launch of its own (gemv_split's rule)."""
    chunks = -(-k // GEMV_CHUNK)
    pieces = max(-(-chunks // PIECE_CHUNKS), min(chunks // SPLIT_MIN_CHUNKS, 8, -(-SPLIT_UNITS // -(-n // GEMV_TILE))))
    return not mlp and -(-n // GEMV_TILE) < SPLIT_TILES and 1 < pieces <= 8


def gemv_row_bytes(k: int, pieces: int) -> int:
    """Shared-memory bytes of a unit's weight row: K for an unsplit tile
    (its rows arrive as one contiguous copy), else the longest piece."""
    return k if pieces == 1 else -(-(-(-k // GEMV_CHUNK)) // pieces) * GEMV_CHUNK


def gemv_x_row(k: int, dot: str) -> int:
    """Shared-memory bytes of a row of the dot operand, whole chunks: bf16
    values (16 mod 128), permuted f32 (64 mod 128) or codes (64 mod 128)."""
    chunks = -(-k // GEMV_CHUNK)
    if dot == "bf16":
        return 2 * chunks * GEMV_CHUNK + 16
    if dot == "f32":
        return 4 * chunks * GEMV_CHUNK + 64
    return chunks * GEMV_CHUNK + (64 if chunks % 2 == 0 else 0)


def _align(v: int, a: int) -> int:
    return -(-v // a) * a


def gemv_smem(ring_bytes: int, x_bytes: int, stage_bytes: int, inbox_bytes: int, bars: int) -> int:
    """Dynamic shared memory of a launch (csrc/gemv.cuh gv_layout): the
    weights, the dot operand, the norm staging, the members' sums, the
    split's inbox and one mbarrier a unit of the block."""
    return ring_bytes + _align(x_bytes, 128) + _align(stage_bytes, 128) + GEMV_TEAM_BYTES + inbox_bytes + 8 * bars


def gemv_block_tiles(tiles: int, grid: int, split: int, b: int) -> range:
    """The tiles block b of ``grid`` runs (csrc/gemv.cuh gemv_kernel): a
    share of the grid's, or with ``split`` > 1 of its cluster's."""
    parts, part = grid // split, b // split
    return range(_range_lo(part, tiles, parts), _range_lo(part + 1, tiles, parts))


class GemvPlan(NamedTuple):
    """One launch's plan: ``grid`` blocks, ``slots`` ring slots of
    ``slot_bytes`` in ``ring_bytes`` (resident: a slot for every unit of
    the fullest block, each unit at its phase's size), ``x_bytes`` of dot
    operand rows, ``stage_bytes`` for the staged x rows and norm vectors,
    ``bars`` mbarriers (one a unit: the sum over the phases of a block's
    most units), ``smem`` in all, ``coop`` (a cooperative launch: the MLP),
    ``split`` (> 1: clusters of that many blocks, one a piece) and
    ``inbox_bytes`` (the piece sums a block owns), and per phase
    ``(pieces, team, row, xrow)``; ``units`` per phase and ``block_units``
    (the most units one block streams) beside them. ``ints`` is the array
    the C entry points take."""

    grid: int
    slots: int
    slot_bytes: int
    ring_bytes: int
    x_bytes: int
    stage_bytes: int
    bars: int
    smem: int
    coop: bool
    split: int
    inbox_bytes: int
    phases: tuple
    units: tuple
    block_units: int
    ints: ctypes.Array

    @property
    def resident(self) -> bool:
        """Every unit of every block has its own slot: the whole weight
        stream is issued at kernel entry."""
        return self.slots >= self.block_units


@functools.lru_cache(maxsize=4096)
def gemv_plan(m: int, dot: str, phases: tuple, sms: int, coop: bool = False) -> GemvPlan:
    """The plan of a GEMV launch of ``m`` rows whose ``phases`` are ``(n, k,
    norm, xel)`` each (norm: whether a row norm runs first; xel: bytes of an
    x value, 2 for bf16, 4 for f32) on a card of ``sms`` SMs. A phase's x
    rows and norm vectors are staged in shared memory (csrc/gemv.cuh
    gv_stage_need) where they fit in GEMV_STAGE_MAX. A single GEMV takes
    min(tiles, 2 · sms) blocks when two fit an SM with four slots each (else
    min(tiles, sms)), or with pieces P > 1 that many clusters of P blocks
    within 2 · sms (or sms) blocks; a cooperative launch (the MLP) one block
    an SM. The slots: as many units as the fullest block streams, or what
    fits; the MLP gives up the staging where that keeps its weights
    resident. Raises ValueError when not even one slot fits beside the dot
    operand."""
    if not 1 <= m <= MAX_ROWS or not 1 <= len(phases) <= 3 or (len(phases) > 1 and not coop):
        raise ValueError(f"GEMV plan: m={m}, {len(phases)} phases, coop={coop}")
    rows, units, tiles = [], [], []
    for n, k, _norm, _xel in phases:
        pieces, team = gemv_split(n, k, coop)
        rows.append((pieces, team, gemv_row_bytes(k, pieces), gemv_x_row(k, dot)))
        tiles.append(-(-n // GEMV_TILE))
        units.append(tiles[-1] * pieces)
    split = rows[0][0] if gemv_clustered(*phases[0][:2], coop) else 1
    slot_bytes = GEMV_TILE * max(r[2] for r in rows)
    x_bytes = m * max(r[3] for r in rows)
    needs = [(8 * k if norm else 0) + m * k * xel for _n, k, norm, xel in phases]
    stage_max = GEMV_STAGE_MAX_MLP if coop else GEMV_STAGE_MAX
    stage_bytes = max((need for need in needs if need <= stage_max), default=0)

    unit_bytes = [GEMV_TILE * r[2] for r in rows]

    def counts(grid, b):
        """Units of each phase block b runs: one a tile (split), else
        every piece of its tiles."""
        return [len(gemv_block_tiles(t, grid, split, b)) * (1 if split > 1 else r[0]) for t, r in zip(tiles, rows)]

    def layout(grid):
        """(bars, inbox_bytes): a bound on a block's units (the kernel's),
        and a split owner's piece sums."""
        parts = grid // split
        block_tiles = [-(-t // parts) for t in tiles]
        bars = sum(bt * (1 if split > 1 else r[0]) for bt, r in zip(block_tiles, rows))
        inbox = -(-block_tiles[0] // split) * split * GEMV_PIECE_BYTES if split > 1 else 0
        return bars, inbox

    def weights_for(grid, budget):
        """(most units of a block, slots, ring_bytes): every unit of every
        block resident where the fullest block's units fit, else a ring."""
        fixed = gemv_smem(0, x_bytes, stage_bytes, layout(grid)[1], layout(grid)[0])
        most = max(sum(counts(grid, b)) for b in range(grid))
        packed = max(sum(c * ub for c, ub in zip(counts(grid, b), unit_bytes)) for b in range(grid))
        if fixed + packed <= budget:
            return most, most, packed
        slots = min(most, (budget - fixed) // slot_bytes)
        return most, slots, slots * slot_bytes

    def grid_and_weights():
        if coop:
            return (sms, *weights_for(sms, GEMV_SMEM))
        grid = split * min(tiles[0], 2 * sms // split)
        most, slots, ring_bytes = weights_for(grid, GEMV_SMEM_PAIR)
        if slots < min(4, most):
            grid = split * min(tiles[0], max(1, sms // split))
            most, slots, ring_bytes = weights_for(grid, GEMV_SMEM)
        return grid, most, slots, ring_bytes

    grid, most, slots, ring_bytes = grid_and_weights()
    if stage_bytes and (slots < 1 or (coop and slots < most)):
        # no room for a slot, or (the MLP) for all its weights, beside the staging: read x from global instead
        staged = stage_bytes, grid, most, slots, ring_bytes
        stage_bytes = 0
        grid, most, slots, ring_bytes = grid_and_weights()
        if slots < most and staged[3] >= 1:  # streaming either way: keep the staging
            stage_bytes, grid, most, slots, ring_bytes = staged
    if slots < 1 or grid > GEMV_MAX_GRID:
        raise ValueError(
            f"GEMV of {m} rows, phases {phases}: the dot operand ({x_bytes} B) and the norm's scale "
            f"and bias ({stage_bytes} B) leave no room for a {slot_bytes}-byte weight slot"
        )
    bars, inbox_bytes = layout(grid)
    smem = gemv_smem(ring_bytes, x_bytes, stage_bytes, inbox_bytes, bars)
    head = [grid, slots, slot_bytes, ring_bytes, x_bytes, stage_bytes, bars, smem, int(coop), split, inbox_bytes]
    ints = (ctypes.c_int * (len(head) + 4 * len(rows)))(*head, *(v for r in rows for v in r))
    return GemvPlan(grid, slots, slot_bytes, ring_bytes, x_bytes, stage_bytes, bars, smem, coop, split, inbox_bytes,
                    tuple(rows), tuple(units), most, ints)


_GEMV_WORK: dict = {}


def gemv_device_plan(x, m: int, dot: str, phases: tuple, coop: bool = False) -> tuple[GemvPlan, int]:
    """``gemv_plan`` on x's card, and the pointer of the argmax's work
    buffer of the current stream: int32 zeros made once per (device,
    stream), whose ticket every launch leaves at 0. Launches on one stream
    run in order, so they may share it; launches on two streams may run at
    once, so each stream has its own."""
    dev = _device_index(x)
    key = (dev, _stream(x))
    work = _GEMV_WORK.get(key)
    if work is None:
        work = _GEMV_WORK[key] = torch.zeros(GEMV_WORK_WORDS, dtype=torch.int32, device=x.device)
    return gemv_plan(m, dot, phases, sm_count(dev), coop), work.data_ptr()


def gemv_dot(x, w8a8: bool = False) -> str:
    """The engine's dot for activations x: ``"s8"`` (W8A8), ``"bf16"`` for
    bf16 activations, else ``"f32"``."""
    return "s8" if w8a8 else "bf16" if x.dtype == torch.bfloat16 else "f32"


def quant_gemv_int8(
    x, w_t, scales, bias=None, *, activation=None, norm=None, norm_scale=None,
    norm_bias=None, norm_eps=1e-5, residual=None, out_dtype=None, argmax_n=None, w8a8=False,
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

    ``w8a8``: the (normalized) f32 rows are quantized per row to int8 and
    the dots are s8 × s8 → s32, rescaled by ``(acc · sx) · scales``.

    CUDA tensors launch ``csrc/quant_gemv.cu`` (one launch, the argmax
    included; ``gemv_plan``); CPU tensors run ``quant_gemv_int8_ref``."""
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
            residual=residual, out_dtype=out_dtype, argmax_n=argmax_n, w8a8=w8a8,
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
    dev = x.device
    if argmax_n is not None:
        out, result = None, torch.empty((m,), dtype=torch.int32, device=dev)
    else:
        out = result = torch.empty((m, n), dtype=out_dtype, device=dev)
    plan, work = gemv_device_plan(x, m, gemv_dot(x, w8a8), ((n, k, norm is not None, x.element_size()),))
    rc = _build.library().rt_quant_gemv(
        x.data_ptr(), int(x.dtype == torch.bfloat16), m,
        w_t.data_ptr(), scales.data_ptr(), n, k, int(w8a8),
        _ptr(bias), _ptr(ns), _ptr(nb), _NORM_CODES[norm], float(norm_eps),
        activation_code(activation), _ptr(residual), _ptr(out), int(out_dtype == torch.bfloat16),
        int(argmax_n or 0), result.data_ptr() if argmax_n is not None else None,
        plan.ints, work, _stream(x),
    )
    _build.check(rc, "quant_gemv_int8")
    LAUNCHES["quant_gemv_int8:w8a8" if w8a8 else "quant_gemv_int8"] += 1
    return result


# Launch plan of the prefill matmuls on int8 weights (csrc/quant_matmul.cu
# qmm_wgmma_kernel, bf16 activations; csrc/quant_matmul_w8a8.cu
# qmm_w8a8_kernel, W8A8, and qmm_s8_wgmma_kernel, W8A8 codes): a block owns
# ``tok`` tokens and ``tok`` output channels (64 for each of its tok / 64
# consumer warpgroups; W8A8: ``ch`` for each), a stage
# QW_BK of K; a cluster of ``split`` blocks divides the n K steps, rank r
# taking ``[r n / split, (r + 1) n / split)``.
QW_BK = 128
MAX_SPLIT = 8  # blocks of a cluster (the portable cluster size)


def split_for(tiles: int, steps: int, sms: int, fits: tuple[int, ...] | None = None) -> int:
    """Blocks a cluster splits the reduction over: 1 while the ``tiles``
    blocks fill at least half the ``sms`` SMs; else as many as fill the
    card, at most ``MAX_SPLIT`` and at most ``steps`` (no rank idle), and,
    given ``fits`` (``fits[c - 1]``: the clusters of c blocks the device
    holds at once), no more than lets all ``tiles`` clusters run at once
    (a cluster lives in one GPC, so 5 or 6 blocks that each fill an SM
    leave some of a GPC's SMs unused)."""
    if 2 * tiles >= sms:
        return 1
    for split in range(max(1, min(MAX_SPLIT, steps, sms // tiles)), 1, -1):
        if fits is None or tiles <= fits[split - 1]:
            return split
    return 1


def matmul_tokens(m: int) -> int:
    return 64 if m <= 64 else 128


@functools.lru_cache(maxsize=1024)
def matmul_plan(m: int, n: int, k: int, sms: int, fits: tuple[int, ...] | None = None) -> tuple[int, int]:
    """``(tok, split)`` of one bf16 ``quant_matmul_int8`` launch on a card
    with ``sms`` SMs: tokens a block (``matmul_tokens``: 64 up to 64 rows,
    else 128) and the split-K cluster size (``split_for``; ``fits``: the
    device's cluster capacity for that block, ``cluster_capacity``)."""
    tok = matmul_tokens(m)
    tiles = -(-n // tok) * -(-m // tok)  # tok channels a block too: a 64-channel warpgroup per 64 tokens
    return tok, split_for(tiles, -(-k // QW_BK), sms, fits)


@functools.lru_cache(maxsize=64)
def cluster_capacity(device_index: int, tok: int, kernel: str = "int8", ch: int = 64, smem: int = 0
                     ) -> tuple[int, ...]:
    """``fits`` of ``split_for`` for ``kernel``'s ``tok``-token block on
    this device (``"int8"``: quant_matmul.cu's bf16 block; ``"w8a8"``: the
    two-launch W8A8 matmul's, with ``ch`` output channels a consumer
    warpgroup; ``"w8a8_fused"``: the one-launch W8A8 kernel's, with
    ``smem`` bytes of shared memory a block): clusters of 1..MAX_SPLIT
    blocks it holds at once (``cudaOccupancyMaxActiveClusters``), queried
    once."""
    lib = _build.library()
    with torch.cuda.device(device_index):
        if kernel == "int8":
            fits = tuple(int(lib.rt_quant_matmul_clusters(tok, c)) for c in range(1, MAX_SPLIT + 1))
        elif kernel == "w8a8":
            fits = tuple(int(lib.rt_quant_matmul_w8a8_clusters(tok, ch, c)) for c in range(1, MAX_SPLIT + 1))
        else:
            fits = tuple(int(lib.rt_quant_matmul_w8a8_fused_clusters(tok, ch, c, smem))
                         for c in range(1, MAX_SPLIT + 1))
    for c, n in enumerate(fits, 1):
        if n < 0:
            _build.check(-n, f"{kernel} matmul cluster capacity (tok {tok}, ch {ch}, cluster {c})")
    return fits


def w8a8_channels(m: int, n: int, sms: int) -> int:
    """Output channels a consumer warpgroup of the W8A8 matmul takes: 128
    (two wgmma M tiles on each stage's codes: a 128-token block of 256
    channels) wherever a block has 128 tokens, else 64. The one-launch
    kernel quantizes its token tile in every block along N, so the wide
    block halves that work, and split-K (``w8a8_plan``) fills the card
    where its tiles are few, shortening each rank's pass over its rows
    (measured on the H100: 1.0-1.7x faster than 64 channels at the
    512-row projections of both models; ``sms`` is unused)."""
    return 128 if matmul_tokens(m) == 128 else 64


@functools.lru_cache(maxsize=1024)
def w8a8_plan(m: int, n: int, k: int, sms: int, fits: tuple[int, ...] | None = None) -> tuple[int, int, int]:
    """``(tok, ch, split)`` of one ``quant_matmul_w8a8`` launch on a card
    with ``sms`` SMs: tokens a block (``matmul_tokens``), output channels a
    consumer warpgroup (``w8a8_channels``; a block has one per 64 tokens)
    and the split-K cluster size (``split_for`` over K stages of ``QW_BK``
    values; ``fits``: the device's cluster capacity for that block,
    ``cluster_capacity``: the one-launch kernel's at ``w8a8_base_smem``, or
    the two-launch matmul's)."""
    tok, ch = matmul_tokens(m), w8a8_channels(m, n, sms)
    tiles = -(-n // (ch * tok // 64)) * -(-m // tok)
    return tok, ch, split_for(tiles, -(-k // QW_BK), sms, fits)


# Shared memory of the one-launch W8A8 kernel (csrc/quant_matmul_w8a8.cu
# qmm_w8a8_kernel) on an H100: a block's most (one 128-token block an SM, or
# any block alone on its SM), and each of two 64-token blocks on one SM (of
# the SM's 228 KB, 1 KB a block is the system's).
W8A8_SMEM_BLOCK = 232448
W8A8_SMEM_PAIR = 233472 // 2 - 1024
W8A8_STAGES_MAX = {(64, 64): 4, (128, 64): 6, (128, 128): 4}  # ring stages at most (the two-launch matmul's)
W8A8_STAGES_REREAD = 3  # ring stages where the rows arrive twice, the rest of the budget for their slots


def w8a8_smem(tok: int, ch: int, stages: int, slots: int, act_bytes: int) -> int:
    """Shared memory of a one-launch W8A8 block (csrc/quant_matmul_w8a8.cu
    Q8XLayout): ``stages`` ring stages of [tok][128] codes and [BN][128]
    weights and ``slots`` activation slots of [tok][128] values of
    ``act_bytes`` (the [tok][BN] int32 sums of the epilogue reuse both, and
    need at least their own size), an mbarrier a stage twice and a slot
    once, three floats a row, and 1024 bytes of alignment slack."""
    bn = ch * tok // 64
    region = max(stages * (tok + bn) * QW_BK + slots * tok * QW_BK * act_bytes, tok * (bn + 4) * 4)
    return 1024 + region + 8 * (2 * stages + slots) + 12 * tok


class W8A8Layout(NamedTuple):
    """A one-launch W8A8 block's shared memory: ``stages`` ring stages,
    ``slots`` activation slots, ``smem`` bytes; ``resident``: the slots
    hold a rank's whole K range of its tile, read once."""

    stages: int
    slots: int
    smem: int
    resident: bool


@functools.lru_cache(maxsize=1024)
def w8a8_layout(tok: int, ch: int, k: int, split: int, act_bytes: int, budget: int) -> W8A8Layout:
    """The layout of a one-launch W8A8 block within ``budget`` bytes, for
    the most K steps a rank of ``split`` takes (``n``): resident (a slot a
    step) with min(n, W8A8_STAGES_MAX) ring stages, or fewer down to
    min(n, 2), where that fits; else the rows arrive a second time, through
    as many slots (at least 2) as fit beside min(n, W8A8_STAGES_REREAD)
    stages, or fewer down to min(n, 2). A rank of two steps or more needs
    two stages (its consumers free a stage one step late). Raises
    ValueError when nothing fits."""
    n = -(-(-(-k // QW_BK)) // split)
    low, top = min(n, 2), min(n, W8A8_STAGES_MAX[tok, ch])

    def smem(stages, slots):
        return w8a8_smem(tok, ch, stages, slots, act_bytes)

    for stages in range(top, low - 1, -1):
        if smem(stages, n) <= budget:
            return W8A8Layout(stages, n, smem(stages, n), True)
    for stages in range(min(top, W8A8_STAGES_REREAD), low - 1, -1):
        slots = 2
        while slots + 1 < n and smem(stages, slots + 1) <= budget:
            slots += 1
        if smem(stages, slots) <= budget:
            return W8A8Layout(stages, slots, smem(stages, slots), False)
    raise ValueError(f"W8A8 block {tok} x {ch}, K {k}, split {split}, {act_bytes}-byte values: no layout fits "
                     f"{budget} bytes")


def w8a8_base_smem(tok: int) -> int:
    """The shared memory a one-launch W8A8 block plans within unless it has
    an SM to itself: two 64-token blocks an SM, one 128-token block."""
    return W8A8_SMEM_PAIR if tok == 64 else W8A8_SMEM_BLOCK


def w8a8_budget(tok: int, tiles: int, split: int, sms: int, fits_alone: tuple[int, ...] | None = None) -> int:
    """A one-launch W8A8 block's shared-memory budget: a block's most where
    every block of the launch has an SM of its own (``tiles · split ≤
    sms`` and, given ``fits_alone``, the capacity of clusters of blocks
    that fill their SM, every cluster at once), else ``w8a8_base_smem``."""
    if tiles * split <= sms and (fits_alone is None or tiles <= fits_alone[split - 1]):
        return W8A8_SMEM_BLOCK
    return w8a8_base_smem(tok)


class W8A8Plan(NamedTuple):
    """One ``quant_matmul_w8a8`` launch: ``w8a8_plan``'s (tok, ch, split)
    and ``w8a8_layout``'s stages, slots, smem and resident."""

    tok: int
    ch: int
    split: int
    stages: int
    slots: int
    smem: int
    resident: bool


@functools.lru_cache(maxsize=16)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _device_index(t) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _sms(t) -> int:
    return sm_count(_device_index(t))


def device_plan(x, n: int) -> tuple[int, int]:
    """``matmul_plan`` of bf16 rows ``x`` [M, K] against N output channels
    on x's card, with its SM count and cluster capacity."""
    m, k = x.shape
    idx = _device_index(x)
    return matmul_plan(m, n, k, sm_count(idx), cluster_capacity(idx, matmul_tokens(m)))


def w8a8_device_plan(x, n: int) -> W8A8Plan:
    """The one-launch plan of rows x [M, K] (f32 or bf16) against N output
    channels on x's card: ``w8a8_plan`` with its SM count and the chosen
    block's cluster capacity at ``w8a8_base_smem``, then ``w8a8_layout``
    within ``w8a8_budget`` (for a 64-token block, given the capacity of
    blocks alone on their SM)."""
    m, k = x.shape
    idx = _device_index(x)
    sms = sm_count(idx)
    tok, ch = matmul_tokens(m), w8a8_channels(m, n, sms)
    tok, ch, split = w8a8_plan(m, n, k, sms, cluster_capacity(idx, tok, "w8a8_fused", ch, w8a8_base_smem(tok)))
    tiles = -(-n // (ch * tok // 64)) * -(-m // tok)
    alone = cluster_capacity(idx, tok, "w8a8_fused", ch, W8A8_SMEM_BLOCK) if tok == 64 else None
    layout = w8a8_layout(tok, ch, k, split, x.element_size(), w8a8_budget(tok, tiles, split, sms, alone))
    return W8A8Plan(tok, ch, split, *layout)


def w8a8_codes_plan(codes, n: int) -> tuple[int, int, int]:
    """``w8a8_plan`` of the two-launch matmul on codes [M, K] against N
    output channels on their card, with its SM count and the chosen block's
    cluster capacity."""
    m, k = codes.shape
    idx = _device_index(codes)
    sms = sm_count(idx)
    tok, ch = matmul_tokens(m), w8a8_channels(m, n, sms)
    return w8a8_plan(m, n, k, sms, cluster_capacity(idx, tok, "w8a8", ch))


def quant_matmul_int8(x, w_t, scales, bias=None, *, activation=None, out_dtype=None):
    """Prefill matmul with the epilogue applied once, after the whole K sum:

        out = activation((x @ W) * scales + bias)

    x: [M, K] f32/bf16; w_t: int8 [N, K] (``int8_pack``); scales [N] f32;
    bias [N]. Returns [M, N] in ``out_dtype`` (default x.dtype). The order
    is ``acc * scale → + bias → activation → out_dtype``.

    M ≤ 8 hands off to ``quant_gemv_int8``, as the TPU function does. Above
    that, CUDA tensors launch ``csrc/quant_matmul.cu``: bf16 activations on
    the tensor cores (``wgmma`` from a TMA-fed ring, f32 accumulation,
    split-K across a cluster by ``matmul_plan``), f32 activations on an f32
    SIMT path with exact f32 products (no rounding to bf16 or TF32). A
    split-K launch also counts under ``quant_matmul_int8:split_k``. CPU
    tensors run ``quant_matmul_int8_ref``."""
    m, k = x.shape
    n = w_t.shape[0]
    if m <= MAX_ROWS:
        return quant_gemv_int8(x, w_t, scales, bias, activation=activation, out_dtype=out_dtype)
    out_dtype = out_dtype or x.dtype
    if not use_kernel(x, w_t, scales, bias):
        return quant_matmul_int8_ref(x, w_t, scales, bias, activation=activation, out_dtype=out_dtype)
    _check_act(x, "quant_matmul_int8")
    _check_weight(w_t, k, "quant_matmul_int8")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quant_matmul_int8: out_dtype must be float32 or bfloat16, got {out_dtype}")
    scales = _vec_f32(scales, n, "scales")
    bias = _vec_f32(bias, n, "bias")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    tok, split = device_plan(x, n) if x.dtype == torch.bfloat16 else (0, 1)
    rc = _build.library().rt_quant_matmul(
        x.data_ptr(), int(x.dtype == torch.bfloat16), m, k,
        w_t.data_ptr(), scales.data_ptr(), _ptr(bias), n,
        activation_code(activation), out.data_ptr(), int(out_dtype == torch.bfloat16),
        tok, split, _stream(x),
    )
    _build.check(rc, "quant_matmul_int8")
    LAUNCHES["quant_matmul_int8"] += 1
    if split > 1:
        LAUNCHES["quant_matmul_int8:split_k"] += 1
    return out


def quantize_rows_int8(x):
    """Per-row symmetric int8 quantization of activations x [M, K] (f32 or
    bf16): ``(codes int8 [M, K], sx f32 [M, 1])`` with ``sx = absmax / 127``
    (1 for an all-zero row) and codes ``clip(round_half_even(x / sx),
    ±127)``, both divisions IEEE. The JAX package's ``_act_quantize``.
    ``quant_matmul_w8a8`` quantizes inside its own launch; this, with
    ``quant_matmul_w8a8_codes``, is the two-launch yardstick it must equal.

    CUDA tensors launch the row-quantize kernel of
    ``csrc/quant_matmul_w8a8.cu`` (one block per row); CPU tensors run
    ``quantize_rows_int8_ref``."""
    if not use_kernel(x):
        return quantize_rows_int8_ref(x)
    _check_act(x, "quantize_rows_int8")
    m, k = x.shape
    if k % 16:
        raise ValueError(f"quantize_rows_int8: the row width {k} must be a multiple of 16")
    codes = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    rc = _build.library().rt_quantize_rows(
        x.data_ptr(), int(x.dtype == torch.bfloat16), m, k, codes.data_ptr(), sx.data_ptr(), _stream(x),
    )
    _build.check(rc, "quantize_rows_int8")
    LAUNCHES["quantize_rows_int8"] += 1
    return codes, sx


def quant_matmul_w8a8(x, w_t, scales, bias=None, *, activation=None, out_dtype=None):
    """Prefill matmul in W8A8 mode, x quantized per row to int8:

        out = activation((codes @ W) * sx * scales + bias)

    x: [M, K] f32/bf16; w_t: int8 [N, K] (``int8_pack``); scales [N] f32;
    bias [N]. Returns [M, N] in ``out_dtype`` (default x.dtype). The sums
    are exact in int32; the epilogue is ``(acc · sx) · scale → + bias →
    activation → out_dtype``.

    M ≤ 8 hands off to ``quant_gemv_int8(w8a8=True)``, the same function
    (per-row codes, exact sums, the same epilogue; the TPU function has no
    hand-off). Above that, CUDA tensors launch ``csrc/quant_matmul_w8a8.cu``
    once: a block quantizes its own token tile (the rows' absmax across the
    split-K cluster through distributed shared memory, the codes written
    into the stage the int8 ``wgmma`` reads) and multiplies it on a
    TMA-fed ring, split-K across a cluster (``w8a8_device_plan``). The
    result equals ``quant_matmul_w8a8_codes(*quantize_rows_int8(x), ...)``
    bit for bit. A split-K launch also counts under
    ``quant_matmul_w8a8:split_k``. CPU tensors run
    ``quant_matmul_w8a8_ref``."""
    m, k = x.shape
    n = w_t.shape[0]
    if m <= MAX_ROWS:
        return quant_gemv_int8(x, w_t, scales, bias, activation=activation, out_dtype=out_dtype, w8a8=True)
    out_dtype = out_dtype or x.dtype
    if not use_kernel(x, w_t, scales, bias):
        return quant_matmul_w8a8_ref(x, w_t, scales, bias, activation=activation, out_dtype=out_dtype)
    _check_act(x, "quant_matmul_w8a8")
    _check_weight(w_t, k, "quant_matmul_w8a8")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quant_matmul_w8a8: out_dtype must be float32 or bfloat16, got {out_dtype}")
    scales = _vec_f32(scales, n, "scales")
    bias = _vec_f32(bias, n, "bias")
    plan = w8a8_device_plan(x, n)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    rc = _build.library().rt_quant_matmul_w8a8_fused(
        x.data_ptr(), int(x.dtype == torch.bfloat16), m, k,
        w_t.data_ptr(), scales.data_ptr(), _ptr(bias), n,
        activation_code(activation), out.data_ptr(), int(out_dtype == torch.bfloat16),
        plan.tok, plan.ch, plan.split, plan.stages, plan.slots, _stream(x),
    )
    _build.check(rc, "quant_matmul_w8a8")
    LAUNCHES["quant_matmul_w8a8"] += 1
    if plan.split > 1:
        LAUNCHES["quant_matmul_w8a8:split_k"] += 1
    return out


def quant_matmul_w8a8_codes(codes, sx, w_t, scales, bias=None, *, activation=None, out_dtype=torch.float32):
    """The matmul of ``quant_matmul_w8a8`` alone, on rows already quantized
    by ``quantize_rows_int8`` (codes int8 [M, K], sx f32 [M, 1]), any M:

        out = activation((codes @ W) * sx * scales + bias)

    With ``quantize_rows_int8``, the two-launch pair the one-launch
    ``quant_matmul_w8a8`` must equal bit for bit, and the like-for-like
    matmul time beside ``torch._int_mm``; no model path calls it. CUDA
    tensors launch ``csrc/quant_matmul_w8a8.cu``'s int8 ``wgmma`` kernel on
    the codes by TMA (``w8a8_codes_plan``; a split-K launch also counts
    under ``quant_matmul_w8a8:split_k``); CPU tensors compute the same sums
    and epilogue in PyTorch."""
    m, k = codes.shape
    n = w_t.shape[0]
    if not use_kernel(codes, sx, w_t, scales, bias):
        acc = (codes.double() @ w_t.double().t()).float()
        out = (acc * sx.float().reshape(m, 1)) * scales.float()
        if bias is not None:
            out = out + bias.float()
        return ACTIVATIONS[activation](out).to(out_dtype)
    if codes.dtype != torch.int8 or not codes.is_contiguous() or codes.data_ptr() % 16:
        raise ValueError("quant_matmul_w8a8_codes: codes must be a contiguous, 16-byte aligned int8 [M, K] matrix")
    _check_weight(w_t, k, "quant_matmul_w8a8")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"quant_matmul_w8a8: out_dtype must be float32 or bfloat16, got {out_dtype}")
    sxv = _vec_f32(sx, m, "sx")
    scales = _vec_f32(scales, n, "scales")
    bias = _vec_f32(bias, n, "bias")
    tok, ch, split = w8a8_codes_plan(codes, n)
    out = torch.empty((m, n), dtype=out_dtype, device=codes.device)
    rc = _build.library().rt_quant_matmul_w8a8(
        codes.data_ptr(), sxv.data_ptr(), m, k,
        w_t.data_ptr(), scales.data_ptr(), _ptr(bias), n,
        activation_code(activation), out.data_ptr(), int(out_dtype == torch.bfloat16),
        tok, ch, split, _stream(codes),
    )
    _build.check(rc, "quant_matmul_w8a8")
    LAUNCHES["quant_matmul_w8a8"] += 1
    if split > 1:
        LAUNCHES["quant_matmul_w8a8:split_k"] += 1
    return out


def quant_mlp_int8(
    x, w_up_t, up_scales, w_down_t, down_scales, b_up=None, b_down=None, *,
    activation="gelu", norm=None, norm_scale=None, norm_bias=None, norm_eps=1e-5,
    residual=None, next_qkv=None, w8a8=False,
):
    """Whole transformer-MLP decode step for M ≤ 8 rows:

        out = norm(x) @ W_up (+b) → activation → @ W_down (+b) + residual

    x: [M, D]; w_up_t int8 [FF, D]; w_down_t int8 [D, FF] (``int8_pack``).
    With ``next_qkv = (w_qkv_t [Nq, D], scales, bias|None, next_norm_scale,
    next_norm_bias|None)`` it also returns the next layer's pre-norm + qkv
    projection of the f32 block output: ``(out, qkv [M, Nq])``. Outputs are
    in x.dtype.

    ``w8a8``: every phase quantizes its f32 input rows per row to int8
    (the normalized rows, the f32 up output over FF, the normalized block
    output) and runs s8 × s8 → s32 dots.

    CUDA tensors launch ``csrc/quant_mlp.cu`` (one cooperative launch of
    the GEMV engine's phases: up into an f32 [M, FF] scratch, down, next
    qkv; ``gemv_plan``); CPU tensors run ``quant_mlp_int8_ref``."""
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
            next_qkv=next_qkv, w8a8=w8a8,
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
    phases = ((ff, d, norm is not None, x.element_size()), (d, ff, False, 4)) + (
        ((nq, d, True, 4),) if next_qkv is not None else ())
    plan, work = gemv_device_plan(x, m, gemv_dot(x, w8a8), phases, coop=True)
    rc = _build.library().rt_quant_mlp(
        x.data_ptr(), int(x.dtype == torch.bfloat16), m, d,
        w_up_t.data_ptr(), su.data_ptr(), _ptr(bu), ff,
        w_down_t.data_ptr(), sd.data_ptr(), _ptr(bd),
        _ptr(ns), _ptr(nb), _NORM_CODES[norm], float(norm_eps), activation_code(activation),
        _ptr(residual), out.data_ptr(), up_buf.data_ptr(), _ptr(h_buf),
        _ptr(wq), _ptr(sq), _ptr(bq), nq, _ptr(qns), _ptr(qnb), _ptr(qkv),
        int(w8a8), plan.ints, work, _stream(x),
    )
    _build.check(rc, "quant_mlp_int8")
    LAUNCHES["quant_mlp_int8:w8a8" if w8a8 else "quant_mlp_int8"] += 1
    return out if next_qkv is None else (out, qkv)
