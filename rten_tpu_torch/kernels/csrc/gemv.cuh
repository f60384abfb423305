// The decode GEMV engine (M <= 8 rows against an int8 weight matrix with
// per-output-channel f32 scales), with a fused row-norm prologue and a
// scale / bias / activation / residual epilogue or a fused greedy argmax:
//
//     out = activation((norm(x) @ W) * scale + bias) + residual
//
// One kernel runs one to three such GEMVs ("phases") in one launch:
// quant_gemv.cu launches one (the argmax included), quant_mlp.cu three (up,
// down, next qkv: a cooperative launch with a grid barrier between phases)
// and decode_attention.cu one for the output projection.
//
// Replaces the TPU's rten_tpu/kernels/quant_matmul.py _gemv_kernel (:201),
// _gemv_epilogue (:159) and the dots of _mlp_kernel (:863).
//
// Bound on the H100: bytes. Each int8 weight is read once and used for at
// most 8 multiply-adds, far below the card's ~295 operations per byte, so
// the time is the weight stream over the 3.35 TB/s memory rate plus the
// latency of a launch, of the first bytes and of the epilogue.
//
// Design against that bound:
// - Work: output columns in tiles of 16 (the mma's M). A tile's K is cut
//   into `pieces` (P) contiguous ranges of 64-byte chunks; a (tile, piece)
//   is a unit. P > 1 when a GEMV of its own has few tiles and a long K
//   (the down projections: pieces of at least 12 chunks) or K is over 3072
//   bytes (a slot holds a unit). A
//   block owns a contiguous range of a phase's tiles, the same share for
//   every block (range_lo), so every block has its weights as soon as it
//   starts: all P pieces of each (the MLP's launch), or, in a GEMV of its
//   own with P > 1, one piece of each tile of its cluster's range.
// - Weights in flight from kernel entry: a unit's 16 weight rows are
//   copied by 1-D bulk TMA (cp.async.bulk: an unsplit tile's rows as the one
//   contiguous run they are, a split tile's one copy a row; completing on
//   the unit's own mbarrier, used once: teams run ahead of one another, so
//   a slot's barrier reused by phase parity could report a later unit's
//   bytes as arrived) into a ring of shared-memory slots. The first `slots`
//   units of the block (of every phase: the weights do not depend on the
//   data) are issued before the prologue reads x, so the row norm runs
//   while the bytes arrive; the team that finishes a unit issues the unit
//   `slots` later into the freed slot. Where every unit of a block fits,
//   the whole stream is issued at entry (the MLP at GPT-2's widths).
// - Dots on tensor cores: mma.sync m16n8k16 (bf16 x bf16 -> f32) with A =
//   16 weight columns x 16 K converted from int8 in registers (exact), B =
//   up to 8 activation rows from shared memory, so 1 row and 8 rows cost
//   the same. W8A8 runs m16n8k32 s8 x s8 -> s32 (exact) on the int8
//   weights as they are and the rows' codes. The f32 dot (f32 activations,
//   the attention vector of the fused wo) splits each f32 activation into
//   three bf16 parts whose sum is the value exactly and runs three products:
//   each product is exact, only the f32 sums round.
// - K order: lane (g, t) of a warp takes bytes [16 t, 16 t + 16) of a
//   64-byte chunk of columns g and g + 8; step s of the chunk's four mma
//   steps (two for s8) uses its bytes 4 s .. 4 s + 3 (8 s .. 8 s + 7 for
//   s8), and the B fragment takes the activations at the same K positions.
//   A chunk's K is summed in another order than 0..63 but in one fixed
//   order. The activation rows are padded so that these 16-byte reads are
//   free of bank conflicts (bf16 rows 16 mod 128 bytes; f32 rows permuted,
//   64 mod 128; codes 64 mod 128); the weight rows keep their global
//   stride (at most a 2-way conflict; shared memory is not the limit).
//   Each member runs two accumulator chains (even and odd chunks).
// - Teams: a unit is summed by a team of `team` (S) warps, member s taking
//   the s-th contiguous share of the unit's chunks; member 0 adds the
//   members' sums in member order. S is 8 for the few-unit matrices (a
//   block's one or two units are spread over all its warps) and 1 for the
//   lm_head (each warp its own units); in the MLP's launch (one block an
//   SM) 4 from 129 units, so that a block's two units run side by side.
// - Determinism: P and S are functions of (n, k) alone
//   (quant_matmul.gemv_split), so a column's sum order (chunk order within
//   a member, members in order, pieces in order) never depends on m, on a
//   row's place among the rows, on the grid or on the SM count: a row alone
//   and the same row among 8 give the same bits.
// - A split tile (P > 1), in a GEMV of its own: the launch is clusters of
//   P blocks, rank r summing piece r of each of the cluster's tiles. Each
//   piece's sum goes by a distributed-shared-memory store into the inbox of
//   the tile's owner (rank (tile - first tile) % P); after one cluster
//   barrier the owner adds the pieces in order 0..P-1 and runs the
//   epilogue. No state outlives the launch. In the MLP's cooperative launch
//   (one block an SM, no cluster) a tile's pieces are one block's and are
//   run in order by its one team of 8 warps, which carries the sum from
//   piece to piece: the same order, no combine.
// - Argmax: each block keeps (max, lowest index) per row over the columns
//   it finished, writes one partial per row, and the last block to arrive
//   (a ticket, reset by it) reduces them: the TPU's tie rule, the lowest
//   column index among equal maxima.
//
// - Latency at 1 row: a 1-row call is a chain of dependent steps (the
//   parameters, the block's ranges, the barriers' init, the copies' issue,
//   x, the norm, the dots, the fold, the epilogue), each a few hundred
//   cycles of single-warp work. So every device function is inlined into
//   the kernel, the kernel is instantiated per phase count (PH: 1 for a
//   GEMV, GV_PHASES for the MLP) so that the block's ranges are indexed at
//   compile time and stay in registers, and each function reads its phase
//   from a register copy (see gv_prologue).
//
// Numerics, as the plain versions (quant_matmul.py): the norm in f32 over
// the whole row; bf16 models round the normalised row to bf16 before a
// weight-only dot; W8A8 quantizes the f32 row per row (quantize_row), sums
// codes exactly and rescales as ((float)acc * sx) * scale with each product
// rounded; the epilogue order is acc * scale, + bias, activation,
// + residual.
#pragma once

#include <climits>

#include "common.cuh"
#include "hopper.cuh"

namespace rt {
namespace {

namespace cg = cooperative_groups;

constexpr int GV_WARPS = 8;
constexpr int GV_THREADS = GV_WARPS * 32;
constexpr int GV_TILE = 16;      // output columns a unit (the mma's M)
constexpr int GV_CHUNK = 64;     // K bytes of a column a chunk: 4 lanes x 16
constexpr int MAXM = 8;          // rows (the mma's N)
constexpr int GV_PHASES = 3;
constexpr int GV_TEAM_BYTES = 2 * GV_WARPS * 32 * 16;  // members' sums, double-buffered
constexpr int GV_PIECE_BYTES = 32 * 16;                // a piece's sum in an inbox: 32 lanes x 4 words
constexpr int GV_MAX_SPLIT = 8;                        // cluster of a split GEMV (the portable size)
// The argmax's scratch (quant_matmul.py GEMV_WORK_WORDS), in 32-bit words:
// the ticket, then the partials (value, index) of [MAXM][grid].
constexpr int GV_MAX_GRID = 1024;
constexpr int GV_WORK_ARGMAX = 32;
constexpr float ARGMAX_MASK = -3.389e38f;  // value of masked columns (the TPU kernel's)

enum { DOT_BF16 = 0, DOT_F32 = 1, DOT_S8 = 2 };

struct GvPhase {
  const void* x;            // [m, k] activations, f32 or bf16 (x_bf16), 16-byte aligned
  int x_bf16;
  const int8_t* w;          // [n, k] int8, k % 16 == 0, 16-byte aligned
  const float* scale;       // [n]
  const float* bias;        // [n] or null
  int n, k;
  const float* norm_scale;  // [k] (16-byte aligned) or null
  const float* norm_bias;   // [k] or null
  int norm;                 // 0 none, 1 layernorm, 2 rmsnorm
  float eps;
  int act;                  // activations.py ACTIVATION_CODES (common.cuh activate)
  const void* residual;     // [m, n] of the output dtype, or null
  void* out;                // [m, n] f32 or bf16 (out_bf16), or null
  int out_bf16;
  float* out_f32;           // [m, n] f32 copy of the output, or null
  int argmax_n;             // > 0: greedy argmax over columns < argmax_n
  int* argmax_out;          // [m] int32
  // The plan (quant_matmul.py gemv_plan).
  int pieces;               // P: K pieces of a tile
  int team;                 // S: warps summing one unit (1, 2, 4 or 8)
  int row;                  // shared-memory bytes of a unit's weight row
  int xrow;                 // shared-memory bytes of a row of the dot operand
};

struct GvArgs {
  GvPhase ph[GV_PHASES];
  int phases;
  int m;
  int split;                // > 1: clusters of `split` blocks, one a piece (one phase, pieces == split)
  int slots;                // ring slots
  int slot_bytes;           // a ring slot: 16 * the largest row
  int ring_bytes;           // the weights' region: the ring, or every unit of the fullest block
  int x_bytes;              // the dot operand rows
  int stage_bytes;          // staging of x and the norm's scale and bias (gv_stage_need), or 0
  int bars;                 // mbarriers: at least the units of any block
  int inbox_bytes;          // split: the piece sums of the tiles a block owns
  float* amax_val;          // [m][grid] argmax partials
  int* amax_idx;
  int* amax_ticket;
};

// Shared-memory layout (dynamic): the ring, the dot operand rows, the f32
// staging rows, the members' sums, the split's inbox, one mbarrier a unit.
// quant_matmul.py gemv_plan computes the same total.
__host__ __device__ __forceinline__ int align_up(int v, int a) { return (v + a - 1) / a * a; }

struct GvLayout {
  int x, stage, team, inbox, bars, total;
};

__host__ __device__ __forceinline__ GvLayout gv_layout(int ring_bytes, int x_bytes, int stage_bytes, int inbox_bytes,
                                                       int bars) {
  GvLayout l;
  l.x = ring_bytes;
  l.stage = l.x + align_up(x_bytes, 128);
  l.team = l.stage + align_up(stage_bytes, 128);
  l.inbox = l.team + GV_TEAM_BYTES;
  l.bars = l.inbox + inbox_bytes;
  l.total = l.bars + 8 * bars;
  return l;
}

__host__ __device__ __forceinline__ int gv_chunks(int k) { return (k + GV_CHUNK - 1) / GV_CHUNK; }

// Start of part i of `total` things cut into `parts` (the same arithmetic as
// quant_matmul.py _range_lo).
__host__ __device__ __forceinline__ int range_lo(int i, int total, int parts) {
  return i * total / parts;  // i * total < 2^31 for every plan (quant_matmul.py gemv_plan)
}

// (value, index) pair order for the argmax: larger value first, then the
// lower index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i, int from = 1) {
#pragma unroll
  for (int o = 16; o >= from; o >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
    const int i2 = __shfl_xor_sync(0xffffffffu, i, o);
    if (better(v2, i2, v, i)) {
      v = v2;
      i = i2;
    }
  }
}

// 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Spin until the (only) phase of a unit's barrier has completed; a poll,
// not try_wait, which may suspend the warp past the phase's completion.
__device__ __forceinline__ void mbar_poll(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_POLL:\n"
      "mbarrier.test_wait.parity.shared::cta.b64 P1, [%0], 0;\n"
      "@!P1 bra LAB_POLL;\n"
      "}\n" ::"r"(smem_u32(bar))
      : "memory");
}

// Barrier of the `count` threads of a team (ids 1..8; 0 is __syncthreads).
__device__ __forceinline__ void team_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- the dot's building blocks ----------------------------------------------

// Four int8 weights (one word, element i in byte i) as two bf16 pairs (lo:
// elements 0, 1; hi: 2, 3), exactly: each byte, offset to unsigned by the
// XOR, becomes the low mantissa byte of 2^23 (a byte permute), one
// subtraction removes 2^23 + 128, and the f32 value, an integer of at most
// 8 significant bits, is its own upper half (a second permute packs two).
__device__ __forceinline__ void i8x4_bf16(unsigned w, unsigned& lo, unsigned& hi) {
  const unsigned u = w ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Two f32 values as three bf16 pairs whose sums are the values exactly
// (8 + 8 + 8 significant bits; each residual is exact in f32).
__device__ __forceinline__ void split3(float x0, float x1, unsigned& h, unsigned& md, unsigned& l) {
  h = bf16x2(x0, x1);
  const float r0 = x0 - __uint_as_float(h << 16), r1 = x1 - __uint_as_float(h & 0xffff0000u);
  md = bf16x2(r0, r1);
  const float s0 = r0 - __uint_as_float(md << 16), s1 = r1 - __uint_as_float(md & 0xffff0000u);
  l = bf16x2(s0, s1);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0, unsigned a1, unsigned a2, unsigned a3,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], unsigned a0, unsigned a1, unsigned a2, unsigned a3, unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int DOT>
using GvAcc = std::conditional_t<DOT == DOT_S8, int, float>;

// One 64-byte chunk c of a unit by lane (g, t): weight bytes [16 t, 16 t +
// 16) of the chunk in rows g and g + 8 of the unit's slot (`wrow` points at
// the chunk's byte 16 t of row 0), the activations of row g (zeros past m)
// at the same K.
template <int DOT>
__device__ __forceinline__ void dot_chunk(GvAcc<DOT> (&acc)[4], const uint8_t* wrow, int row_bytes,
                                          const uint8_t* xs, int xrow, int c, int g, int t, bool live) {
  const int4 wa = *reinterpret_cast<const int4*>(wrow + g * row_bytes);
  const int4 wb = *reinterpret_cast<const int4*>(wrow + (g + 8) * row_bytes);
  const unsigned wa_w[4] = {(unsigned)wa.x, (unsigned)wa.y, (unsigned)wa.z, (unsigned)wa.w};
  const unsigned wb_w[4] = {(unsigned)wb.x, (unsigned)wb.y, (unsigned)wb.z, (unsigned)wb.w};
  if constexpr (DOT == DOT_S8) {
    int4 q = make_int4(0, 0, 0, 0);
    if (live) q = *reinterpret_cast<const int4*>(xs + g * xrow + c * GV_CHUNK + 16 * t);
    mma_s8(acc, wa_w[0], wb_w[0], wa_w[1], wb_w[1], (unsigned)q.x, (unsigned)q.y);
    mma_s8(acc, wa_w[2], wb_w[2], wa_w[3], wb_w[3], (unsigned)q.z, (unsigned)q.w);
  } else if constexpr (DOT == DOT_BF16) {
    uint4 x0 = make_uint4(0, 0, 0, 0), x1 = x0;
    if (live) {
      const uint4* xp = reinterpret_cast<const uint4*>(xs + g * xrow + 2 * (c * GV_CHUNK + 16 * t));
      x0 = xp[0];
      x1 = xp[1];
    }
    const unsigned xw[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      unsigned a0, a2, a1, a3;
      i8x4_bf16(wa_w[s], a0, a2);
      i8x4_bf16(wb_w[s], a1, a3);
      mma_bf16(acc, a0, a1, a2, a3, xw[2 * s], xw[2 * s + 1]);
    }
  } else {
    // f32 rows, permuted: element 16 t + j of chunk c at float c * 64 +
    // (j / 4) * 16 + t * 4 + j % 4, so float4 s of the lane's 16 is at c *
    // 64 + s * 16 + t * 4.
    const float4* xp = reinterpret_cast<const float4*>(xs + g * xrow) + c * 16 + t;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live) v = xp[4 * s];
      unsigned a0, a2, a1, a3;
      i8x4_bf16(wa_w[s], a0, a2);
      i8x4_bf16(wb_w[s], a1, a3);
      unsigned h0, m0, l0, h1, m1, l1;
      split3(v.x, v.y, h0, m0, l0);
      split3(v.z, v.w, h1, m1, l1);
      mma_bf16(acc, a0, a1, a2, a3, l0, l1);
      mma_bf16(acc, a0, a1, a2, a3, m0, m1);
      mma_bf16(acc, a0, a1, a2, a3, h0, h1);
    }
  }
}

// ---- the prologue: the dot operand rows into shared memory -----------------

// Four consecutive activations (i % 4 == 0) as f32 from shared memory.
__device__ __forceinline__ float4 load_act4_shared(const void* p, int bf16, size_t i) {
  if (bf16) {
    const uint2 v = *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p) + i);
    return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u), __uint_as_float(v.y << 16),
                       __uint_as_float(v.y & 0xffff0000u));
  }
  return *reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
}

// Four values 4v .. 4v + 3 of row r into the dot operand's layout.
template <int DOT>
__device__ __forceinline__ void put4(uint8_t* xs, int xrow, int r, int v, float4 y, float sx) {
  uint8_t* row = xs + r * xrow;
  if constexpr (DOT == DOT_BF16) {
    *reinterpret_cast<uint2*>(row + 8 * v) = make_uint2(bf16x2(y.x, y.y), bf16x2(y.z, y.w));
  } else if constexpr (DOT == DOT_F32) {
    const int e = 4 * v, c = e / GV_CHUNK, t = (e % GV_CHUNK) / 16, q = (e % 16) / 4;
    reinterpret_cast<float4*>(row)[c * 16 + q * 4 + t] = y;
  } else {
    *reinterpret_cast<unsigned*>(row + 4 * v) = quantize4(y, sx);
  }
}

constexpr int GV_ROWQ = 8;  // float4 of a row a lane keeps in registers: rows of up to 1024 values

// Bytes a phase stages in shared memory: the norm's scale and bias (2 k
// f32) and the operand rows as they are (m k values of x's dtype).
__host__ __device__ __forceinline__ int gv_stage_need(const GvPhase& p, int m) {
  return (p.norm ? 8 * p.k : 0) + m * p.k * (p.x_bf16 ? 2 : 4);
}

// The phase's staging copies, one cp.async group: the scale and bias, then
// x's rows (from L2: .cg). Issued by every thread, at kernel entry for the
// first phase so that x is in flight beside the weights.
__device__ void gv_stage_issue(const GvPhase& p, int m, float* stage) {
  const int tid = threadIdx.x, nv = p.k / 4;
  if (p.norm) {
    for (int v = tid; v < 2 * nv; v += GV_THREADS) {
      const bool bias = v >= nv;
      cp_async16(stage + 4 * v, bias ? p.norm_bias + 4 * (v - nv) : p.norm_scale + 4 * v, !bias || p.norm_bias);
    }
  }
  uint8_t* dst = reinterpret_cast<uint8_t*>(stage + (p.norm ? 2 * p.k : 0));
  const uint8_t* src = static_cast<const uint8_t*>(p.x);
  const int pieces = m * p.k * (p.x_bf16 ? 2 : 4) / 16;
  for (int i = tid; i < pieces; i += GV_THREADS) cp_async16(dst + 16 * i, src + 16 * i, true);
  cp_async_commit();
}

// The rows of a phase's dot operand, zero-filled to a whole number of
// chunks: rounded to bf16 (DOT_BF16), kept f32 (DOT_F32) or quantized per
// row (DOT_S8; sx: the rows' scales), after the row norm in f32. x is read
// from L2 (the MLP's later phases read what other blocks wrote before the
// grid barrier).
// - Without a norm and for a dot in bf16 or f32, every thread converts its
//   share of all rows' values, eight loads in flight at a time.
// - Otherwise warp r normalises and quantizes row r, lane l taking values
//   l, l + 32, ...: every reduction is a warp's (shuffles, no block barrier)
//   and a row's arithmetic never depends on the other rows. A row of up to
//   1024 values stays in registers; a longer one is read again for each
//   pass.
// x and the norm's scale and bias come from `stage` (gv_stage_issue;
// `issued`: at kernel entry) or, with `stage` null (too large to stage),
// from global memory.
// Every function here reads the phase from a copy in registers (`p`), made
// at its entry: the shared copy would be read again after each shared-memory
// store (they may alias), a dependent load of ~30 cycles each time.
template <int DOT>
__device__ __forceinline__ void gv_prologue(const GvPhase& phase, int m, uint8_t* xs, float* stage, float* sx,
                                            bool issued) {
  const GvPhase p = phase;
  const int tid = threadIdx.x, lane = tid & 31, r = tid >> 5;
  const int k = p.k, nv = k / 4, nvp = gv_chunks(k) * (GV_CHUNK / 4);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const bool staged = stage != nullptr;
  if (staged) {
    if (!issued) gv_stage_issue(p, m, stage);
    cp_async_wait<0>();
    __syncthreads();
  }
  const void* xsrc = staged ? static_cast<const void*>(stage + (p.norm ? 2 * k : 0)) : p.x;
  const auto load = [&](int row, int v) {
    return staged ? load_act4_shared(xsrc, p.x_bf16, (size_t)row * k + 4 * v)
                  : load_act4<true>(p.x, p.x_bf16, (size_t)row * k + 4 * v);
  };
  if (DOT != DOT_S8 && !p.norm) {
#pragma unroll 8
    for (int i = tid; i < m * nvp; i += GV_THREADS) {
      const int row = i / nvp, v = i - row * nvp;
      put4<DOT>(xs, p.xrow, row, v, v < nv ? load(row, v) : zero, 0.f);
    }
    __syncthreads();
    return;
  }
  const bool in_regs = nv <= 32 * GV_ROWQ;
  float4 y[GV_ROWQ];
  float mean = 0.f, inv = 1.f;
  if (r < m) {
    if (in_regs) {
#pragma unroll
      for (int q = 0; q < GV_ROWQ; ++q) {
        const int v = lane + 32 * q;
        y[q] = v < nv ? load(r, v) : zero;
      }
    }
    if (p.norm) {
      const float kf = (float)k;
      float s = 0.f;
      if (in_regs) {
#pragma unroll
        for (int q = 0; q < GV_ROWQ; ++q) s += norm_part4(y[q], p.norm);
      } else {
#pragma unroll 8
        for (int v = lane; v < nv; v += 32) s += norm_part4(load(r, v), p.norm);
      }
      norm_stats(p.norm, warp_sum(s), kf, p.eps, mean, inv);
      if (p.norm == 1) {  // layernorm: the variance, from the centred values
        s = 0.f;
        if (in_regs) {
#pragma unroll
          for (int q = 0; q < GV_ROWQ; ++q) {
            if (lane + 32 * q < nv) s += centred_sq4(y[q], mean);
          }
        } else {
#pragma unroll 8
          for (int v = lane; v < nv; v += 32) s += centred_sq4(load(r, v), mean);
        }
        inv = norm_inv(warp_sum(s), kf, p.eps);
      }
    }
  }
  if (r < m) {
    const float4* st = reinterpret_cast<const float4*>(stage);
    // Value v of the row as the dot takes it (before quantization).
    const auto value = [&](float4 x, int v) {
      if (!p.norm) return x;
      const float4 ns = staged ? st[v] : __ldg(reinterpret_cast<const float4*>(p.norm_scale) + v);
      const float4 nb = staged ? (p.norm_bias ? st[nv + v] : zero)
                               : (p.norm_bias ? __ldg(reinterpret_cast<const float4*>(p.norm_bias) + v) : zero);
      return normalize4(x, mean, inv, ns, nb);
    };
    float scale = 1.f;
    if constexpr (DOT == DOT_S8) {  // the absmax (exact in any order), then the codes
      float amax = 0.f;
      if (in_regs) {
#pragma unroll
        for (int q = 0; q < GV_ROWQ; ++q) {
          const int v = lane + 32 * q;
          if (v < nv) {
            y[q] = value(y[q], v);
            amax = fmaxf(amax, absmax4(y[q]));
          }
        }
      } else {
#pragma unroll 8
        for (int v = lane; v < nv; v += 32) amax = fmaxf(amax, absmax4(value(load(r, v), v)));
      }
      scale = row_scale(warp_max(amax));
      if (lane == 0) sx[r] = scale;
      if (in_regs) {
#pragma unroll
        for (int q = 0; q < GV_ROWQ; ++q) {
          const int v = lane + 32 * q;
          if (v < nv) put4<DOT>(xs, p.xrow, r, v, y[q], scale);
        }
      } else {
#pragma unroll 8
        for (int v = lane; v < nv; v += 32) put4<DOT>(xs, p.xrow, r, v, value(load(r, v), v), scale);
      }
    } else {
#pragma unroll
      for (int q = 0; q < GV_ROWQ; ++q) {
        const int v = lane + 32 * q;
        if (in_regs && v < nv) put4<DOT>(xs, p.xrow, r, v, value(y[q], v), 0.f);
      }
      if (!in_regs) {
#pragma unroll 8
        for (int v = lane; v < nv; v += 32) put4<DOT>(xs, p.xrow, r, v, value(load(r, v), v), 0.f);
      }
    }
    for (int v = nv + lane; v < nvp; v += 32) put4<DOT>(xs, p.xrow, r, v, zero, scale);
  }
  __syncthreads();
}

// ---- units: issue, sum, finish ---------------------------------------------

// The block's units: `cnt[p]` of phase p, the jj-th of them unit lo[p] +
// jj * step[p] (step 1: all pieces of the tiles from tlo[p]; step P: piece
// r of each, in a split launch), numbered j = 0, 1, ... through the phases
// in order.
struct GvRange {
  int lo[GV_PHASES];
  int step[GV_PHASES];
  int cnt[GV_PHASES];
  int tlo[GV_PHASES], thi[GV_PHASES];  // the tiles
  int total;
};

struct GvUnit {
  const int8_t* w;
  int n, k, tile, c0, c1, row;
};

// (PH: the launch's phase count, 1 or GV_PHASES, so that every index into
// the block's ranges is known at compile time and they stay in registers.)
template <int PH>
__device__ __forceinline__ GvUnit unit_at(const GvArgs& a, const GvRange& rg, int j) {
  int p = 0, lo = rg.lo[0], step = rg.step[0];
#pragma unroll
  for (int q = 1; q < PH; ++q) {
    if (p == q - 1 && j >= rg.cnt[q - 1]) {
      j -= rg.cnt[q - 1];
      p = q;
      lo = rg.lo[q];
      step = rg.step[q];
    }
  }
  const GvPhase& ph = a.ph[p];
  GvUnit u;
  u.w = ph.w;
  u.n = ph.n;
  u.k = ph.k;
  u.row = ph.row;
  const int pieces = ph.pieces, chunks = gv_chunks(u.k);
  const int id = lo + j * step;
  u.tile = id;
  u.c0 = 0;
  u.c1 = chunks;
  if (pieces > 1) {
    u.tile = id / pieces;
    const int piece = id - u.tile * pieces;
    u.c0 = range_lo(piece, chunks, pieces);
    u.c1 = range_lo(piece + 1, chunks, pieces);
  }
  return u;
}

// Where unit j's weights land: with a slot for every unit of the block,
// packed one after another at their phases' sizes; else slot j % slots of
// the ring (whose slots fit the largest unit).
template <int PH>
__device__ __forceinline__ int unit_offset(const GvArgs& a, const GvRange& rg, int j) {
  if (a.slots < rg.total) return (j % a.slots) * a.slot_bytes;
  int off = 0;
#pragma unroll
  for (int p = 0; p < PH; ++p) {
    const int unit_bytes = GV_TILE * a.ph[p].row;
    if (j < rg.cnt[p]) return off + j * unit_bytes;
    j -= rg.cnt[p];
    off += rg.cnt[p] * unit_bytes;
  }
  return off;  // j == rg.total: the end of the block's units
}

// A warp issues unit j of the block into its slot: lane 0 announces the
// bytes on the unit's barrier and copies an unsplit tile's rows as the one
// contiguous run they are; a split tile's rows (lane r < 16: row r) are
// one copy each.
template <int PH>
__device__ __forceinline__ void issue_unit(const GvArgs& a, const GvRange& rg, int j, uint8_t* ring, uint64_t* full,
                                           int lane) {
  const GvUnit u = unit_at<PH>(a, rg, j);
  const int b0 = u.c0 * GV_CHUNK, b1 = min(u.c1 * GV_CHUNK, u.k);
  const int rows = min(GV_TILE, u.n - u.tile * GV_TILE);
  uint8_t* dst = ring + unit_offset<PH>(a, rg, j);
  const int8_t* src = u.w + (size_t)u.tile * GV_TILE * u.k + b0;
  if (lane == 0) mbar_expect_tx(&full[j], (unsigned)(rows * (b1 - b0)));
  __syncwarp();
  if (b1 - b0 == u.k) {
    if (lane == 0) bulk_load(dst, src, (unsigned)(rows * u.k), &full[j]);
  } else if (lane < rows) {
    bulk_load(dst + lane * u.row, src + (size_t)lane * u.k, (unsigned)(b1 - b0), &full[j]);
  }
}

// The epilogue operands of lane (g, t): the columns tile * 16 + g and + 8,
// the rows 2 t and 2 t + 1.
struct GvEpi {
  float sc[2], bb[2], res[4];
};

__device__ __forceinline__ GvEpi epi_load(const GvPhase& p, int m, int tile, int lane) {
  GvEpi e;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = min(tile * GV_TILE + g + 8 * h, p.n - 1);
    e.sc[h] = __ldg(p.scale + col);
    e.bb[h] = p.bias ? __ldg(p.bias + col) : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 2 * t + i;
      e.res[2 * h + i] = p.residual && r < m ? load_act(p.residual, p.out_bf16, (size_t)r * p.n + col) : 0.f;
    }
  }
  return e;
}

// Accumulator element i of lane (g, t): column g + 8 (i / 2), row 2 t + i % 2.
template <int DOT>
__device__ __forceinline__ void epilogue(const GvPhase& p, int m, int tile, const GvAcc<DOT> (&v)[4], const GvEpi& e,
                                         const float* sx, float (&best)[2], int (&best_i)[2], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int h = i >> 1, r = 2 * t + (i & 1), col = tile * GV_TILE + g + 8 * h;
    if (r >= m || col >= p.n) continue;
    float y;
    if constexpr (DOT == DOT_S8) {
      y = __fmul_rn(__fmul_rn(__int2float_rn(v[i]), sx[r]), e.sc[h]);
    } else {
      y = __fmul_rn(v[i], e.sc[h]);
    }
    if (p.bias) y = y + e.bb[h];
    y = activate(y, p.act);
    if (p.residual) y = y + e.res[i];
    if (p.argmax_n > 0) {
      if (col >= p.argmax_n) y = ARGMAX_MASK;
      if (better(y, col, best[i & 1], best_i[i & 1])) {
        best[i & 1] = y;
        best_i[i & 1] = col;
      }
    } else {
      const size_t o = (size_t)r * p.n + col;
      if (p.out) store_act(p.out, p.out_bf16, o, y);
      if (p.out_f32) p.out_f32[o] = y;
    }
  }
}

// An accumulator as the 16 bytes a lane stores (int sums by their bits),
// and back; the fold of a later sum into it.
__device__ __forceinline__ float4 acc_bits(const float (&v)[4]) { return make_float4(v[0], v[1], v[2], v[3]); }
__device__ __forceinline__ float4 acc_bits(const int (&v)[4]) {
  return make_float4(__int_as_float(v[0]), __int_as_float(v[1]), __int_as_float(v[2]), __int_as_float(v[3]));
}
__device__ __forceinline__ void acc_set(float (&v)[4], const float4& b) {
  v[0] = b.x;
  v[1] = b.y;
  v[2] = b.z;
  v[3] = b.w;
}
__device__ __forceinline__ void acc_set(int (&v)[4], const float4& b) {
  v[0] = __float_as_int(b.x);
  v[1] = __float_as_int(b.y);
  v[2] = __float_as_int(b.z);
  v[3] = __float_as_int(b.w);
}
template <typename T>
__device__ __forceinline__ void acc_add(T (&v)[4], const float4& b) {
  T o[4];
  acc_set(o, b);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] += o[i];
}

// The block's units of phase `pi` (numbered from jbase in the block's
// sequence): team `team` of S warps takes units team, team + 8 / S, ...;
// member `mem` sums its share of the unit's chunks, member 0 adds the
// members' sums in order, reissues the freed slot and finishes the unit:
// the epilogue (P == 1); its piece into the owner's inbox (a split
// launch); or (the MLP's launch, one team) the piece added to the sum
// carried from the tile's earlier pieces, and the epilogue after the last.
template <int DOT, int PH>
__device__ __forceinline__ void run_units(const GvArgs& a, const GvPhase& phase, const GvRange& rg, int pi, int jbase,
                                          uint8_t* ring, uint64_t* full, const uint8_t* xs, float4* team_buf,
                                          float4* inbox, const float* sx, float (&best)[2], int (&best_i)[2]) {
  const GvPhase p = phase;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int S = p.team, shift = __ffs(S) - 1, teams = GV_WARPS >> shift, team = warp >> shift, mem = warp & (S - 1);
  const int chunks = gv_chunks(p.k), P = p.pieces, row = p.row, xrow = p.xrow, m = a.m;
  const int lo = rg.lo[pi], step = rg.step[pi], cnt = rg.cnt[pi], tlo = rg.tlo[pi];
  const int total = rg.total, slots = a.slots, slot_bytes = a.slot_bytes, split = a.split;
  // Where the phase's unit jj lies: slot (jbase + jj) % slots of the ring,
  // or (every unit resident) after the block's units of the earlier phases.
  const bool ringed = slots < total;
  const int packed = ringed ? 0 : unit_offset<PH>(a, rg, jbase), unit_bytes = GV_TILE * row;
  const bool live = g < m;
  GvAcc<DOT> carry[4] = {0, 0, 0, 0};
  int buf = 0;
  for (int jj = team; jj < cnt; jj += teams, buf ^= 1) {
    const int j = jbase + jj, id = lo + jj * step;
    int tile = id, piece = 0, c0 = 0, nc = chunks;
    if (P > 1) {
      tile = id / P;
      piece = id - tile * P;
      c0 = range_lo(piece, chunks, P);
      nc = range_lo(piece + 1, chunks, P) - c0;
    }
    const int m0 = c0 + ((mem * nc) >> shift), m1 = c0 + (((mem + 1) * nc) >> shift);
    GvEpi e{};
    if (mem == 0 && P == 1) e = epi_load(p, m, tile, lane);  // while the weights arrive
    mbar_poll(&full[j]);
    // Two chains, even and odd chunks of the member's share, added at the
    // end: a fixed order, twice the products in flight.
    GvAcc<DOT> acc[4] = {0, 0, 0, 0}, acc2[4] = {0, 0, 0, 0};
    const int off = ringed ? (j % slots) * slot_bytes : packed + jj * unit_bytes;
    const uint8_t* base = ring + off + 16 * t - c0 * GV_CHUNK;
    int c = m0;
    for (; c + 1 < m1; c += 2) {
      dot_chunk<DOT>(acc, base + c * GV_CHUNK, row, xs, xrow, c, g, t, live);
      dot_chunk<DOT>(acc2, base + (c + 1) * GV_CHUNK, row, xs, xrow, c + 1, g, t, live);
    }
    if (c < m1) dot_chunk<DOT>(acc, base + c * GV_CHUNK, row, xs, xrow, c, g, t, live);
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i] += acc2[i];
    if (S > 1) {
      float4* mine = team_buf + (buf * GV_WARPS + warp) * 32 + lane;
      *mine = acc_bits(acc);
      team_sync(1 + team, 32 * S);
      if (mem == 0) {
        for (int s = 1; s < S; ++s) acc_add(acc, mine[32 * s]);
      }
    } else {
      __syncwarp();
    }
    if (mem != 0) continue;
    if (j + slots < total) issue_unit<PH>(a, rg, j + slots, ring, full, lane);
    if (P == 1) {
      epilogue<DOT>(p, m, tile, acc, e, sx, best, best_i, lane);
    } else if (split > 1) {
      const int local = tile - tlo;
      float4* slot = inbox + ((local / P) * P + piece) * 32 + lane;
      *cg::this_cluster().map_shared_rank(slot, local % P) = acc_bits(acc);
    } else {
      if (piece == 0) {
        acc_set(carry, acc_bits(acc));
      } else {
        acc_add(carry, acc_bits(acc));
      }
      if (piece == P - 1) epilogue<DOT>(p, m, tile, carry, epi_load(p, m, tile, lane), sx, best, best_i, lane);
    }
  }
}

// A split launch's end: each warp takes tiles the block owns (the first's
// epilogue operands loaded before the cluster barrier), and after it adds
// their pieces from the inbox in order 0..P-1 and runs the epilogue.
template <int DOT>
__device__ __forceinline__ void finish_split(const GvArgs& a, const GvPhase& p, const GvRange& rg, int rank,
                                             const float4* inbox, const float* sx, float (&best)[2],
                                             int (&best_i)[2]) {
  const GvPhase ph = p;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, P = ph.pieces, m = a.m;
  const int first = rg.tlo[0] + warp * P + rank;
  GvEpi e{};
  if (first < rg.thi[0]) e = epi_load(ph, m, first, lane);
  cg::this_cluster().sync();  // every piece in its owner's inbox
  for (int s = warp;; s += GV_WARPS) {
    const int tile = rg.tlo[0] + s * P + rank;
    if (tile >= rg.thi[0]) break;
    const float4* in = inbox + s * P * 32 + lane;
    GvAcc<DOT> acc[4];
    acc_set(acc, in[0]);
    for (int q = 1; q < P; ++q) acc_add(acc, in[32 * q]);
    epilogue<DOT>(ph, m, tile, acc, s == warp ? e : epi_load(ph, m, tile, lane), sx, best, best_i, lane);
  }
}

// The argmax's end: the block's (max, lowest index) per row into the
// partials; the last block to arrive reduces them and resets the ticket.
__device__ __forceinline__ void argmax_finish(const GvArgs& a, const GvPhase& p, float (&best)[2], int (&best_i)[2]) {
  __shared__ float s_v[GV_WARPS][MAXM];
  __shared__ int s_i[GV_WARPS][MAXM];
  __shared__ int s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, grid = gridDim.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    warp_argmax(best[i], best_i[i], 4);  // lanes of one t: rows 2 t, 2 t + 1
    if (lane < 4) {
      s_v[warp][2 * lane + i] = best[i];
      s_i[warp][2 * lane + i] = best_i[i];
    }
  }
  __syncthreads();
  if ((int)threadIdx.x < a.m) {
    const int r = threadIdx.x;
    float v = s_v[0][r];
    int i = s_i[0][r];
    for (int w = 1; w < GV_WARPS; ++w) {
      if (better(s_v[w][r], s_i[w][r], v, i)) {
        v = s_v[w][r];
        i = s_i[w][r];
      }
    }
    __stcg(a.amax_val + (size_t)r * grid + blockIdx.x, v);
    __stcg(a.amax_idx + (size_t)r * grid + blockIdx.x, i);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(a.amax_ticket, 1) == grid - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  if (threadIdx.x == 0) *a.amax_ticket = 0;  // for the next launch, whatever its grid
  if (warp < a.m) {
    float v = -INFINITY;
    int i = INT_MAX;
#pragma unroll 8
    for (int b = lane; b < grid; b += 32) {
      const float pv = __ldcg(a.amax_val + (size_t)warp * grid + b);
      const int pi = __ldcg(a.amax_idx + (size_t)warp * grid + b);
      if (better(pv, pi, v, i)) {
        v = pv;
        i = pi;
      }
    }
    warp_argmax(v, i);
    if (lane == 0) p.argmax_out[warp] = i;
  }
}

template <int DOT, int PH>
__global__ void __launch_bounds__(GV_THREADS, 2) gemv_kernel(const __grid_constant__ GvArgs params) {
  extern __shared__ __align__(128) uint8_t gv_smem[];
  __shared__ float sx[MAXM];
  // The parameters into shared memory, one word a thread, so that the
  // phases can be indexed at run time (unit_at, unit_offset).
  __shared__ GvArgs a;
  static_assert(sizeof(GvArgs) % 4 == 0 && sizeof(GvArgs) / 4 <= GV_THREADS, "one word a thread");
  if (threadIdx.x < sizeof(GvArgs) / 4) {
    reinterpret_cast<int*>(&a)[threadIdx.x] = reinterpret_cast<const int*>(&params)[threadIdx.x];
  }
  __syncthreads();
  const GvLayout l = gv_layout(a.ring_bytes, a.x_bytes, a.stage_bytes, a.inbox_bytes, a.bars);
  uint8_t* ring = gv_smem;
  uint8_t* xs = gv_smem + l.x;
  float* stage = a.stage_bytes ? reinterpret_cast<float*>(gv_smem + l.stage) : nullptr;
  float4* team_buf = reinterpret_cast<float4*>(gv_smem + l.team);
  float4* inbox = reinterpret_cast<float4*>(gv_smem + l.inbox);
  uint64_t* full = reinterpret_cast<uint64_t*>(gv_smem + l.bars);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // The block's tiles: a range of the grid's share, or (split) of its
  // cluster's, whose rank r sums piece r.
  const int split = a.split;
  int rank = 0, part = blockIdx.x, parts = gridDim.x;
  if (split > 1) {  // the cluster's rank and index (gridDim.x / split clusters along x)
    asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
    asm("mov.u32 %0, %%clusterid.x;" : "=r"(part));
    asm("mov.u32 %0, %%nclusterid.x;" : "=r"(parts));
  }
  GvRange rg;
  rg.total = 0;
#pragma unroll
  for (int p = 0; p < GV_PHASES; ++p) {
    rg.lo[p] = rg.cnt[p] = rg.tlo[p] = rg.thi[p] = 0;
    rg.step[p] = 1;
    if (p < PH && p < a.phases) {
      const int tiles = (a.ph[p].n + GV_TILE - 1) / GV_TILE, P = a.ph[p].pieces;
      rg.tlo[p] = range_lo(part, tiles, parts);
      rg.thi[p] = range_lo(part + 1, tiles, parts);
      if (split > 1) {
        rg.lo[p] = rg.tlo[p] * P + rank;
        rg.step[p] = P;
        rg.cnt[p] = rg.thi[p] - rg.tlo[p];
      } else {
        rg.lo[p] = rg.tlo[p] * P;
        rg.cnt[p] = (rg.thi[p] - rg.tlo[p]) * P;
      }
      rg.total += rg.cnt[p];
    }
  }
  if (rg.total > a.bars || unit_offset<PH>(a, rg, rg.total) > a.ring_bytes) __trap();  // the plan is wrong
  for (int j = threadIdx.x; j < rg.total; j += GV_THREADS) mbar_init(&full[j], 1);
  mbar_init_fence();
  __syncthreads();
  // Every phase's first weights in flight before any read of x.
  for (int j = warp; j < min(rg.total, a.slots); j += GV_WARPS) issue_unit<PH>(a, rg, j, ring, full, lane);
  // Then the first phase's x (and norm vectors), read by the prologue.
  if (rg.cnt[0] > 0 && stage && gv_stage_need(a.ph[0], a.m) <= a.stage_bytes) gv_stage_issue(a.ph[0], a.m, stage);

  float best[2] = {-INFINITY, -INFINITY};
  int best_i[2] = {INT_MAX, INT_MAX};
  int jbase = 0;
#pragma unroll 1  // the MLP's phases in a loop: unrolled, its registers spill
  for (int p = 0; p < PH; ++p) {
    if (p >= a.phases) break;
    const GvPhase& ph = a.ph[p];
    if (rg.cnt[p] > 0) {
      gv_prologue<DOT>(ph, a.m, xs, gv_stage_need(ph, a.m) <= a.stage_bytes ? stage : nullptr, sx, p == 0);
      run_units<DOT, PH>(a, ph, rg, p, jbase, ring, full, xs, team_buf, inbox, sx, best, best_i);
    }
    if (split > 1) finish_split<DOT>(a, ph, rg, rank, inbox, sx, best, best_i);
    if (ph.argmax_n > 0) argmax_finish(a, ph, best, best_i);
    jbase += rg.cnt[p];
    if (p + 1 < a.phases) cg::this_grid().sync();  // the next phase reads this one's output
  }
}

// ---- host side ----------------------------------------------------------------

// The plan's ints (quant_matmul.py GemvPlan.ints): grid, slots, slot_bytes,
// ring_bytes, x_bytes, stage_bytes, bars, smem, coop, split, inbox_bytes,
// then for each phase pieces, team, row, xrow.
constexpr int GV_PLAN_HEAD = 11;
constexpr int GV_PLAN_PHASE = 4;

// Bytes of a row of the dot operand a phase needs in shared memory.
inline int gv_xrow_min(int dot, int k) {
  const int chunks = gv_chunks(k);
  return dot == DOT_S8 ? chunks * GV_CHUNK : dot == DOT_BF16 ? 2 * chunks * GV_CHUNK : 4 * chunks * GV_CHUNK;
}

// Fill the plan and the scratch into `a` (whose phases are set), checking
// what the kernel relies on; cudaErrorInvalidValue for anything else.
inline cudaError_t gv_apply_plan(GvArgs& a, int dot, const int* plan, int* work, int& grid, int& smem, int& coop) {
  const auto mis = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) != 0; };
  grid = plan[0];
  a.slots = plan[1];
  a.slot_bytes = plan[2];
  a.ring_bytes = plan[3];
  a.x_bytes = plan[4];
  a.stage_bytes = plan[5];
  a.bars = plan[6];
  smem = plan[7];
  coop = plan[8];
  a.split = plan[9];
  a.inbox_bytes = plan[10];
  if (a.m < 1 || a.m > MAXM || a.phases < 1 || a.phases > GV_PHASES || (a.phases > 1 && !coop) || grid < 1 ||
      grid > GV_MAX_GRID || a.slots < 1 || a.slot_bytes % 128 || a.ring_bytes % 128 ||
      a.ring_bytes < a.slot_bytes || work == nullptr || mis(work) || a.split < 1 || a.split > GV_MAX_SPLIT ||
      grid % a.split || (a.split > 1 && (coop || a.phases > 1)) || a.inbox_bytes < 0 || a.inbox_bytes % 128) {
    return cudaErrorInvalidValue;
  }
  a.amax_ticket = work;
  a.amax_val = reinterpret_cast<float*>(work + GV_WORK_ARGMAX);
  a.amax_idx = work + GV_WORK_ARGMAX + MAXM * GV_MAX_GRID;
  const int parts = grid / a.split;
  int most = 0;  // a bound on any block's units
  for (int p = 0; p < a.phases; ++p) {
    GvPhase& ph = a.ph[p];
    const int* q = plan + GV_PLAN_HEAD + GV_PLAN_PHASE * p;
    ph.pieces = q[0];
    ph.team = q[1];
    ph.row = q[2];
    ph.xrow = q[3];
    const int chunks = gv_chunks(ph.k), tiles = (ph.n + GV_TILE - 1) / GV_TILE;
    const int block_tiles = (tiles + parts - 1) / parts;
    const int longest = ph.pieces == 1 ? ph.k : (chunks + ph.pieces - 1) / ph.pieces * GV_CHUNK;
    if (ph.n < 1 || ph.k < 16 || ph.k % 16 || mis(ph.x) || mis(ph.w) || (ph.norm && mis(ph.norm_scale)) ||
        (ph.norm_bias && mis(ph.norm_bias)) || ph.pieces < 1 || ph.pieces > chunks ||
        // a split: clusters of P blocks, each owner's inbox holding its tiles' pieces; else one team of 8
        // warps runs a block's pieces of a tile in order
        (a.split > 1 ? ph.pieces != a.split || parts > tiles ||
                           a.inbox_bytes < (block_tiles + a.split - 1) / a.split * a.split * GV_PIECE_BYTES
                     : ph.pieces > 1 && ph.team != GV_WARPS) ||
        (ph.team != 1 && ph.team != 2 && ph.team != 4 && ph.team != 8) || ph.row < longest || ph.row % 16 ||
        GV_TILE * ph.row > a.slot_bytes || ph.xrow < gv_xrow_min(dot, ph.k) || ph.xrow % 16 ||
        a.x_bytes < a.m * ph.xrow || a.stage_bytes % 16 ||
        (ph.argmax_n > 0 && (a.phases > 1 || ph.argmax_out == nullptr))) {
      return cudaErrorInvalidValue;
    }
    most += a.split > 1 ? block_tiles : block_tiles * ph.pieces;
  }
  const GvLayout l = gv_layout(a.ring_bytes, a.x_bytes, a.stage_bytes, a.inbox_bytes, a.bars);
  if (a.bars < most || l.total != smem || (size_t)smem > MAX_SMEM) return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <int DOT, int PH>
cudaError_t gv_launch_t(const GvArgs& a, int grid, int smem, int coop, cudaStream_t st) {
  // The dynamic limit set to what this launch needs, from the first launch
  // on: the kernel's static shared memory counts against the same limit.
  static int smem_set = 0;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(gemv_kernel<DOT, PH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  if (coop) {  // the grid barriers need every block resident; the launch refuses otherwise
    void* args[] = {const_cast<GvArgs*>(&a)};
    return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(gemv_kernel<DOT, PH>), dim3(grid),
                                       dim3(GV_THREADS), args, (size_t)smem, st);
  }
  return launch_clustered(gemv_kernel<DOT, PH>, dim3(grid), GV_THREADS, smem, a.split, st, a);
}

// The dot of a launch: w8a8 -> s8 codes, else bf16 when the activations are
// bf16 (or rounded to it), else f32.
inline cudaError_t launch_gemv(GvArgs& a, int dot, const int* plan, int* work, cudaStream_t st) {
  int grid = 0, smem = 0, coop = 0;
  const cudaError_t e = gv_apply_plan(a, dot, plan, work, grid, smem, coop);
  if (e != cudaSuccess) return e;
  // One phase (a GEMV of its own) or up to GV_PHASES (the MLP).
  if (a.phases == 1) {
    if (dot == DOT_S8) return gv_launch_t<DOT_S8, 1>(a, grid, smem, coop, st);
    if (dot == DOT_BF16) return gv_launch_t<DOT_BF16, 1>(a, grid, smem, coop, st);
    return gv_launch_t<DOT_F32, 1>(a, grid, smem, coop, st);
  }
  if (dot == DOT_S8) return gv_launch_t<DOT_S8, GV_PHASES>(a, grid, smem, coop, st);
  if (dot == DOT_BF16) return gv_launch_t<DOT_BF16, GV_PHASES>(a, grid, smem, coop, st);
  return gv_launch_t<DOT_F32, GV_PHASES>(a, grid, smem, coop, st);
}

}  // namespace
}  // namespace rt
