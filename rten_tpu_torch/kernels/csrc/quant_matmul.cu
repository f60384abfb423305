// quant_matmul_int8: the prefill matmul, M > 8 rows of activations against
// an int8 weight matrix with per-output-channel f32 scales, and the scale /
// bias / activation epilogue applied once, after the whole K sum:
//
//     out = activation((x @ W) * scale + bias)
//
// Replaces rten_tpu/kernels/quant_matmul.py quant_matmul_int8 (:590; Pallas
// kernel _q_kernel :556, epilogue _q_epilogue :532). On the prefill path it
// computes every layer's qkv, wo, up (+ GELU) and down projection, and the
// lm_head when all logits are asked for.
//
// Bound on the H100: the weights alone carry 2 * M operations per byte, so
// from M ~ 150 rows on (more for a narrow N, where the activations' bytes
// weigh too) the products outrun the ~295 bf16 operations per byte that
// memory can feed, and the tensor cores bound it; at M = 64 the weight
// stream (1 byte per weight) does. f32 activations take three bf16 passes
// for exact products: 3 x 2 M N K operations on the bf16 tensor cores
// against the x tile's 4 bytes a value, so the products bind from ~50
// rows on.
//
// What the first design (64 x 128 tiles on mma.sync, tile_mma.cuh)
// lost time on: one register stage, so every 32-deep K step waited out a
// device-memory latency (~0.9 us a step whatever the block count); at M 64
// the down and wo projections had 6 output tiles for 132 SMs and down ran
// its 96 steps in series; and every int8 weight became bf16 one element at
// a time while it was staged.
//
// bf16 activations (the main path), qmm_wgmma_kernel:
// - Swap-AB on wgmma: the kernel computes out^T = W . x^T, so the weight
//   tile is wgmma's A operand, taken from registers, and the activations
//   are B from shared memory, the tokens wgmma's N: 64 tokens a block up to
//   M = 64 (ragged M 9-64 wastes tensor-core time, not bytes), else 128.
//   A block has one consumer warpgroup (64 output channels) per 64 tokens,
//   so a 128 x 128 block reads each x tile once for two warpgroups. The
//   per-channel scale and bias become per-row of the accumulator.
// - A ring of QW_STAGES stages of 128 K each, filled by TMA: one producer
//   warp waits for a free stage, announces its bytes on the stage's "full"
//   mbarrier and issues three box loads (the int8 W tile, BN x 128 bytes,
//   and two 128-byte-wide halves of the x tile), all with the 128-byte
//   swizzle. The consumers wait on "full", turn the stage's W bytes into
//   bf16 A fragments in registers (a byte permute into the mantissa and one
//   subtraction a value, i8x2_to_bf16x2) while the previous stage's 8
//   wgmma m64nTOKk16 run, then release that stage on its "empty" mbarrier.
//   TMA zero-fills the ragged M, N and K edges, so nothing is masked in the
//   loop.
// - Split-K for few output tiles: the host (quant_matmul.py matmul_plan)
//   sets a cluster of C blocks (C <= 8) along K where the output tiles
//   alone would leave most SMs idle. Rank r takes K steps [r S / C,
//   (r + 1) S / C) of S. Every rank writes its f32 sums to its own shared
//   memory as a [TOK][BN] tile; after a cluster barrier, rank r sums a 1/C
//   slice of the tile, four channels at a time, over ranks 0..C-1 in that
//   order through distributed shared memory (the same bits on every
//   launch: no atomics) and runs the epilogue once on the whole sum: acc *
//   scale, + bias, activation, rounded once to the output dtype, stored
//   four channels a thread, neighbouring threads on neighbouring channels.
//
// f32 activations (the encoders' and the graph runtime's route),
// qmm_f32_kernel: the same swap-AB wgmma on the same ring, with products
// as exact as f32 FMA on the CUDA cores (the first design's SIMT loop, 84x
// its bound at the GPT-2 graph's mlp c_proj):
// - Exact products in three bf16 passes. Each f32 activation splits as
//   x = hi + mid + lo, three bf16: hi = x cut to bf16's 8 significant bits,
//   mid = the remainder x - hi (exact) cut the same way, lo = what is left
//   (exact: at most 8 significant bits remain). Truncation rather than
//   rounding: no value near f32's maximum overflows, and a part costs two
//   instructions. An int8 weight is exact in bf16 and a bf16 x bf16
//   product exact in f32, so W.hi + W.mid + W.lo has the exact products of
//   x.W. Where |x| is under
//   2^-110, lo (under 2^-118, mid) falls below bf16's normal range: rounded
//   to its subnormal grid, or flushed by the tensor cores, an error under
//   2^-118 a product. An infinite x gives hi = x and mid = lo = 0, so the
//   products are IEEE's; NaN stays NaN.
// - The sums. The tensor cores' f32 accumulation does not round each
//   addition to nearest as an FMA does: one accumulator over a K of 3072
//   (576 wgmma) drifted to 3.7e-5 of the largest output from the f64
//   product on all-positive inputs, 10x the first design's FMA loop
//   (PERF.md, section 6). So each stage's 24 wgmma accumulate into a register
//   tile that starts at zero, and the stage's tile is added into the
//   running f32 sums on the CUDA cores once the group retires: the tensor
//   cores' drift is that of a K of 128, and the products stay exact.
// - A block is 64 tokens (wgmma N 64) by 64 or 128 output channels: one
//   or two consumer warpgroups and one producer warp. A ring stage is the
//   f32 x tile ([64][128], four 128-byte-swizzled TMA boxes of 32 K, 32 KB)
//   and the int8 W tile ([BN][128]). The consumers split the stage's x
//   into three bf16 B tiles (hi, mid, lo) in the bf16 route's B layout and
//   swizzle, into one of two split sets, turn its W into bf16 A fragments
//   in registers (i8x2_to_bf16x2, as the bf16 route) and release the
//   stage; 24 wgmma (8 k16 steps x 3 parts) run on the fragments while the
//   next stage's x splits into the other set, and that stage's W converts
//   once they retire (one fragment set: with two, a 288-thread block,
//   capped at 168 registers a thread, spilled ~300 bytes). One consumer
//   barrier a stage publishes the split writes to the tensor cores (after
//   fence.proxy.async) and frees the set of the stage before. A stage past
//   K (the last, or a K under 128 such as MobileNetV2's 16 and 24) splits
//   and multiplies only its k16 steps that hold some of K.
// - Shared memory: the ring holds 4 + 1 bytes a K element of a token and
//   channel, a split set 3 x 2 more. Three layouts (QfLayout): 64 channels,
//   3 stages (222,256 bytes) up to 64 rows, where the weights' bytes bound
//   the call and more blocks fill the card; 128 channels, 2 stages
//   (197,664) above, where each split x tile then serves twice the
//   channels (1.5x faster at DistilBERT's M 3072 than 64); and a one-stage,
//   one-set block of 64 channels (91,152) for a single K step, two to an
//   SM, so that one block's loads and epilogue run under the other's work.
// - Split-K across a cluster (quant_matmul.py f32_plan, its capacity
//   queried like the bf16 block's) and the same fixed-order DSMEM sum and
//   epilogue.
// A K of 8 mod 16 (MobileNetV2's expand convs of K 24): TMA cannot address
// weight rows whose stride is not a multiple of 16 bytes, so both kernels
// (CPW) have the producer warp bring the W tile by cp.async in 8-byte
// pieces into the same swizzled stage layout, zero past K and N, each lane
// arriving on the stage's mbarrier when its pieces land
// (cp.async.mbarrier.arrive.noinc); x still comes by TMA (its rows are
// 16-byte multiples). bf16 activations at such a K run the bf16 kernel's
// one pass.

#include <cooperative_groups.h>

#include "hopper.cuh"
#include "tile_mma.cuh"  // pack_bf16x2, split3_pair

namespace rt {
namespace {

namespace cg = cooperative_groups;

struct QmArgs {
  const void* x;       // [m, k] f32 or bf16, 16-byte aligned, k % 8 == 0
  int m, n, k;
  const int8_t* w;     // [n, k] int8 (int8_pack), 16-byte aligned
  const float* scale;  // [n]
  const float* bias;   // [n] or null
  int act;             // activations.py ACTIVATION_CODES (common.cuh activate)
  void* out;           // [m, n] f32 or bf16 (out_bf16)
  int out_bf16;
};

__device__ __forceinline__ void col_params(const QmArgs& a, int col, float& s, float& b) {
  s = col < a.n ? __ldg(a.scale + col) : 0.f;
  b = (a.bias && col < a.n) ? __ldg(a.bias + col) : 0.f;
}

constexpr int QW_BK = 128;        // K of a stage: one 128-byte swizzled row of W
constexpr int QW_STAGES = 4;
constexpr int QW_MAX_CLUSTER = 8;  // quant_matmul.py MAX_SPLIT

// A block of TOK tokens has TOK / 64 consumer warpgroups, each owning 64
// output channels (the wgmma M), and one producer warp.
template <int TOK>
struct QwLayout {
  static constexpr int WGS = TOK / 64;                   // consumer warpgroups
  static constexpr int BN = 64 * WGS;                    // output channels a block
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int THREADS = CONSUMERS + 32;
  static constexpr int X_BYTES = TOK * QW_BK * 2;        // two [TOK][64] bf16 boxes
  static constexpr int W_BYTES = BN * QW_BK;             // [BN][128] int8
  static constexpr int STAGE = X_BYTES + W_BYTES;        // a multiple of 1024
  static constexpr int RING = QW_STAGES * STAGE;
  static constexpr int SMEM = RING + 2 * QW_STAGES * 8 + 1024;  // + mbarriers + alignment slack
  static constexpr int LDR = BN + 4;                     // f32 row stride of the [TOK][BN] sums
  static_assert(TOK * LDR * 4 <= RING, "the sums reuse the ring");
};

template <int TOK>
__device__ __forceinline__ void wgmma_rs(float (&d)[TOK / 2], const uint32_t (&a)[4], uint64_t desc);
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  wgmma_rs_n64(d, a, desc);
}
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  wgmma_rs_n128(d, a, desc);
}

// The k pair (2t, 2t + 1) (hi: (8 + 2t, 9 + 2t)) of a 16-byte K chunk of W
// in the low 16 bits: one byte permute, whose selector `sel` = 2t | (2t +
// 1) << 4 picks the pair out of the chunk's low (high) 8 bytes.
__device__ __forceinline__ uint32_t w_pair(const uint4& c, unsigned sel, bool hi) {
  return hi ? __byte_perm(c.z, c.w, sel) : __byte_perm(c.x, c.y, sel);
}

__device__ __forceinline__ float4 operator+(const float4& x, const float4& y) {
  return make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
}

// Four neighbouring outputs (row, col .. col + 3) of the [m, n] output; the
// ragged N edge is stored one by one.
__device__ __forceinline__ void store_out4(const QmArgs& a, int row, int col, const float (&v)[4]) {
  const size_t o = (size_t)row * a.n + col;
  if (col + 3 < a.n && (a.n & 3) == 0) {
    if (a.out_bf16) {
      uint2 w;
      w.x = pack_bf16x2(v[0], v[1]);
      w.y = pack_bf16x2(v[2], v[3]);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(a.out) + o) = w;
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(a.out) + o) = make_float4(v[0], v[1], v[2], v[3]);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (col + j < a.n) store_act(a.out, a.out_bf16, o + j, v[j]);
}

// The W tile of K step k0 ([ROWS][128] int8, rows n0 on) into a stage in
// the layout TMA's 128-byte swizzle gives it, by the 32 lanes of the
// producer warp in 8-byte cp.async pieces, zero past K and N, for weight
// rows TMA cannot address (K of 8 mod 16: 8-byte aligned rows); each lane
// then arrives on `bar` once its pieces have landed.
template <int ROWS>
__device__ __forceinline__ void w_tile_cp_async(unsigned char* dst, const QmArgs& a, int n0, int k0, uint64_t* bar,
                                                int lane) {
  for (int p = lane; p < ROWS * (QW_BK / 8); p += 32) {
    const int r = p >> 4, h = p & 15;  // row, 8-byte piece
    const int k = k0 + 8 * h;
    const bool ok = n0 + r < a.n && k < a.k;
    const int8_t* src = ok ? a.w + (size_t)(n0 + r) * a.k + k : a.w;
    cp_async8(dst + r * QW_BK + (((h >> 1) ^ (r & 7)) << 4) + (h & 1) * 8, src, ok);
  }
  cp_async_mbar_arrive(bar);
}

// Consumer thread (warp, g, t)'s W rows r_lo and r_lo + 8 of a stage's
// 128-byte-swizzled [BN][128] int8 tile as the bf16 A fragments of the 8
// k16 steps (the mma.sync m16n8k16 layout).
__device__ __forceinline__ void w_fragments(const unsigned char* ws, int r_lo, int g, unsigned sel,
                                            uint32_t (&fa)[8][4]) {
#pragma unroll
  for (int s = 0; s < 8; ++s) {  // K chunk s (16 bytes) of rows r_lo, r_lo + 8, swizzled to s ^ g
    const uint4 lo = *reinterpret_cast<const uint4*>(ws + r_lo * QW_BK + ((s ^ g) << 4));
    const uint4 hi = *reinterpret_cast<const uint4*>(ws + (r_lo + 8) * QW_BK + ((s ^ g) << 4));
    fa[s][0] = i8x2_to_bf16x2(w_pair(lo, sel, false));
    fa[s][1] = i8x2_to_bf16x2(w_pair(hi, sel, false));
    fa[s][2] = i8x2_to_bf16x2(w_pair(lo, sel, true));
    fa[s][3] = i8x2_to_bf16x2(w_pair(hi, sel, true));
  }
}

// The block's sums as [tokens][LDR] f32 in shared memory: element e of
// consumer thread (r_lo, t) is channel r_lo + 8 ((e / 2) % 2), token
// 8 (e / 4) + 2 t + e % 2.
template <int NACC, int LDR>
__device__ __forceinline__ void stash_sums(float* red, const float (&acc)[NACC], int r_lo, int t) {
#pragma unroll
  for (int e = 0; e < NACC; ++e) {
    red[(8 * (e >> 2) + 2 * t + (e & 1)) * LDR + r_lo + 8 * ((e >> 1) & 1)] = acc[e];
  }
}

// After the cluster barrier that follows stash_sums: rank r takes tokens
// [r TOK / C, (r + 1) TOK / C) of the tile. A thread keeps one
// four-channel piece (its scales and biases read once) over every
// THREADS / (BN / 4)-th token of the slice; each piece is summed over
// ranks 0..C-1 in that order (every rank's load in flight first), then the
// epilogue runs on the whole sum: acc * scale, + bias, activation, rounded
// once to the output dtype.
template <int TOK, int BN, int THREADS, int LDR>
__device__ __forceinline__ void split_k_epilogue(const QmArgs& a, cg::cluster_group& cluster, const float* red,
                                                 int n_split, int rank, int n0, int m0) {
  constexpr int QUADS = BN / 4, ROWS = THREADS / QUADS;
  static_assert(THREADS % QUADS == 0, "a thread keeps its channels");
  const int tid = threadIdx.x;
  const int ch = (tid % QUADS) * 4, col = n0 + ch;
  float sc[4], bi[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) col_params(a, col + j, sc[j], bi[j]);
  const int t_end = (rank + 1) * TOK / n_split;
#pragma unroll 2
  for (int tok = rank * TOK / n_split + tid / QUADS; tok < t_end; tok += ROWS) {
    const float* piece = red + tok * LDR + ch;
    float4 sum;
    if (n_split == 1) {
      sum = *reinterpret_cast<const float4*>(piece);
    } else {
      float4 part[QW_MAX_CLUSTER];
#pragma unroll
      for (int q = 0; q < QW_MAX_CLUSTER; ++q) {
        if (q < n_split) part[q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(piece, q));
      }
      sum = part[0];
#pragma unroll
      for (int q = 1; q < QW_MAX_CLUSTER; ++q) {
        if (q < n_split) sum = sum + part[q];
      }
    }
    const int row = m0 + tok;
    if (row >= a.m || col >= a.n) continue;
    const float o[4] = {activate(sum.x * sc[0] + bi[0], a.act), activate(sum.y * sc[1] + bi[1], a.act),
                        activate(sum.z * sc[2] + bi[2], a.act), activate(sum.w * sc[3] + bi[3], a.act)};
    store_out4(a, row, col, o);
  }
}

// CPW: the W tile by the producer warp's cp.async (a K of 8 mod 16), else TMA.
template <int TOK, bool CPW>
__global__ void __launch_bounds__(QwLayout<TOK>::THREADS) qmm_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w, QmArgs a) {
  using L = QwLayout<TOK>;
  extern __shared__ unsigned char qw_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(qw_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::RING);
  uint64_t* empty = full + QW_STAGES;

  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = (blockIdx.x / n_split) * L::BN, m0 = blockIdx.y * TOK;
  const int steps = (a.k + QW_BK - 1) / QW_BK;
  const int s_begin = rank * steps / n_split, s_end = (rank + 1) * steps / n_split;
  const int n_steps = s_end - s_begin;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < QW_STAGES; ++s) {
      mbar_init(&full[s], CPW ? 33 : 1);  // CPW: the TMA's arrival and each lane's cp.async one
      mbar_init(&empty[s], L::CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  float acc[TOK / 2];
#pragma unroll
  for (int i = 0; i < TOK / 2; ++i) acc[i] = 0.f;
  // Consumer thread (warp, g = lane / 4, t = lane % 4) holds W rows r_lo and
  // r_lo + 8 of its warpgroup's A fragment (the mma.sync m16n8k16 layout).
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = warp * 16 + g;
  const unsigned sel = (2 * t) | ((2 * t + 1) << 4);

  if (warp == L::CONSUMERS / 32) {
    // Producer: one thread keeps up to QW_STAGES stages of loads in flight
    // (CPW: the whole warp, for the W pieces).
    if (CPW || lane == 0) {
      for (int i = 0; i < n_steps; ++i) {
        const int st = i % QW_STAGES;
        mbar_wait(&empty[st], ((i / QW_STAGES) & 1) ^ 1);
        unsigned char* stage = smem + st * L::STAGE;
        const int k0 = (s_begin + i) * QW_BK;
        if (lane == 0) {
          mbar_expect_tx(&full[st], CPW ? L::X_BYTES : L::STAGE);
          tma_load_2d(stage, &tm_x, k0, m0, &full[st]);
          tma_load_2d(stage + L::X_BYTES / 2, &tm_x, k0 + QW_BK / 2, m0, &full[st]);
          if (!CPW) tma_load_2d(stage + L::X_BYTES, &tm_w, k0, n0, &full[st]);
        }
        if (CPW) w_tile_cp_async<L::BN>(stage + L::X_BYTES, a, n0, k0, &full[st], lane);
      }
    }
  } else {
    // Consumers: stage i's W bytes become bf16 A fragments while stage
    // i - 1's 8 wgmma run (two fragment sets, alternating).
    auto convert = [&](int i, uint32_t (&fa)[8][4]) {
      const int st = i % QW_STAGES;
      mbar_wait(&full[st], (i / QW_STAGES) & 1);
      w_fragments(smem + st * L::STAGE + L::X_BYTES, r_lo, g, sel, fa);
    };
    auto issue = [&](int i, uint32_t (&fa)[8][4]) {
      const unsigned char* xs = smem + (i % QW_STAGES) * L::STAGE;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        wgmma_rs<TOK>(acc, fa[s], sw128_desc(xs + (s >> 2) * (L::X_BYTES / 2)) + (s & 3) * 2);
      }
      wgmma_commit();
    };
    // Retire stage i once its group is done: keep its fragments and the
    // sums in place until then, and hand the stage back to the producer.
    auto retire = [&](int i, uint32_t (&fa)[8][4]) {
      wgmma_wait<0>();
#pragma unroll
      for (int s = 0; s < 8; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) reg_fence(fa[s][e]);
#pragma unroll
      for (int e = 0; e < TOK / 2; ++e) reg_fence(acc[e]);
      mbar_arrive(&empty[i % QW_STAGES]);
    };
    // Two fragment sets alternate: stage i + 1 converts while stage i's
    // group runs. (Keeping one group in flight across stages instead, so
    // that the next group is issued before this one retires, measured 3-12%
    // slower at every shape: PERF.md.)
    uint32_t fa0[8][4], fa1[8][4];
    if (n_steps > 0) convert(0, fa0);
    for (int i = 0; i < n_steps; i += 2) {
      issue(i, fa0);
      if (i + 1 < n_steps) convert(i + 1, fa1);
      retire(i, fa0);
      if (i + 1 < n_steps) {
        issue(i + 1, fa1);
        if (i + 2 < n_steps) convert(i + 2, fa0);
        retire(i + 1, fa1);
      }
    }
  }

  // The block's sums as [TOK][BN] f32 in the (now free) ring, summed
  // across the cluster in rank order, then the epilogue.
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  if (tid < L::CONSUMERS) stash_sums<TOK / 2, L::LDR>(red, acc, r_lo, t);
  cluster.sync();
  split_k_epilogue<TOK, L::BN, L::THREADS, L::LDR>(a, cluster, red, n_split, rank, n0, m0);
  cluster.sync();  // no block leaves while another reads its shared memory
}

// ---- f32 activations: exact products in three bf16 passes -------------------

constexpr int QF_TOK = 64;  // tokens a block: wgmma's N

// The f32 block: WGS consumer warpgroups of 64 output channels each and
// one producer warp, a ring of STAGES stages, SETS split sets. Three
// layouts (quant_matmul.py f32_plan picks the channels, the entry point
// the rest): 64 channels, 3 stages, 2 sets (222,256 bytes: up to 64 rows,
// where more blocks fill the card); 128 channels, 2 stages, 2 sets
// (197,664 bytes: more rows, where the split x tile serves twice the
// channels); and for one K step (K <= 128) 64 channels, 1 stage, 1 set
// (91,152 bytes), so that two blocks share an SM and one's loads and
// epilogue run under the other's products.
template <int WGS, int STAGES, int SETS>
struct QfLayout {
  static constexpr int BN = 64 * WGS;                   // output channels a block
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int THREADS = CONSUMERS + 32;
  static constexpr int BOX = QF_TOK * 128;              // one 128-byte-wide TMA box of a tile: 8 KB
  static constexpr int X_BYTES = 4 * BOX;               // [64][128] f32: four boxes of 32 K
  static constexpr int STAGE = X_BYTES + BN * QW_BK;    // + [BN][128] int8 W: a multiple of 1024
  static constexpr int RING = STAGES * STAGE;
  static constexpr int PART = 2 * BOX;                  // one bf16 B tile [64][128]: two boxes of 64 K
  static constexpr int SET = 3 * PART;                  // hi, mid, lo
  static constexpr int SMEM = RING + SETS * SET + 2 * STAGES * 8 + 1024;  // + mbarriers + alignment slack
  static constexpr int LDR = BN + 4;                    // f32 row stride of the [TOK][BN] sums
  static_assert(QF_TOK * LDR * 4 <= RING, "the sums reuse the ring");
  static_assert(SMEM <= (int)MAX_SMEM, "a block's shared memory");
};

// A stage's f32 x tile (`xs`) into split set `set`: three bf16 B tiles (hi,
// mid, lo) in the bf16 route's layout, the K groups of 8 below `groups`.
// Unit u is token u % 64 and K group u / 64: two 16-byte chunks of an f32
// box row in, one 16-byte chunk of a bf16 box row out for each part; the
// eight lanes of a quarter warp take eight tokens, so the swizzle puts
// their chunks in distinct banks on both sides.
template <int CONSUMERS>
__device__ __forceinline__ void split_x(const unsigned char* xs, unsigned char* set, int groups, int ctid) {
  constexpr int BOX = QF_TOK * 128, PART = 2 * BOX;
#pragma unroll 2
  for (int u = ctid; u < QF_TOK * groups; u += CONSUMERS) {
    const int r = u & (QF_TOK - 1), kg = u / QF_TOK, sw = r & 7;
    const unsigned char* src = xs + (kg >> 2) * BOX + r * 128;
    const float4 v0 = *reinterpret_cast<const float4*>(src + ((((kg & 3) * 2) ^ sw) << 4));
    const float4 v1 = *reinterpret_cast<const float4*>(src + ((((kg & 3) * 2 + 1) ^ sw) << 4));
    const float f[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
    uint32_t hi[4], mid[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split3_pair(f[2 * j], f[2 * j + 1], hi[j], mid[j], lo[j]);
    const int off = (kg >> 3) * BOX + r * 128 + (((kg & 7) ^ sw) << 4);
    *reinterpret_cast<uint4*>(set + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(set + PART + off) = make_uint4(mid[0], mid[1], mid[2], mid[3]);
    *reinterpret_cast<uint4*>(set + 2 * PART + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// The consumer warpgroups' barrier (named barrier 1; the producer warp
// does not take part), after which the split writes before it are visible
// to the tensor cores.
template <int CONSUMERS>
__device__ __forceinline__ void consumers_sync() {
  fence_proxy_async();
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// CPW: the W tile by the producer warp's cp.async (a K of 8 mod 16), else TMA.
template <int WGS, int STAGES, int SETS, bool CPW>
__global__ void __launch_bounds__(QfLayout<WGS, STAGES, SETS>::THREADS) qmm_f32_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w, QmArgs a) {
  using L = QfLayout<WGS, STAGES, SETS>;
  extern __shared__ unsigned char qf_raw[];
  unsigned char* smem = smem_align(qf_raw);
  unsigned char* sets = smem + L::RING;
  uint64_t* full = reinterpret_cast<uint64_t*>(sets + SETS * L::SET);
  uint64_t* empty = full + STAGES;

  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = (blockIdx.x / n_split) * L::BN, m0 = blockIdx.y * QF_TOK;
  const int steps = (a.k + QW_BK - 1) / QW_BK;
  const int s_begin = rank * steps / n_split, s_end = (rank + 1) * steps / n_split;
  const int n_steps = s_end - s_begin;  // SETS 1: one step (the entry point's rule)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], CPW ? 33 : 1);  // CPW: the TMA's arrival and each lane's cp.async one
      mbar_init(&empty[s], L::CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // acc: the wgmma tile of one stage; sum: the running sums, on the CUDA cores.
  float acc[QF_TOK / 2], sum[QF_TOK / 2];
#pragma unroll
  for (int i = 0; i < QF_TOK / 2; ++i) acc[i] = sum[i] = 0.f;
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = warp * 16 + g;
  const unsigned sel = (2 * t) | ((2 * t + 1) << 4);

  if (warp == L::CONSUMERS / 32) {
    // Producer: the x boxes (and W) of up to STAGES steps in flight.
    if (CPW || lane == 0) {
      for (int i = 0; i < n_steps; ++i) {
        const int st = i % STAGES;
        mbar_wait(&empty[st], ((i / STAGES) & 1) ^ 1);
        unsigned char* stage = smem + st * L::STAGE;
        const int k0 = (s_begin + i) * QW_BK;
        if (lane == 0) {
          // Only the x boxes that hold some of K (a box's bytes count in
          // full, its part past K zero-filled).
          const int boxes = min(4, (a.k - k0 + 31) / 32);
          mbar_expect_tx(&full[st], boxes * L::BOX + (CPW ? 0 : L::STAGE - L::X_BYTES));
          for (int j = 0; j < boxes; ++j) tma_load_2d(stage + j * L::BOX, &tm_x, k0 + 32 * j, m0, &full[st]);
          if (!CPW) tma_load_2d(stage + L::X_BYTES, &tm_w, k0, n0, &full[st]);
        }
        if (CPW) w_tile_cp_async<L::BN>(stage + L::X_BYTES, a, n0, k0, &full[st], lane);
      }
    }
  } else {
    // The k16 steps of stage i that hold some of K (8 but for a last stage
    // past K).
    const auto k16_steps = [&](int i) { return min(8, (a.k - (s_begin + i) * QW_BK + 15) / 16); };
    const auto stage_of = [&](int i) { return smem + (i % STAGES) * L::STAGE; };
    // Stage i's x into split set i % SETS once the stage has landed.
    auto split = [&](int i) {
      mbar_wait(&full[i % STAGES], (i / STAGES) & 1);
      split_x<L::CONSUMERS>(stage_of(i), sets + (i % SETS) * L::SET, 2 * k16_steps(i), tid);
    };
    // Stage i's W into the A fragments; the stage is then free.
    auto convert = [&](int i, uint32_t (&fa)[8][4]) {
      w_fragments(stage_of(i) + L::X_BYTES, r_lo, g, sel, fa);
      mbar_arrive(&empty[i % STAGES]);
    };
    auto issue = [&](int i, uint32_t (&fa)[8][4]) {
      const unsigned char* set = sets + (i % SETS) * L::SET;
      const int ks = k16_steps(i);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        if (s < ks) {
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            wgmma_rs_n64(acc, fa[s], sw128_desc(set + p * L::PART + (s >> 2) * L::BOX) + (s & 3) * 2);
          }
        }
      }
      wgmma_commit();
    };
    // The stage's group done: its tile into the running sums, the tile zeroed.
    auto retire = [&](uint32_t (&fa)[8][4]) {
      wgmma_wait<0>();
#pragma unroll
      for (int s = 0; s < 8; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) reg_fence(fa[s][e]);
#pragma unroll
      for (int e = 0; e < QF_TOK / 2; ++e) {
        reg_fence(acc[e]);
        sum[e] += acc[e];
        acc[e] = 0.f;
      }
    };
    // One set of A fragments (two would cap a two-warpgroup block's
    // registers): stage i + 1's x splits while stage i's 24 wgmma run, its
    // W converts once they have retired.
    uint32_t fa[8][4];
    if (n_steps > 0) {
      split(0);
      convert(0, fa);
    }
    consumers_sync<L::CONSUMERS>();
    for (int i = 0; i < n_steps; ++i) {
      issue(i, fa);
      if (SETS > 1 && i + 1 < n_steps) split(i + 1);
      retire(fa);
      if (i + 1 < n_steps) convert(i + 1, fa);
      consumers_sync<L::CONSUMERS>();  // set i + 1 written, set i free in every warpgroup
    }
  }

  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  if (tid < L::CONSUMERS) stash_sums<QF_TOK / 2, L::LDR>(red, sum, r_lo, t);
  cluster.sync();
  split_k_epilogue<QF_TOK, L::BN, L::THREADS, L::LDR>(a, cluster, red, n_split, rank, n0, m0);
  cluster.sync();  // no block leaves while another reads its shared memory
}

// The most clusters of `split` blocks the device holds at once (F32: the
// f32 block of TOK output channels, 64 or 128, as f32_plan plans it for
// more than one K step; else the bf16 block of TOK tokens; quant_matmul.py
// plans the split-K within it), or minus a CUDA error. The CPW instances
// take the same threads and shared memory.
template <bool F32, int TOK>
int max_clusters(int split) {
  static bool smem_allowed = false;
  if constexpr (F32) {
    using L = QfLayout<TOK / 64, TOK == 64 ? 3 : 2, 2>;
    return max_active_clusters(qmm_f32_kernel<TOK / 64, TOK == 64 ? 3 : 2, 2, false>, L::THREADS, L::SMEM,
                               smem_allowed, split);
  } else {
    using L = QwLayout<TOK>;
    return max_active_clusters(qmm_wgmma_kernel<TOK, false>, L::THREADS, L::SMEM, smem_allowed, split);
  }
}

template <int TOK, bool CPW>
cudaError_t launch_wgmma(const QmArgs& a, int split, cudaStream_t st) {
  using L = QwLayout<TOK>;
  CUtensorMap tm_x, tm_w = {};
  cudaError_t e = tensor_map_2d(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.x, a.k, a.m, (uint64_t)a.k * 2,
                                QW_BK / 2, TOK);
  if (e != cudaSuccess) return e;
  if (!CPW) e = tensor_map_2d(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.w, a.k, a.n, a.k, QW_BK, L::BN);
  if (e != cudaSuccess) return e;
  static bool smem_allowed = false;
  e = allow_smem(qmm_wgmma_kernel<TOK, CPW>, L::SMEM, smem_allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid(((a.n + L::BN - 1) / L::BN) * split, (a.m + TOK - 1) / TOK);
  return launch_clustered(qmm_wgmma_kernel<TOK, CPW>, grid, L::THREADS, L::SMEM, split, st, tm_x, tm_w, a);
}

template <int WGS, int STAGES, int SETS, bool CPW>
cudaError_t launch_f32(const QmArgs& a, int split, cudaStream_t st) {
  using L = QfLayout<WGS, STAGES, SETS>;
  CUtensorMap tm_x, tm_w = {};
  cudaError_t e = tensor_map_2d(&tm_x, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a.x, a.k, a.m, (uint64_t)a.k * 4,
                                32, QF_TOK);
  if (e != cudaSuccess) return e;
  if (!CPW) e = tensor_map_2d(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.w, a.k, a.n, a.k, QW_BK, L::BN);
  if (e != cudaSuccess) return e;
  static bool smem_allowed = false;
  e = allow_smem(qmm_f32_kernel<WGS, STAGES, SETS, CPW>, L::SMEM, smem_allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid(((a.n + L::BN - 1) / L::BN) * split, (a.m + QF_TOK - 1) / QF_TOK);
  return launch_clustered(qmm_f32_kernel<WGS, STAGES, SETS, CPW>, grid, L::THREADS, L::SMEM, split, st, tm_x,
                          tm_w, a);
}

// The f32 block for `bn` output channels (64 or 128) at this K: one K step
// (and so no split) takes the one-stage block, two to an SM.
template <bool CPW>
cudaError_t launch_f32_block(const QmArgs& a, int bn, int split, cudaStream_t st) {
  if (bn == 128) return launch_f32<2, 2, 2, CPW>(a, split, st);
  if (a.k <= QW_BK) return launch_f32<1, 1, 1, CPW>(a, split, st);
  return launch_f32<1, 3, 2, CPW>(a, split, st);
}

}  // namespace
}  // namespace rt

// f32: 0 for the bf16 block of `block` tokens, 1 for the f32 block of
// `block` output channels (64 or 128 either way).
extern "C" int rt_quant_matmul_clusters(int f32, int block, int split) {
  if (split < 1 || split > rt::QW_MAX_CLUSTER) return -static_cast<int>(cudaErrorInvalidValue);
  if (block == 64) return f32 ? rt::max_clusters<true, 64>(split) : rt::max_clusters<false, 64>(split);
  if (block == 128) return f32 ? rt::max_clusters<true, 128>(split) : rt::max_clusters<false, 128>(split);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// block and split (1..8: blocks of a cluster along K) come from
// quant_matmul.py: for bf16 activations block is the tokens a block (64 or
// 128, matmul_plan), for f32 ones the output channels a block (64 or 128,
// f32_plan). A K of 8 mod 16 takes either kernel's CPW instance.
extern "C" int rt_quant_matmul(
    const void* x, int x_bf16, int m, int k,
    const int8_t* w_t, const float* scales, const float* bias, int n,
    int act, void* out, int out_bf16, int block, int split,
    void* stream) {
  if (m < 1 || n < 1 || k < 8 || k % 8 || (m + 63) / 64 > 65535 || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(w_t) & 15) || split < 1 || split > rt::QW_MAX_CLUSTER ||
      split > (k + rt::QW_BK - 1) / rt::QW_BK || (block != 64 && block != 128)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const rt::QmArgs a{x, m, n, k, w_t, scales, bias, act, out, out_bf16};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool cpw = k % 16 != 0;
  cudaError_t e;
  if (x_bf16) {
    e = block == 64 ? (cpw ? rt::launch_wgmma<64, true>(a, split, st) : rt::launch_wgmma<64, false>(a, split, st))
                    : (cpw ? rt::launch_wgmma<128, true>(a, split, st) : rt::launch_wgmma<128, false>(a, split, st));
  } else {
    e = cpw ? rt::launch_f32_block<true>(a, block, split, st) : rt::launch_f32_block<false>(a, block, split, st);
  }
  return static_cast<int>(e);
}
