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
// stream (1 byte per weight) does.
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
// f32 activations: f32_tile_loop on the CUDA cores (tile_mma.cuh; exact f32
// products, the int8 weights convert exactly), each thread 4 x 8 outputs.
// K needs only be a multiple of 8 there: a weight row whose K is 8 mod 16
// (MobileNetV2's expand convs of K 24) is only 8-byte aligned, so such rows
// arrive as two 8-byte halves, the half past K and the activations past K
// zero-filled. bf16 activations with such a K take the same loop (their
// values widened exactly to f32, so the products equal the tensor cores'):
// TMA cannot address a weight row stride that is not a multiple of 16.

#include <cooperative_groups.h>

#include "hopper.cuh"
#include "tile_mma.cuh"

namespace rt {
namespace {

namespace cg = cooperative_groups;

struct QmArgs {
  const void* x;       // [m, k] f32 or bf16, 16-byte aligned, k % 8 == 0 (wgmma: k % 16 == 0)
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

template <int TOK>
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
      mbar_init(&full[s], 1);
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
    // Producer: one thread keeps up to QW_STAGES stages of loads in flight.
    if (lane == 0) {
      for (int i = 0; i < n_steps; ++i) {
        const int st = i % QW_STAGES;
        mbar_wait(&empty[st], ((i / QW_STAGES) & 1) ^ 1);
        unsigned char* stage = smem + st * L::STAGE;
        const int k0 = (s_begin + i) * QW_BK;
        mbar_expect_tx(&full[st], L::STAGE);
        tma_load_2d(stage, &tm_x, k0, m0, &full[st]);
        tma_load_2d(stage + L::X_BYTES / 2, &tm_x, k0 + QW_BK / 2, m0, &full[st]);
        tma_load_2d(stage + L::X_BYTES, &tm_w, k0, n0, &full[st]);
      }
    }
  } else {
    // Consumers: stage i's W bytes become bf16 A fragments while stage
    // i - 1's 8 wgmma run (two fragment sets, alternating).
    auto convert = [&](int i, uint32_t (&fa)[8][4]) {
      const int st = i % QW_STAGES;
      mbar_wait(&full[st], (i / QW_STAGES) & 1);
      const unsigned char* ws = smem + st * L::STAGE + L::X_BYTES;
#pragma unroll
      for (int s = 0; s < 8; ++s) {  // K chunk s (16 bytes) of rows r_lo, r_lo + 8, swizzled to s ^ g
        const uint4 lo = *reinterpret_cast<const uint4*>(ws + r_lo * QW_BK + ((s ^ g) << 4));
        const uint4 hi = *reinterpret_cast<const uint4*>(ws + (r_lo + 8) * QW_BK + ((s ^ g) << 4));
        fa[s][0] = i8x2_to_bf16x2(w_pair(lo, sel, false));
        fa[s][1] = i8x2_to_bf16x2(w_pair(hi, sel, false));
        fa[s][2] = i8x2_to_bf16x2(w_pair(lo, sel, true));
        fa[s][3] = i8x2_to_bf16x2(w_pair(hi, sel, true));
      }
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

  // The block's sums as [TOK][BN] f32 in the (now free) ring: element e of
  // consumer thread is channel r_lo + 8 ((e / 2) % 2), token 8 (e / 4) +
  // 2 t + e % 2.
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  if (tid < L::CONSUMERS) {
#pragma unroll
    for (int e = 0; e < TOK / 2; ++e) {
      red[(8 * (e >> 2) + 2 * t + (e & 1)) * L::LDR + r_lo + 8 * ((e >> 1) & 1)] = acc[e];
    }
  }
  cluster.sync();

  // Rank r: tokens [r TOK / C, (r + 1) TOK / C) of the tile. A thread keeps
  // one four-channel piece (its scales and biases read once) over every
  // THREADS / (BN / 4)-th token of the slice; each piece is summed over
  // ranks 0..C-1 in that order (every rank's load in flight first), then
  // the epilogue runs on the whole sum.
  constexpr int QUADS = L::BN / 4, ROWS = L::THREADS / QUADS;
  static_assert(L::THREADS % QUADS == 0, "a thread keeps its channels");
  const int ch = (tid % QUADS) * 4, col = n0 + ch;
  float sc[4], bi[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) col_params(a, col + j, sc[j], bi[j]);
  const int t_end = (rank + 1) * TOK / n_split;
#pragma unroll 2
  for (int tok = rank * TOK / n_split + tid / QUADS; tok < t_end; tok += ROWS) {
    const float* piece = red + tok * L::LDR + ch;
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
  cluster.sync();  // no block leaves while another reads its shared memory
}

// The most clusters of `split` blocks of qmm_wgmma_kernel<TOK> the device
// holds at once (quant_matmul.py plans the split-K within it), or minus a
// CUDA error.
template <int TOK>
int max_clusters(int split) {
  using L = QwLayout<TOK>;
  static bool smem_allowed = false;
  cudaError_t e = allow_smem(qmm_wgmma_kernel<TOK>, L::SMEM, smem_allowed);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, 1);
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = L::SMEM;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, qmm_wgmma_kernel<TOK>, &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

template <int TOK>
cudaError_t launch_wgmma(const QmArgs& a, int split, cudaStream_t st) {
  using L = QwLayout<TOK>;
  CUtensorMap tm_x, tm_w;
  cudaError_t e = tensor_map_2d(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.x, a.k, a.m, (uint64_t)a.k * 2,
                                QW_BK / 2, TOK);
  if (e != cudaSuccess) return e;
  e = tensor_map_2d(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.w, a.k, a.n, a.k, QW_BK, L::BN);
  if (e != cudaSuccess) return e;
  static bool smem_allowed = false;
  e = allow_smem(qmm_wgmma_kernel<TOK>, L::SMEM, smem_allowed);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((a.n + L::BN - 1) / L::BN) * split, (a.m + TOK - 1) / TOK);
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;  // a plain launch is a cluster of one
  e = cudaLaunchKernelEx(&cfg, qmm_wgmma_kernel<TOK>, tm_x, tm_w, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <bool X_BF16>
__global__ void __launch_bounds__(TILE_THREADS) qmm_simt_kernel(QmArgs a) {
  __shared__ __align__(16) F32Tiles s;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int m0 = blockIdx.y * TILE_BM, n0 = blockIdx.x * TILE_BN;
  auto stage = [&](int k0) {  // k % 8 == 0: a step is whole or ends after 8 columns
    {
      const int r = tid >> 2, kq = (tid & 3) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < a.m && k0 + kq < a.k) {
        const size_t o = (size_t)(m0 + r) * a.k + k0 + kq;
        if constexpr (X_BF16) {
          const uint2 h = __ldg(reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(a.x) + o));
          v = make_float4(__uint_as_float(h.x << 16), __uint_as_float(h.x & 0xffff0000u),
                          __uint_as_float(h.y << 16), __uint_as_float(h.y & 0xffff0000u));
        } else {
          v = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(a.x) + o));
        }
      }
      s.a[kq][r] = v.x;
      s.a[kq + 1][r] = v.y;
      s.a[kq + 2][r] = v.z;
      s.a[kq + 3][r] = v.w;
    }
    if (tid < TILE_BN) {
      int4 wv = make_int4(0, 0, 0, 0);
      if (n0 + tid < a.n) {
        const int8_t* wp = a.w + (size_t)(n0 + tid) * a.k + k0;
        if ((a.k & 15) == 0) {
          wv = __ldg(reinterpret_cast<const int4*>(wp));
        } else {  // rows 8-byte aligned: two halves, the second zero past K
          const int2 lo = __ldg(reinterpret_cast<const int2*>(wp));
          const int2 hi = k0 + 8 < a.k ? __ldg(reinterpret_cast<const int2*>(wp + 8)) : make_int2(0, 0);
          wv = make_int4(lo.x, lo.y, hi.x, hi.y);
        }
      }
      float f[16];
      unpack16(wv, f);
#pragma unroll
      for (int e = 0; e < 16; ++e) s.b[e][tid] = f[e];
    }
  };
  float acc[4][8];
  f32_tile_loop(a.k, stage, s, acc);

#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + tx + 16 * j;
    if (col >= a.n) continue;
    float sc, b;
    col_params(a, col, sc, b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty + 16 * i;
      if (row < a.m) store_act(a.out, a.out_bf16, (size_t)row * a.n + col, activate(acc[i][j] * sc + b, a.act));
    }
  }
}

}  // namespace
}  // namespace rt

extern "C" int rt_quant_matmul_clusters(int tok, int split) {
  if (split < 1 || split > rt::QW_MAX_CLUSTER) return -static_cast<int>(cudaErrorInvalidValue);
  if (tok == 64) return rt::max_clusters<64>(split);
  if (tok == 128) return rt::max_clusters<128>(split);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// tok (64 or 128: tokens a block) and split (1..8: blocks of a cluster
// along K) come from quant_matmul.py matmul_plan; the SIMT loop (f32
// activations, or a K of 8 mod 16) ignores them.
extern "C" int rt_quant_matmul(
    const void* x, int x_bf16, int m, int k,
    const int8_t* w_t, const float* scales, const float* bias, int n,
    int act, void* out, int out_bf16, int tok, int split,
    void* stream) {
  if (m < 1 || n < 1 || k < 8 || k % 8 || (m + rt::TILE_BM - 1) / rt::TILE_BM > 65535 ||
      (reinterpret_cast<uintptr_t>(x) & 15) || (reinterpret_cast<uintptr_t>(w_t) & 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const rt::QmArgs a{x, m, n, k, w_t, scales, bias, act, out, out_bf16};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16 && k % 16 == 0) {
    if (split < 1 || split > rt::QW_MAX_CLUSTER || split > (k + rt::QW_BK - 1) / rt::QW_BK) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (tok == 64) return static_cast<int>(rt::launch_wgmma<64>(a, split, st));
    if (tok == 128) return static_cast<int>(rt::launch_wgmma<128>(a, split, st));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n + rt::TILE_BN - 1) / rt::TILE_BN, (m + rt::TILE_BM - 1) / rt::TILE_BM);
  if (x_bf16) {
    rt::qmm_simt_kernel<true><<<grid, rt::TILE_THREADS, 0, st>>>(a);
  } else {
    rt::qmm_simt_kernel<false><<<grid, rt::TILE_THREADS, 0, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
