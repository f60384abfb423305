// matmul_fused: a dense matmul with the bias and the activation applied
// once, in the epilogue, after the whole K sum:
//
//     out = activation(x @ w + bias)
//
// x [M, K] and w [K, N] both bf16 or both f32 (row-major), bias [N] f32,
// any M, N, K; out [M, N] bf16 or f32.
//
// Replaces rten_tpu/kernels/matmul_pallas.py matmul_fused (:102; Pallas
// kernel _matmul_kernel :58), which pads every operand to its 512-blocks and
// carries an f32 accumulator across the sequential K grid axis.
//
// Bound on the H100: operations for the large products it exists for (2 M N
// K flops against 2 (M K + K N) bytes: ~300 bf16 operations per byte from M
// = N = K ~ 900), bytes below that.
//
// Three routes; the wrapper (matmul.py) picks one by dtype and shape and
// the entry point refuses a route the operands do not fit:
// - wgmma (bf16, row strides multiples of 16 bytes: K % 8 == 0, N % 8 == 0,
//   16-byte aligned bases), mf_wgmma_kernel<BN>: 128 x BN output tiles (BN
//   128, or 256 where such tiles still fill the card: matmul.py
//   fused_columns) on the weight-only prefill matmul's pipeline. One
//   producer warp fills a ring of 64-deep stages (as many as 192 KB hold:
//   6, or 4 at BN 256) by TMA with the 128-byte swizzle: the x tile [128
//   rows][64 k] (K-major) and the w tile as stored, [64 k][BN columns] (N
//   contiguous, MN-major), as BN / 64 boxes 64 columns (128 bytes) wide,
//   so there is no transposed copy of the weights. Two consumer warpgroups
//   of 64 rows each issue four m64nBNk16 wgmma a stage with both operands
//   from shared memory, B through the transpose-B bit and an MN-major
//   descriptor (hopper.cuh sw128_mn_desc), f32 accumulation; one group
//   stays in flight while the next stage's is issued. TMA zero-fills the
//   ragged M, N and K edges. Split-K across a cluster of 1-8 blocks where
//   the tiles alone would leave most SMs idle (matmul.py fused_plan, with
//   this kernel's cluster capacity); every rank writes its f32 sums to its
//   shared memory, and each rank sums a slice of rows over ranks 0..C-1 in
//   that order through distributed shared memory (the same bits on every
//   launch: no atomics).
// - ragged (other bf16 rows, which TMA cannot address), mf_bf16_kernel:
//   tile_mma.cuh's 64 x 128 tile of 256 threads, bf16_tile_loop on the
//   tensor cores (mma.sync.m16n8k16, f32 accumulation), two buffers, w
//   staged k-major and read with ldmatrix.trans; the edges masked: a
//   thread stages 16 bytes of a row at once where the row allows it
//   (vec_x / vec_w), element by element otherwise, zeros past M, N and K.
// - f32, mf_f32_kernel: exact fmaf on the CUDA cores (not TF32, whose
//   10-bit mantissa would move results ~1e-3 from the f32 reference).
//   128 x 128 output tiles of 256 threads, 8 x 8 outputs a thread (rows ty
//   * 4 + i and 64 + ty * 4 + i, columns tx * 4 + j and 64 + tx * 4 + j),
//   a cp.async ring of SF_STAGES stages of 16 K (x as [128 rows][16 k],
//   padded to 20 so that the two row groups a warp reads fall in distinct
//   banks; w as stored, [16 k][128 columns]), every shared-memory read 16
//   bytes: per 4 k, eight of x and eight of w feed 256 FMAs. Rows that are
//   not 16-byte multiples are copied 4 bytes at a time (VEC false).
//   Split-K across a cluster as the wgmma route (1024^3 has 64 tiles).
// - Epilogue of the wgmma and f32 routes from the block's (or the
//   cluster's) sums in shared memory: acc + bias, activation (chosen once
//   per epilogue: hopper.cuh with_activation), one rounding to the output
//   dtype, four columns a thread (hopper.cuh store_row4), neighbouring
//   threads on neighbouring columns. (With the activation code dispatched
//   per element the epilogue took ~4 us of a 128 x 128 tile's ~7 on the
//   H100; chosen once, ~1.7.)
//
// What the first design lost time on (all three dtypes on tile_mma.cuh's
// 64 x 128 tile): one register stage, so every K step waited out a
// device-memory latency; mma.sync with a K step of 32 (bf16); and 4 x 8
// f32 outputs a thread from scalar shared-memory reads (f32).

#include "hopper.cuh"
#include "tile_mma.cuh"

namespace rt {
namespace {

struct MfArgs {
  const void* x;      // [m, k] f32 or bf16
  const void* w;      // [k, n], the dtype of x
  const float* bias;  // [n] or null
  int m, n, k;
  int act;            // activations.py ACTIVATION_CODES
  void* out;          // [m, n] f32 or bf16 (out_bf16)
  int out_bf16;
  int vec_x, vec_w;   // rows of x / w may be read as aligned 16-byte pieces
};

// Eight bf16 of row `row` from column c (as one int4), zeros past the row's
// `cols` or where the row is past `rows`.
__device__ __forceinline__ int4 load8_bf16(const __nv_bfloat16* p, int row, int rows, int c, int cols,
                                           size_t ld, bool vec) {
  if (row >= rows || c >= cols) return make_int4(0, 0, 0, 0);
  const __nv_bfloat16* src = p + (size_t)row * ld + c;
  if (vec) return __ldg(reinterpret_cast<const int4*>(src));  // whole: cols % 8 == 0
  unsigned h[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) h[e] = c + e < cols ? __ldg(reinterpret_cast<const unsigned short*>(src) + e) : 0u;
  const uint4 v = make_uint4(h[0] | (h[1] << 16), h[2] | (h[3] << 16), h[4] | (h[5] << 16), h[6] | (h[7] << 16));
  return *reinterpret_cast<const int4*>(&v);
}

__device__ __forceinline__ float bias_at(const MfArgs& a, int col) {
  return (a.bias && col < a.n) ? __ldg(a.bias + col) : 0.f;
}

__global__ void __launch_bounds__(TILE_THREADS) mf_bf16_kernel(MfArgs a) {
  __shared__ __align__(16) Bf16Tiles<true> s;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * TILE_BM, n0 = blockIdx.x * TILE_BN;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);
  // Staging: thread tid loads 8 bf16 of x row xr, and 8 bf16 of w rows wr
  // and wr + 16 (32 k x 128 columns: 16 pieces of 8 a row).
  const int xr = tid >> 2, xc = (tid & 3) * 8;
  const int wr = tid >> 4, wc = (tid & 15) * 8;
  int4 xv, wv0, wv1;
  auto load = [&](int kt) {
    const int k0 = kt * TILE_BK;
    xv = load8_bf16(x, m0 + xr, a.m, k0 + xc, a.k, a.k, a.vec_x);
    wv0 = load8_bf16(w, k0 + wr, a.k, n0 + wc, a.n, a.n, a.vec_w);
    wv1 = load8_bf16(w, k0 + wr + 16, a.k, n0 + wc, a.n, a.n, a.vec_w);
  };
  auto store = [&](int buf) {
    *reinterpret_cast<int4*>(&s.a[buf][xr][xc]) = xv;
    *reinterpret_cast<int4*>(&s.b[buf][wr][wc]) = wv0;
    *reinterpret_cast<int4*>(&s.b[buf][wr + 16][wc]) = wv1;
  };
  float acc[2][4][4];
  bf16_tile_loop<true>((a.k + TILE_BK - 1) / TILE_BK, load, store, s, acc);

  float b0, b1;
  bf16_tile_epilogue(
      acc, m0, n0,
      [&](int col) {
        b0 = bias_at(a, col);
        b1 = bias_at(a, col + 1);
      },
      [&](int row, int col, float v0, float v1) {
        store_out_pair(a.out, a.out_bf16, a.m, a.n, row, col, activate(v0 + b0, a.act), activate(v1 + b1, a.act));
      });
}

// ---- the wgmma route --------------------------------------------------------

constexpr int MF_BM = 128;         // output rows of a block (the wgmma and f32 routes)
constexpr int MF_MAX_CLUSTER = 8;  // quant_matmul.py MAX_SPLIT
constexpr int MW_BK = 64;          // K of a stage: one 128-byte swizzled row of x
constexpr int MW_CONSUMERS = 256, MW_THREADS = MW_CONSUMERS + 32;
constexpr int MW_A_BYTES = MF_BM * MW_BK * 2;  // [128][64] bf16
constexpr int MW_B_BOX = MW_BK * 64 * 2;       // [64 k][64 columns] bf16

// The wgmma block of BN columns (128 or 256): a stage holds the x tile and
// BN / 64 boxes of w; as many stages as 192 KB hold, at most 6.
template <int BN>
struct MwLayout {
  static constexpr int STAGE = MW_A_BYTES + (BN / 64) * MW_B_BOX;
  static constexpr int STAGES = 196608 / STAGE < 6 ? 196608 / STAGE : 6;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int SMEM = RING + 2 * STAGES * 8 + 1024;  // + mbarriers + alignment slack
  static constexpr int LDR = BN + 4;                         // f32 row stride of the [128][BN] sums
  static_assert(MF_BM * LDR * 4 <= RING, "the sums reuse the ring");
};

template <int BN>
__device__ __forceinline__ void wgmma_bf16_tb(float (&d)[BN / 2], uint64_t desc_a, uint64_t desc_b);
template <>
__device__ __forceinline__ void wgmma_bf16_tb<128>(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  wgmma_ss_bf16_n128_tb(d, desc_a, desc_b);
}
template <>
__device__ __forceinline__ void wgmma_bf16_tb<256>(float (&d)[128], uint64_t desc_a, uint64_t desc_b) {
  wgmma_ss_bf16_n256_tb(d, desc_a, desc_b);
}

namespace cg = cooperative_groups;

// The epilogue from the sums in shared memory (red: [MF_BM][BN + 4] f32 in
// every rank): rank r takes rows [r MF_BM / C, (r + 1) MF_BM / C); a thread
// keeps one four-column piece (its biases read once) over every ROWS-th
// row and sums it over the ranks in order.
template <int THREADS, int BN>
__device__ __forceinline__ void mf_epilogue(cg::cluster_group& cluster, const float* red, int n_split, int rank,
                                            int m0, int n0, const MfArgs& a) {
  constexpr int QUADS = BN / 4, ROWS = THREADS / QUADS;
  const int tid = threadIdx.x, ch = (tid % QUADS) * 4, col = n0 + ch;
  if (tid >= ROWS * QUADS) return;
  float bi[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) bi[j] = bias_at(a, col + j);
  const int r_end = (rank + 1) * MF_BM / n_split;
  with_activation(a.act, [&](auto act_tag) {
    constexpr int ACT = decltype(act_tag)::value;
#pragma unroll 4
    for (int r = rank * MF_BM / n_split + tid / QUADS; r < r_end; r += ROWS) {
      const float4 sum = cluster_sum4<MF_MAX_CLUSTER>(
          cluster, reinterpret_cast<const float4*>(red + r * (BN + 4) + ch), n_split, rank);
      const int row = m0 + r;
      if (row >= a.m || col >= a.n) continue;
      const float o[4] = {activate_t<ACT>(sum.x + bi[0], a.act), activate_t<ACT>(sum.y + bi[1], a.act),
                          activate_t<ACT>(sum.z + bi[2], a.act), activate_t<ACT>(sum.w + bi[3], a.act)};
      store_row4(a.out, a.out_bf16, a.n, row, col, o);
    }
  });
}

template <int BN>
__global__ void __launch_bounds__(MW_THREADS) mf_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w, MfArgs a) {
  using L = MwLayout<BN>;
  extern __shared__ unsigned char mw_raw[];
  unsigned char* smem = smem_align(mw_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::RING);
  uint64_t* empty = full + L::STAGES;

  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = (blockIdx.x / n_split) * BN, m0 = blockIdx.y * MF_BM;
  const int steps = (a.k + MW_BK - 1) / MW_BK;
  const int s_begin = rank * steps / n_split, s_end = (rank + 1) * steps / n_split;
  const int n_steps = s_end - s_begin;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == MW_CONSUMERS) {
    prefetch_tensormap(&tm_x);
    prefetch_tensormap(&tm_w);
  }
  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], MW_CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  if (warp == MW_CONSUMERS / 32) {
    if (lane == 0) {
      const CUtensorMap *px = &tm_x, *pw = &tm_w;
      ring_produce<L::STAGES>(0, n_steps, full, empty, L::STAGE, [=](int st, int i, uint64_t* bar) {
        unsigned char* stage = smem + st * L::STAGE;
        const int k0 = (s_begin + i) * MW_BK;
        tma_load_2d(stage, px, k0, m0, bar);
#pragma unroll
        for (int b = 0; b < BN / 64; ++b) tma_load_2d(stage + MW_A_BYTES + b * MW_B_BOX, pw, n0 + 64 * b, k0, bar);
      });
    }
  } else {
    // Warpgroup wg: rows [64 wg, 64 wg + 64) of the tile (A) by the stage's
    // BN columns of w (B, MN-major); a k16 step moves A's start by 32
    // bytes and B's by 16 rows (2048 bytes).
    const int wg = warp >> 2;
    for (int i = 0; i < n_steps; ++i) {
      const int st = i % L::STAGES;
      mbar_wait(&full[st], (i / L::STAGES) & 1);
      const unsigned char* xs = smem + st * L::STAGE;
      const uint64_t da = sw128_desc(xs + wg * 64 * 128), db = sw128_mn_desc(xs + MW_A_BYTES, MW_B_BOX);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < MW_BK / 16; ++s) wgmma_bf16_tb<BN>(acc, da + 2 * s, db + 128 * s);
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int e = 0; e < BN / 2; ++e) reg_fence(acc[e]);
      if (i > 0) mbar_arrive(&empty[(i - 1) % L::STAGES]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) reg_fence(acc[e]);
  }

  // The block's sums as [MF_BM][BN] f32 in the (now free) ring: element e
  // of consumer thread (warp, g = lane / 4, t = lane % 4) is row 16 warp
  // + g + 8 ((e / 2) % 2), column 8 (e / 4) + 2 t + e % 2.
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  if (tid < MW_CONSUMERS) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int e = 0; e < BN / 2; e += 2) {
      const int row = warp * 16 + g + 8 * ((e >> 1) & 1), col = 8 * (e >> 2) + 2 * t;
      *reinterpret_cast<float2*>(red + row * L::LDR + col) = make_float2(acc[e], acc[e + 1]);
    }
  }
  cluster_or_block_sync(cluster, n_split);
  mf_epilogue<MW_THREADS, BN>(cluster, red, n_split, rank, m0, n0, a);
  if (n_split > 1) cluster.sync();  // no block leaves while another reads its shared memory
}

// ---- the f32 route ----------------------------------------------------------

constexpr int SF_BN = 128, SF_BK = 16, SF_LDA = SF_BK + 4, SF_STAGES = 4, SF_THREADS = 256;

struct SfStage {
  float a[MF_BM][SF_LDA];  // x rows, k contiguous
  float b[SF_BK][SF_BN];   // w rows, columns contiguous
};
constexpr int SF_SMEM = SF_STAGES * sizeof(SfStage);
static_assert(MF_BM * (SF_BN + 4) * 4 <= SF_SMEM, "the sums reuse the ring");

__device__ __forceinline__ int sf_row(int ty, int i) { return (i < 4 ? 0 : 64) + ty * 4 + (i & 3); }

template <bool VEC>
__global__ void __launch_bounds__(SF_THREADS) mf_f32_kernel(MfArgs a) {
  extern __shared__ __align__(16) unsigned char sf_raw[];
  SfStage* ring = reinterpret_cast<SfStage*>(sf_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = (blockIdx.x / n_split) * SF_BN, m0 = blockIdx.y * MF_BM;
  const int steps = (a.k + SF_BK - 1) / SF_BK;
  const int s_begin = rank * steps / n_split, n_steps = (rank + 1) * steps / n_split - s_begin;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float* x = static_cast<const float*>(a.x);
  const float* w = static_cast<const float*>(a.w);

  // Step i into stage buffer `buf`: 512 16-byte pieces of x ([128][16]) and
  // of w ([16][128]), two of each a thread; zeros past M, N and K.
  auto load = [&](int buf, int i) {
    const int k0 = (s_begin + i) * SF_BK;
    SfStage& s = ring[buf];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int p = tid + c * SF_THREADS;
      const int xr = p >> 2, xk = (p & 3) * 4, row = m0 + xr;
      const int wk = p >> 5, wc = (p & 31) * 4, kr = k0 + wk;
      const float* xs = x + (size_t)row * a.k + k0 + xk;
      const float* ws = w + (size_t)kr * a.n + n0 + wc;
      if (VEC) {  // k % 4 == 0 and n % 4 == 0: a piece is whole or past the edge
        const bool xo = row < a.m && k0 + xk < a.k, wo = kr < a.k && n0 + wc < a.n;
        cp_async16(&s.a[xr][xk], xo ? xs : x, xo);
        cp_async16(&s.b[wk][wc], wo ? ws : w, wo);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool xo = row < a.m && k0 + xk + e < a.k, wo = kr < a.k && n0 + wc + e < a.n;
          cp_async4(&s.a[xr][xk + e], xo ? xs + e : x, xo);
          cp_async4(&s.b[wk][wc + e], wo ? ws + e : w, wo);
        }
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < SF_STAGES - 1; ++s) {
    if (s < n_steps) load(s, s);
    cp_async_commit();
  }
  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<SF_STAGES - 2>();  // step i has landed
    __syncthreads();                 // and every thread is done with step i - 1's buffer
    if (i + SF_STAGES - 1 < n_steps) load((i + SF_STAGES - 1) % SF_STAGES, i + SF_STAGES - 1);
    cp_async_commit();
    const SfStage& s = ring[i % SF_STAGES];
#pragma unroll
    for (int kq = 0; kq < SF_BK; kq += 4) {
      float4 av[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) av[r] = *reinterpret_cast<const float4*>(&s.a[sf_row(ty, r)][kq]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(&s.b[kq + kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&s.b[kq + kk][64 + tx * 4]);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float xv = kk == 0 ? av[r].x : kk == 1 ? av[r].y : kk == 2 ? av[r].z : av[r].w;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(xv, bv[j], acc[r][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  float* red = reinterpret_cast<float*>(sf_raw);
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float* dst = red + sf_row(ty, r) * (SF_BN + 4) + tx * 4;
    *reinterpret_cast<float4*>(dst) = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    *reinterpret_cast<float4*>(dst + 64) = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
  cluster_or_block_sync(cluster, n_split);
  mf_epilogue<SF_THREADS, SF_BN>(cluster, red, n_split, rank, m0, n0, a);
  if (n_split > 1) cluster.sync();
}

// ---- launches ---------------------------------------------------------------

enum MfRoute { MF_WGMMA = 0, MF_RAGGED = 1, MF_F32 = 2 };

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int max_clusters(int route, int bn, int split) {
  static bool wgmma128_smem = false, wgmma256_smem = false, f32_smem = false;
  if (route == MF_WGMMA && bn == 128) {
    return max_active_clusters(mf_wgmma_kernel<128>, MW_THREADS, MwLayout<128>::SMEM, wgmma128_smem, split);
  }
  if (route == MF_WGMMA && bn == 256) {
    return max_active_clusters(mf_wgmma_kernel<256>, MW_THREADS, MwLayout<256>::SMEM, wgmma256_smem, split);
  }
  if (route == MF_F32 && bn == SF_BN) {
    return max_active_clusters(mf_f32_kernel<true>, SF_THREADS, SF_SMEM, f32_smem, split);
  }
  return -static_cast<int>(cudaErrorInvalidValue);
}

template <int BN>
cudaError_t launch_wgmma(const MfArgs& a, int split, cudaStream_t st) {
  using L = MwLayout<BN>;
  CUtensorMap tm_x, tm_w;
  cudaError_t e = tensor_map_2d(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.x, a.k, a.m, (uint64_t)a.k * 2, MW_BK,
                                MF_BM);
  if (e != cudaSuccess) return e;
  e = tensor_map_2d(&tm_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.w, a.n, a.k, (uint64_t)a.n * 2, 64, MW_BK);
  if (e != cudaSuccess) return e;
  static bool smem_allowed = false;
  e = allow_smem(mf_wgmma_kernel<BN>, L::SMEM, smem_allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid(((a.n + BN - 1) / BN) * split, (a.m + MF_BM - 1) / MF_BM);
  return launch_clustered(mf_wgmma_kernel<BN>, grid, MW_THREADS, L::SMEM, split, st, tm_x, tm_w, a);
}

template <bool VEC>
cudaError_t launch_f32(const MfArgs& a, int split, cudaStream_t st) {
  static bool smem_allowed = false;
  const cudaError_t e = allow_smem(mf_f32_kernel<VEC>, SF_SMEM, smem_allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid(((a.n + SF_BN - 1) / SF_BN) * split, (a.m + MF_BM - 1) / MF_BM);
  return launch_clustered(mf_f32_kernel<VEC>, grid, SF_THREADS, SF_SMEM, split, st, a);
}

}  // namespace
}  // namespace rt

extern "C" int rt_matmul_fused_clusters(int route, int bn, int split) {
  if (split < 1 || split > rt::MF_MAX_CLUSTER) return -static_cast<int>(cudaErrorInvalidValue);
  return rt::max_clusters(route, bn, split);
}

// route (matmul.py ROUTES: 0 wgmma, 1 ragged, 2 f32), bn (columns a block:
// 128 or 256 on the wgmma route, 128 on the f32 one) and split (1..8:
// blocks of a cluster along K; 1 on the ragged route) come from matmul.py
// fused_plan.
extern "C" int rt_matmul_fused(
    const void* x, const void* w, const float* bias, int route, int m, int n, int k,
    int act, void* out, int out_bf16, int bn, int split,
    void* stream) {
  if (m < 1 || n < 1 || k < 1 || (m + rt::TILE_BM - 1) / rt::TILE_BM > 65535 || split < 1 ||
      split > rt::MF_MAX_CLUSTER) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool aligned = rt::aligned16(x) && rt::aligned16(w);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == rt::MF_WGMMA) {
    if (k % 8 || n % 8 || !aligned || split > (k + rt::MW_BK - 1) / rt::MW_BK) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const rt::MfArgs a{x, w, bias, m, n, k, act, out, out_bf16, 1, 1};
    if (bn == 128) return static_cast<int>(rt::launch_wgmma<128>(a, split, st));
    if (bn == 256) return static_cast<int>(rt::launch_wgmma<256>(a, split, st));
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (route == rt::MF_F32) {
    if (bn != rt::SF_BN || split > (k + rt::SF_BK - 1) / rt::SF_BK) return static_cast<int>(cudaErrorInvalidValue);
    const bool vec = k % 4 == 0 && n % 4 == 0 && aligned;
    const rt::MfArgs a{x, w, bias, m, n, k, act, out, out_bf16, vec, vec};
    return static_cast<int>(vec ? rt::launch_f32<true>(a, split, st) : rt::launch_f32<false>(a, split, st));
  }
  if (route != rt::MF_RAGGED || split != 1) return static_cast<int>(cudaErrorInvalidValue);
  const rt::MfArgs a{x, w, bias, m, n, k, act, out, out_bf16,
                     k % 8 == 0 && rt::aligned16(x), n % 8 == 0 && rt::aligned16(w)};
  const dim3 grid((n + rt::TILE_BN - 1) / rt::TILE_BN, (m + rt::TILE_BM - 1) / rt::TILE_BM);
  rt::mf_bf16_kernel<<<grid, rt::TILE_THREADS, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
