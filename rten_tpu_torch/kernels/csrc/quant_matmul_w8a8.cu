// quant_matmul_w8a8: the prefill matmul in W8A8 mode, M > 8 rows of
// activations quantized per row to int8, against an int8 weight matrix with
// per-output-channel f32 scales, on the int8 tensor cores:
//
//     out = activation((codes @ W) * sx * scale + bias)
//
// Replaces rten_tpu/kernels/quant_matmul.py quant_matmul_w8a8 (:760; Pallas
// kernel _q8_kernel :715) and the XLA row quantization before it
// (:792-796). Two launches on one stream:
// - quantize_rows_kernel (rt_quantize_rows), one block per row: absmax by a
//   block max (exact in any order), sx = absmax / 127 by IEEE division (1
//   for an all-zero row), codes = rint(x / sx) clipped to +-127, into
//   int8 [M, K] and f32 sx [M]. On the TPU this is XLA outside the kernel;
//   a kernel here, since eager PyTorch would take ~7 launches for it. It
//   stays a launch of its own: a code needs its row's absmax over all of
//   K, while a split-K rank of the matmul sees 1/C of K and a block of one
//   token tile would redo the whole row reduction for every channel tile.
// - qmm_s8_wgmma_kernel (rt_quant_matmul_w8a8), the matmul on the weight-
//   only prefill matmul's pipeline (quant_matmul.cu qmm_wgmma_kernel) with
//   nothing to convert:
//   - Swap-AB on wgmma: the kernel computes out^T = W . codes^T, so the
//     weight tile is wgmma's M side and the tokens its N: 64 tokens a block
//     up to M = 64, else 128, one consumer warpgroup per 64 tokens, each
//     owning CH output channels (64, or 128 as two M tiles on the same
//     codes where such blocks still fill the card: quant_matmul.py
//     w8a8_channels). The per-channel scale and bias are per accumulator
//     row.
//   - Both operands from shared memory (SS): int8 wgmma takes both
//     K-major, and the port's [N, K] weight pack and the [M, K] codes are
//     both K-major already, so there is no new weight layout.
//   - A ring of stages of 128 codes of K each (4 for the 64 x 64 block,
//     which fits three a SM; up to 6 in 192 KB for the others), filled by
//     TMA with the 128-byte swizzle (one box row is 128 codes): one
//     producer warp waits for a free stage, announces its bytes on the
//     stage's "full" mbarrier and issues two box loads (the [TOK][128]
//     codes, the [BN][128] weights). The consumers wait on "full" and issue
//     four m64nTOKk32 s8 x s8 -> s32 wgmma a stage and M tile (a k32 step
//     moves each descriptor's start by 32 bytes), keep that group in
//     flight while the next stage's are issued, and free a stage once its
//     group is done. TMA zero-fills the ragged M, N and K edges: a zero
//     code adds nothing.
//   - Split-K for few output tiles: the host (quant_matmul.py w8a8_plan,
//     with this kernel's own cluster capacity) sets a cluster of C blocks
//     (C <= 8) along K. Rank r takes K steps [r S / C, (r + 1) S / C) of S.
//     Every rank writes its int32 sums to its own shared memory as a
//     [TOK][BN] tile; after a cluster barrier rank r sums a 1/C slice of the
//     tile, four channels at a time, over ranks 0..C-1 in that order through
//     distributed shared memory (its own through plain shared-memory
//     loads). Integer sums are exact, so every split and every launch gives
//     the same bits.
//   - Epilogue, in the plain version's order: ((float)acc * sx[token]) *
//     scale[channel], both products rounded (__fmul_rn, no FMA
//     contraction), + bias, activation, one rounding to the output dtype,
//     stored four channels a thread. A f32 output with no activation equals
//     quant_matmul_w8a8_ref bit for bit. The tile's row scales are read
//     into shared memory during the main loop, and the activation is
//     chosen once per epilogue, not per element (hopper.cuh
//     with_activation): a per-element dispatch and a dependent sx load per
//     row made the epilogue half of a small call's time.
//
// Bound on the H100: at M 64 the weight stream (1 byte a weight, read once
// per token tile); from a few hundred rows the int8 tensor cores (1979 TOPS
// dense). At M 64 a call is mostly fixed latency: the first TMA round trip,
// the cluster barrier and the epilogue.
//
// What the first design (qmm_s8_kernel: 64 x 128 tiles on mma.sync, one
// register stage, no split) lost time on: every 64-deep K step waited out
// a device-memory latency, and at M 64 the down projection had 6 output
// tiles for 132 SMs, each walking 48 K steps in series.

#include "hopper.cuh"

namespace rt {
namespace {

namespace cg = cooperative_groups;

constexpr int QR_THREADS = 256;

__global__ void __launch_bounds__(QR_THREADS) quantize_rows_kernel(const void* x, int bf16, int k,
                                                                    int8_t* codes, float* sx) {
  __shared__ float red[QR_THREADS / 32];
  const size_t base = (size_t)blockIdx.x * k;
  const float scale = quantize_row<QR_THREADS>([&](int v) { return load_act4(x, bf16, base + 4 * v); }, k >> 2,
                                               reinterpret_cast<unsigned*>(codes + base), red);
  if (threadIdx.x == 0) sx[blockIdx.x] = scale;
}

struct Q8Args {
  const int8_t* xq;    // [m, k] int8 codes, 16-byte aligned, k % 16 == 0
  const float* sx;     // [m] per-row scales
  int m, n, k;
  const int8_t* w;     // [n, k] int8 (int8_pack), 16-byte aligned
  const float* scale;  // [n]
  const float* bias;   // [n] or null
  int act;             // activations.py ACTIVATION_CODES (common.cuh activate)
  void* out;           // [m, n] f32 or bf16 (out_bf16)
  int out_bf16;
};

constexpr int Q8_BK = 128;         // K of a stage: one 128-byte swizzled row of codes and of W
constexpr int Q8_MAX_CLUSTER = 8;  // quant_matmul.py MAX_SPLIT

// A block of TOK tokens has TOK / 64 consumer warpgroups, each owning CH
// output channels (CH / 64 wgmma M tiles), and one producer warp.
template <int TOK, int CH>
struct Q8Layout {
  static constexpr int WGS = TOK / 64;            // consumer warpgroups
  static constexpr int BN = CH * WGS;             // output channels a block
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int THREADS = CONSUMERS + 32;
  static constexpr int X_BYTES = TOK * Q8_BK;     // [TOK][128] codes
  static constexpr int W_BYTES = BN * Q8_BK;      // [BN][128] weights
  static constexpr int STAGE = X_BYTES + W_BYTES;  // a multiple of 1024
  // 4 stages for the 64 x 64 block (three blocks a SM), else as many as
  // 192 KB hold, at most 6.
  static constexpr int STAGES = (TOK == 64 && CH == 64) ? 4 : (196608 / STAGE < 6 ? 196608 / STAGE : 6);
  static constexpr int RING = STAGES * STAGE;
  static constexpr int SMEM = RING + 2 * STAGES * 8 + TOK * 4 + 1024;  // + mbarriers, row scales, alignment slack
  static constexpr int LDR = BN + 4;              // int32 row stride of the [TOK][BN] sums
  static_assert(TOK * LDR * 4 <= RING, "the sums reuse the ring");
};

template <int TOK>
__device__ __forceinline__ void wgmma_s8(int (&d)[TOK / 2], uint64_t desc_w, uint64_t desc_x);
template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t desc_w, uint64_t desc_x) {
  wgmma_ss_s8_n64(d, desc_w, desc_x);
}
template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t desc_w, uint64_t desc_x) {
  wgmma_ss_s8_n128(d, desc_w, desc_x);
}

template <int TOK, int CH>
__global__ void __launch_bounds__(Q8Layout<TOK, CH>::THREADS) qmm_s8_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w, Q8Args a) {
  using L = Q8Layout<TOK, CH>;
  constexpr int MT = CH / 64;  // wgmma M tiles of a warpgroup
  extern __shared__ unsigned char q8_raw[];
  unsigned char* smem = smem_align(q8_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::RING);
  uint64_t* empty = full + L::STAGES;
  float* sxs = reinterpret_cast<float*>(empty + L::STAGES);  // the tile's TOK row scales

  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = (blockIdx.x / n_split) * L::BN, m0 = blockIdx.y * TOK;
  const int steps = (a.k + Q8_BK - 1) / Q8_BK;
  const int s_begin = rank * steps / n_split, s_end = (rank + 1) * steps / n_split;
  const int n_steps = s_end - s_begin;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == L::CONSUMERS) {
    prefetch_tensormap(&tm_x);
    prefetch_tensormap(&tm_w);
  }
  if (tid == 0) {
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], L::CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  int acc[MT][TOK / 2];
#pragma unroll
  for (int h = 0; h < MT; ++h)
#pragma unroll
    for (int i = 0; i < TOK / 2; ++i) acc[h][i] = 0;

  if (warp == L::CONSUMERS / 32) {
    if (lane == 0) {
      const CUtensorMap *px = &tm_x, *pw = &tm_w;
      ring_produce<L::STAGES>(0, n_steps, full, empty, L::STAGE, [=](int st, int i, uint64_t* bar) {
        unsigned char* stage = smem + st * L::STAGE;
        const int k0 = (s_begin + i) * Q8_BK;
        tma_load_2d(stage, px, k0, m0, bar);
        tma_load_2d(stage + L::X_BYTES, pw, k0, n0, bar);
      });
    }
  } else {
    // The tile's row scales for the epilogue (read after the barrier that
    // follows the main loop), fetched while the first stage is in flight.
    if (tid < TOK) sxs[tid] = m0 + tid < a.m ? __ldg(a.sx + m0 + tid) : 0.f;
    // Warpgroup wg multiplies its CH weight rows (A, 64 at a time) by the
    // stage's codes (B); the group of stage i stays in flight while stage
    // i + 1's is issued, and stage i is freed once it is done.
    const int wg = warp >> 2;
    for (int i = 0; i < n_steps; ++i) {
      const int st = i % L::STAGES;
      mbar_wait(&full[st], (i / L::STAGES) & 1);
      const unsigned char* xs = smem + st * L::STAGE;
      const uint64_t dx = sw128_desc(xs);
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < MT; ++h) {
        const uint64_t dw = sw128_desc(xs + L::X_BYTES + (wg * CH + h * 64) * Q8_BK);
#pragma unroll
        for (int s = 0; s < Q8_BK / 32; ++s) wgmma_s8<TOK>(acc[h], dw + 2 * s, dx + 2 * s);
      }
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int h = 0; h < MT; ++h)
#pragma unroll
        for (int e = 0; e < TOK / 2; ++e) reg_fence(acc[h][e]);
      if (i > 0) mbar_arrive(&empty[(i - 1) % L::STAGES]);
    }
    wgmma_wait<0>();
#pragma unroll
    for (int h = 0; h < MT; ++h)
#pragma unroll
      for (int e = 0; e < TOK / 2; ++e) reg_fence(acc[h][e]);
  }

  // The block's sums as [TOK][BN] int32 in the (now free) ring: element e
  // of M tile h of consumer thread (warp, g = lane / 4, t = lane % 4) is
  // channel CH wg + 64 h + 16 (warp % 4) + g + 8 ((e / 2) % 2), token
  // 8 (e / 4) + 2 t + e % 2.
  __syncthreads();
  int* red = reinterpret_cast<int*>(smem);
  if (tid < L::CONSUMERS) {
    const int g = lane >> 2, t = lane & 3, r_lo = (warp >> 2) * CH + (warp & 3) * 16 + g;
#pragma unroll
    for (int h = 0; h < MT; ++h)
#pragma unroll
      for (int e = 0; e < TOK / 2; ++e) {
        red[(8 * (e >> 2) + 2 * t + (e & 1)) * L::LDR + r_lo + 64 * h + 8 * ((e >> 1) & 1)] = acc[h][e];
      }
  }
  cluster_or_block_sync(cluster, n_split);

  // Rank r: tokens [r TOK / C, (r + 1) TOK / C) of the tile. A thread keeps
  // one four-channel piece (its scales and biases read once) over every
  // ROWS-th token of the slice; each piece is summed over ranks 0..C-1 in
  // that order, then rescaled once.
  constexpr int QUADS = L::BN / 4, ROWS = L::THREADS / QUADS;
  const int ch = (tid % QUADS) * 4, col = n0 + ch;
  if (tid < ROWS * QUADS) {
    float sc[4], bi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sc[j] = col + j < a.n ? __ldg(a.scale + col + j) : 0.f;
      bi[j] = (a.bias && col + j < a.n) ? __ldg(a.bias + col + j) : 0.f;
    }
    const int t_end = (rank + 1) * TOK / n_split;
    with_activation(a.act, [&](auto act_tag) {
      constexpr int ACT = decltype(act_tag)::value;
#pragma unroll 4
      for (int tok = rank * TOK / n_split + tid / QUADS; tok < t_end; tok += ROWS) {
        const int4 sum = cluster_sum4<Q8_MAX_CLUSTER>(
            cluster, reinterpret_cast<const int4*>(red + tok * L::LDR + ch), n_split, rank);
        const int row = m0 + tok;
        if (row >= a.m || col >= a.n) continue;
        const float sxr = sxs[tok];
        const int s4[4] = {sum.x, sum.y, sum.z, sum.w};
        float o[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          o[j] = activate_t<ACT>(__fmul_rn(__fmul_rn(__int2float_rn(s4[j]), sxr), sc[j]) + bi[j], a.act);
        }
        store_row4(a.out, a.out_bf16, a.n, row, col, o);
      }
    });
  }
  if (n_split > 1) cluster.sync();  // no block leaves while another reads its shared memory
}

template <int TOK, int CH>
int max_clusters(int split) {
  using L = Q8Layout<TOK, CH>;
  static bool smem_allowed = false;
  return max_active_clusters(qmm_s8_wgmma_kernel<TOK, CH>, L::THREADS, L::SMEM, smem_allowed, split);
}

template <int TOK, int CH>
cudaError_t launch_s8(const Q8Args& a, int split, cudaStream_t st) {
  using L = Q8Layout<TOK, CH>;
  CUtensorMap tm_x, tm_w;
  cudaError_t e = tensor_map_2d(&tm_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.xq, a.k, a.m, a.k, Q8_BK, TOK);
  if (e != cudaSuccess) return e;
  e = tensor_map_2d(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.w, a.k, a.n, a.k, Q8_BK, L::BN);
  if (e != cudaSuccess) return e;
  static bool smem_allowed = false;
  e = allow_smem(qmm_s8_wgmma_kernel<TOK, CH>, L::SMEM, smem_allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid(((a.n + L::BN - 1) / L::BN) * split, (a.m + TOK - 1) / TOK);
  return launch_clustered(qmm_s8_wgmma_kernel<TOK, CH>, grid, L::THREADS, L::SMEM, split, st, tm_x, tm_w, a);
}

}  // namespace
}  // namespace rt

extern "C" int rt_quantize_rows(const void* x, int x_bf16, int m, int k, int8_t* codes, float* sx,
                                void* stream) {
  if (m < 1 || k < 16 || k % 16 || (reinterpret_cast<uintptr_t>(x) & 15) ||
      (reinterpret_cast<uintptr_t>(codes) & 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  rt::quantize_rows_kernel<<<m, rt::QR_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(x, x_bf16, k, codes, sx);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_quant_matmul_w8a8_clusters(int tok, int ch, int split) {
  if (split < 1 || split > rt::Q8_MAX_CLUSTER) return -static_cast<int>(cudaErrorInvalidValue);
  if (tok == 64 && ch == 64) return rt::max_clusters<64, 64>(split);
  if (tok == 128 && ch == 64) return rt::max_clusters<128, 64>(split);
  if (tok == 128 && ch == 128) return rt::max_clusters<128, 128>(split);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// tok (64 or 128: tokens a block), ch (64, or 128 with 128 tokens: output
// channels a consumer warpgroup) and split (1..8: blocks of a cluster along K) come
// from quant_matmul.py w8a8_plan.
extern "C" int rt_quant_matmul_w8a8(
    const int8_t* codes, const float* sx, int m, int k,
    const int8_t* w_t, const float* scales, const float* bias, int n,
    int act, void* out, int out_bf16, int tok, int ch, int split,
    void* stream) {
  if (m < 1 || n < 1 || k < 16 || k % 16 || (m + 63) / 64 > 65535 ||
      (reinterpret_cast<uintptr_t>(codes) & 15) || (reinterpret_cast<uintptr_t>(w_t) & 15) ||
      split < 1 || split > rt::Q8_MAX_CLUSTER || split > (k + rt::Q8_BK - 1) / rt::Q8_BK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const rt::Q8Args a{codes, sx, m, n, k, w_t, scales, bias, act, out, out_bf16};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tok == 64 && ch == 64) return static_cast<int>(rt::launch_s8<64, 64>(a, split, st));
  if (tok == 128 && ch == 64) return static_cast<int>(rt::launch_s8<128, 64>(a, split, st));
  if (tok == 128 && ch == 128) return static_cast<int>(rt::launch_s8<128, 128>(a, split, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
