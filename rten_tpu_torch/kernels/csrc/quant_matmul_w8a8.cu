// quant_matmul_w8a8: the prefill matmul in W8A8 mode, M > 8 rows of
// activations quantized per row to int8, against an int8 weight matrix with
// per-output-channel f32 scales, on the int8 tensor cores:
//
//     out = activation((codes @ W) * sx * scale + bias)
//
// Replaces rten_tpu/kernels/quant_matmul.py quant_matmul_w8a8 (:760; Pallas
// kernel _q8_kernel :715) and the XLA row quantization before it
// (:792-796), in one launch: qmm_w8a8_kernel (rt_quant_matmul_w8a8_fused)
// quantizes its own token tile. A row's codes need its absmax over all of K
// while a split-K rank sees 1/C of K; the ranks of a cluster exchange their
// rows' partial maxima through distributed shared memory, as they exchange
// their int32 sums at the end.
//
// - Swap-AB on wgmma: the kernel computes out^T = W . codes^T, so the
//   weight tile is wgmma's M side and the tokens its N: 64 tokens a block up
//   to M = 64, else 128, one consumer warpgroup per 64 tokens, each owning
//   CH output channels (64 in a 64-token block, 128 as two M tiles on the
//   same codes in a 128-token one: quant_matmul.py w8a8_channels). The
//   per-channel scale and bias are per accumulator row. Both operands come
//   from shared memory (SS), K-major: the port's [N, K] weight pack and the
//   codes in the 128-byte swizzle.
// - The activations: a ring of `slots` slots of [TOK][128] f32 or bf16
//   values, filled by TMA (boxes 128 bytes wide, the 128-byte swizzle; rows
//   past M and columns past K arrive as zeros) from kernel entry. Pass 1
//   takes each row's partial absmax over rank r's K range of the tile (4
//   lanes a row share a shuffle, two warps a shared-memory atomic max on the
//   bits: an absmax is exact in any order); after a cluster barrier each
//   rank takes the max over the C ranks' partials of its rows through
//   distributed shared memory and computes sx = row_scale(absmax) (IEEE
//   division, 1 for a zero row, so a row past M gets 1 and codes 0); pass 2
//   turns each K step into codes and stores them where TMA's 128-byte
//   swizzle put the codes of the two-launch design (16-byte chunk c of row
//   r at c ^ (r % 8) of its 128-byte row), then fence.proxy.async and an
//   arrive on the ring stage's "full" mbarrier. The codes are quantize4's
//   bit for bit: x * (1 / sx) rounded by adding 1.5 * 2^23 (common.cuh
//   quantize16), and the rare value within 2^-14 of a half-integer again
//   by the IEEE division x / sx.
// - Who converts: where the rank's range fits in the slots (`slots` >= its
//   steps; quant_matmul.py w8a8_layout), every warp: both passes are
//   shared by the converting warpgroup and the consumer warpgroups, each
//   consumer warpgroup converting its share of step i + 1 while its step
//   i's wgmma runs. Else the converting warpgroup alone, reading the rows
//   twice: the slots that still hold pass 1's last steps go first (an int32
//   sum is exact in any order) and the rest arrive again from L2.
// - A ring of `stages` stages of 128 codes and 128 weights of K: one
//   thread of the converting warpgroup issues the weights' TMA box for the
//   first stages at kernel entry (in flight during pass 1) and for each
//   later stage once the consumers free it. The stage's "full" mbarrier
//   completes on the weights' bytes and every converting thread's arrival.
//   The consumers wait on "full" and issue four m64nTOKk32 s8 x s8 -> s32
//   wgmma a stage and M tile (a k32 step moves each descriptor's start by
//   32 bytes), keep that group in flight while the next stage's are
//   issued, and free a stage once its group is done.
// - Split-K for few output tiles: the host (quant_matmul.py w8a8_plan, with
//   this kernel's own cluster capacity) sets a cluster of C blocks (C <= 8)
//   along K. Rank r takes K steps [r S / C, (r + 1) S / C) of S. Every rank
//   writes its int32 sums to its own shared memory as a [TOK][BN] tile;
//   after a cluster barrier rank r sums a 1/C slice of the tile, four
//   channels at a time, over ranks 0..C-1 in that order through
//   distributed shared memory (its own through plain shared-memory loads).
//   Integer sums are exact, so every split and every launch gives the same
//   bits.
// - Epilogue, in the plain version's order: ((float)acc * sx[token]) *
//   scale[channel], both products rounded (__fmul_rn, no FMA contraction),
//   + bias, activation, one rounding to the output dtype, stored four
//   channels a thread. A f32 output with no activation equals
//   quant_matmul_w8a8_ref bit for bit, and every output equals the
//   two-launch pair's below.
//
// Bound on the H100: at M 64 the weight stream (1 byte a weight, read once
// per token tile); from a few hundred rows the int8 tensor cores (1979 TOPS
// dense). At M 64 a call is mostly fixed latency: the first TMA round trip,
// the two cluster barriers and the epilogue. What one launch costs: every
// channel tile along N reads its token tile's rows (2 or 4 bytes a value,
// once or twice) and converts them, where the pair read int8 codes once;
// and pass 1 stands before the first wgmma (PERF.md §6).
//
// The two-launch pair stays as the card-side yardstick, on no model path:
// quantize_rows_kernel (rt_quantize_rows, one block a row) writes int8
// codes [M, K] and f32 sx [M]; qmm_s8_wgmma_kernel (rt_quant_matmul_w8a8)
// runs the same consumers and epilogue on them, its codes by TMA on the
// same ring (quant_matmul.py quant_matmul_w8a8_codes).

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

// What the epilogue writes: out [m, n] f32 or bf16.
struct Q8Out {
  int m, n;
  const float* scale;  // [n]
  const float* bias;   // [n] or null
  int act;             // activations.py ACTIVATION_CODES (common.cuh activate)
  void* out;
  int out_bf16;
};

struct Q8Args {
  const int8_t* xq;    // [m, k] int8 codes, 16-byte aligned, k % 16 == 0
  const float* sx;     // [m] per-row scales
  int k;
  const int8_t* w;     // [n, k] int8 (int8_pack), 16-byte aligned
  Q8Out o;
};

struct Q8XArgs {
  int x_bf16;          // x: [m, k] f32 or bf16 rows (the tensor map), k % 16 == 0
  int k;
  int stages, slots;   // ring stages and activation slots (quant_matmul.py w8a8_layout)
  Q8Out o;
};

constexpr int Q8_BK = 128;         // K of a stage: one 128-byte swizzled row of codes and of W
constexpr int Q8_MAX_CLUSTER = 8;  // quant_matmul.py MAX_SPLIT
constexpr int Q8_CONVERT = 128;    // the converting warpgroup

// A block of TOK tokens has TOK / 64 consumer warpgroups, each owning CH
// output channels (CH / 64 wgmma M tiles); the two-launch matmul's block has
// one producer warp besides.
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
  static constexpr int RED = TOK * LDR * 4;
  static_assert(RED <= RING, "the sums reuse the ring");
};

// The one-launch block: the consumers and a converting warpgroup. Shared
// memory (quant_matmul.py w8a8_smem): the ring and the activation slots (the
// [TOK][BN] sums reuse them), the mbarriers, and per row sx, 1 / sx and the
// partial absmax; 1024 bytes of alignment slack.
template <int TOK, int CH>
struct Q8XLayout {
  using L = Q8Layout<TOK, CH>;
  static constexpr int THREADS = L::CONSUMERS + Q8_CONVERT;
  static __host__ __device__ int slot_bytes(int eb) { return TOK * Q8_BK * eb; }
  static __host__ __device__ int region(int stages, int slots, int eb) {
    const int r = stages * L::STAGE + slots * slot_bytes(eb);
    return r > L::RED ? r : L::RED;
  }
  static __host__ __device__ int smem(int stages, int slots, int eb) {
    return 1024 + region(stages, slots, eb) + 8 * (2 * stages + slots) + 12 * TOK;
  }
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

// Barrier of the converting warpgroup (id 1; 0 is __syncthreads).
__device__ __forceinline__ void convert_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(Q8_CONVERT) : "memory");
}

// The consumers' main loop: warpgroup wg multiplies its CH weight rows (A,
// 64 at a time) by each stage's codes (B); the group of stage i stays in
// flight while stage i + 1's is issued, and stage i is freed once it is
// done; after(i) runs while stage i's group is in flight.
template <int TOK, int CH, typename After>
__device__ __forceinline__ void q8_consume(int (&acc)[CH / 64][TOK / 2], const unsigned char* smem, uint64_t* full,
                                           uint64_t* empty, int stages, int n_steps, int wg, const After& after) {
  using L = Q8Layout<TOK, CH>;
  for (int i = 0; i < n_steps; ++i) {
    const int st = i % stages;
    mbar_wait(&full[st], (i / stages) & 1);
    const unsigned char* xs = smem + st * L::STAGE;
    const uint64_t dx = sw128_desc(xs);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < CH / 64; ++h) {
      const uint64_t dw = sw128_desc(xs + L::X_BYTES + (wg * CH + h * 64) * Q8_BK);
#pragma unroll
      for (int s = 0; s < Q8_BK / 32; ++s) wgmma_s8<TOK>(acc[h], dw + 2 * s, dx + 2 * s);
    }
    wgmma_commit();
    wgmma_wait<1>();
#pragma unroll
    for (int h = 0; h < CH / 64; ++h)
#pragma unroll
      for (int e = 0; e < TOK / 2; ++e) reg_fence(acc[h][e]);
    if (i > 0) mbar_arrive(&empty[(i - 1) % stages]);
    after(i);  // with stage i's group in flight
  }
  wgmma_wait<0>();
#pragma unroll
  for (int h = 0; h < CH / 64; ++h)
#pragma unroll
    for (int e = 0; e < TOK / 2; ++e) reg_fence(acc[h][e]);
}

// The epilogue, after the main loop, by every thread of the block. The
// block's sums as [TOK][BN] int32 in the (now free) ring: element e of M
// tile h of consumer thread (warp, g = lane / 4, t = lane % 4) is channel
// CH wg + 64 h + 16 (warp % 4) + g + 8 ((e / 2) % 2), token 8 (e / 4) + 2 t
// + e % 2. Then rank r takes tokens [r TOK / C, (r + 1) TOK / C) of the
// tile: a thread keeps one four-channel piece (its scales and biases read
// once) over every ROWS-th token of the slice; each piece is summed over
// ranks 0..C-1 in that order, then rescaled once.
template <int TOK, int CH, int THREADS>
__device__ __forceinline__ void q8_epilogue(const int (&acc)[CH / 64][TOK / 2], unsigned char* smem, const float* sxs,
                                            const Q8Out& a, cg::cluster_group& cluster, int n_split, int rank,
                                            int n0, int m0) {
  using L = Q8Layout<TOK, CH>;
  constexpr int MT = CH / 64;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
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

  constexpr int QUADS = L::BN / 4, ROWS = THREADS / QUADS;
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

// ---- the two-launch yardstick's matmul: codes by TMA --------------------------

template <int TOK, int CH>
__global__ void __launch_bounds__(Q8Layout<TOK, CH>::THREADS) qmm_s8_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w, Q8Args a) {
  using L = Q8Layout<TOK, CH>;
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

  int acc[CH / 64][TOK / 2] = {};
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
    if (tid < TOK) sxs[tid] = m0 + tid < a.o.m ? __ldg(a.sx + m0 + tid) : 0.f;
    q8_consume<TOK, CH>(acc, smem, full, empty, L::STAGES, n_steps, warp >> 2, [](int) {});
  }
  q8_epilogue<TOK, CH, L::THREADS>(acc, smem, sxs, a.o, cluster, n_split, rank, n0, m0);
}

// ---- the one-launch kernel: the rows quantized inside -------------------------

// The 16 values of code chunk cc (values 16 cc .. 16 cc + 15 of the step's
// 128) of row r of an activation slot: boxes of [TOK][128 bytes] (32 f32 or
// 64 bf16 values), 16-byte chunk c of row r at c ^ (r % 8).
template <int TOK, bool BF16>
__device__ __forceinline__ void slot_chunk(const unsigned char* slot, int r, int cc, float (&v)[16]) {
  if constexpr (BF16) {
    const unsigned char* row = slot + (cc >> 2) * TOK * 128 + r * 128;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint4 u = *reinterpret_cast<const uint4*>(row + ((((cc & 3) * 2 + i) ^ (r & 7)) << 4));
      const unsigned words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        v[8 * i + 2 * w] = __uint_as_float(words[w] << 16);
        v[8 * i + 2 * w + 1] = __uint_as_float(words[w] & 0xffff0000u);
      }
    }
  } else {
    const unsigned char* row = slot + (cc >> 1) * TOK * 128 + r * 128;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 f = *reinterpret_cast<const float4*>(row + ((((cc & 1) * 4 + i) ^ (r & 7)) << 4));
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
  }
}

// Value e of that chunk, from shared memory: the rare value quantize16
// leaves to the IEEE division.
template <int TOK, bool BF16>
__device__ __forceinline__ float slot_value(const unsigned char* slot, int r, int cc, int e) {
  if constexpr (BF16) {
    const int lc = (cc & 3) * 2 + (e >> 3);
    const unsigned short h = *reinterpret_cast<const unsigned short*>(
        slot + (cc >> 2) * TOK * 128 + r * 128 + ((lc ^ (r & 7)) << 4) + (e & 7) * 2);
    return __uint_as_float(static_cast<unsigned>(h) << 16);
  } else {
    const int lc = (cc & 1) * 4 + (e >> 2);
    return *reinterpret_cast<const float*>(slot + (cc >> 1) * TOK * 128 + r * 128 + ((lc ^ (r & 7)) << 4) +
                                           (e & 3) * 4);
  }
}

// The conversion's work, by producer groups of 128 threads: the converting
// warpgroup (group 0), and, where the rank's K range is resident, each
// consumer warpgroup too (groups 1.., a share of each step while its
// previous step's wgmma runs). c is the thread's index in its group; thread
// 0 of group 0 issues every TMA load. Thread c takes code chunk cc = (c / 8)
// % 8 of rows c % 8 + 8 (c / 64) + 16 j for its group's j (j = group,
// group + groups, ... < TOK / 16): the 8 lanes of a quarter warp read and
// write 8 rows' chunks, in 8 different bank groups.
//
// Activation loads are numbered: l < n (pass 1: step l), then n + i - A
// (pass 2's i-th step from the end of pass 1's slots on, i >= A: step i -
// A); load l goes to slot l % A and completes phase l / A of its mbarrier.
// A slot is loaded again only after the converting warpgroup, its only
// reader then, is done with it (convert_sync).
template <int TOK, int CH>
struct Q8Convert {
  using L = Q8Layout<TOK, CH>;
  static constexpr int ROWS = TOK / 16;  // 16-row blocks of the tile

  unsigned char* smem;  // the ring
  unsigned char* act;   // the activation slots
  uint64_t *full, *empty, *afull;
  const CUtensorMap *px, *pw;
  int stages, slots, n_steps, s_begin, m0, n0, c, group, groups;

  __device__ bool loader() const { return group == 0 && c == 0; }
  __device__ int cc() const { return (c >> 3) & 7; }
  __device__ int row(int j) const { return (c & 7) + 8 * (c >> 6) + 16 * j; }
  // Pass 2 starts with the steps pass 1 left in their slots.
  __device__ int step_of(int i) const { return (i + (n_steps > slots ? n_steps - slots : 0)) % n_steps; }

  template <int EB>
  __device__ void load_x(int l) const {
    constexpr int SLOT = TOK * Q8_BK * EB;
    const int slot = l % slots, step = l < n_steps ? l : l - n_steps;
    unsigned char* dst = act + slot * SLOT;
    mbar_expect_tx(&afull[slot], SLOT);
#pragma unroll
    for (int b = 0; b < EB; ++b) {
      tma_load_2d(dst + b * TOK * 128, px, (s_begin + step) * Q8_BK + b * (128 / EB), m0, &afull[slot]);
    }
  }

  __device__ void load_w(int i) const {  // the weights of pass 2's i-th step
    const int st = i % stages;
    mbar_expect_tx(&full[st], L::W_BYTES);
    tma_load_2d(smem + st * L::STAGE + L::X_BYTES, pw, (s_begin + step_of(i)) * Q8_BK, n0, &full[st]);
  }

  // Pass 1: the loads from kernel entry, then the rows' partial absmax over
  // the rank's K range into pmax (as int bits: non-negative floats order as
  // their bits).
  template <bool BF16>
  __device__ void pass1(float* pmax) const {
    constexpr int EB = BF16 ? 2 : 4;
    if (loader()) {
      for (int l = 0; l < min(slots, n_steps); ++l) load_x<EB>(l);
      for (int i = 0; i < min(stages, n_steps); ++i) load_w(i);
    }
    float amax[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) amax[j] = 0.f;
    for (int l = 0; l < n_steps; ++l) {
      const int slot = l % slots;
      mbar_wait(&afull[slot], (l / slots) & 1);
      const unsigned char* src = act + slot * (TOK * Q8_BK * EB);
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        if (j % groups != group) continue;
        float v[16];
        slot_chunk<TOK, BF16>(src, row(j), cc(), v);
#pragma unroll
        for (int e = 0; e < 16; ++e) amax[j] = fmaxf(amax[j], fabsf(v[e]));
      }
      if (l + slots < n_steps) {
        convert_sync();
        if (loader()) load_x<EB>(l + slots);
      }
    }
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {  // lanes l, l ^ 8, l ^ 16, l ^ 24 share rows; two warps cover a row's chunks
      if (j % groups != group) continue;
      float m = fmaxf(amax[j], __shfl_xor_sync(0xffffffffu, amax[j], 8));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
      if ((c & 31) < 8) atomicMax(reinterpret_cast<int*>(pmax) + row(j), __float_as_int(m));
    }
  }

  // The tile's row scales (group 0), after the cluster barrier that follows
  // pass 1: the max over the ranks' partials of each row.
  __device__ void scales(cg::cluster_group& cluster, int n_split, int rank, const float* pmax, float* sxs,
                         float* sinv) const {
    if (c < TOK) {
      float mx = 0.f;
      for (int q = 0; q < n_split; ++q) {
        mx = fmaxf(mx, q == rank ? pmax[c] : *cluster.map_shared_rank(pmax + c, q));
      }
      const float scale = row_scale(mx);
      sxs[c] = scale;
      sinv[c] = quantize_inv(scale);
    }
  }

  // The group's share of pass 2's i-th step: its codes into the step's ring
  // stage, once the consumers have freed it.
  template <bool BF16>
  __device__ void produce(int i, const float* sxs, const float* sinv) const {
    constexpr int EB = BF16 ? 2 : 4;
    const int st = i % stages;
    mbar_wait(&empty[st], ((i / stages) & 1) ^ 1);
    if (loader() && i >= stages) load_w(i);
    int slot;
    if (i < slots) {
      slot = step_of(i) % slots;
    } else {
      const int l = n_steps + i - slots;
      slot = l % slots;
      mbar_wait(&afull[slot], (l / slots) & 1);
    }
    const unsigned char* src = act + slot * (TOK * Q8_BK * EB);
    unsigned char* dst = smem + st * L::STAGE;
#pragma unroll 1
    for (int j = group; j < ROWS; j += groups) {
      float v[16];
      const int r = row(j);
      slot_chunk<TOK, BF16>(src, r, cc(), v);
      unsigned exact;
      unsigned char* out = dst + r * 128 + ((cc() ^ (r & 7)) << 4);
      *reinterpret_cast<uint4*>(out) = quantize16(v, sinv[r], exact);
      while (exact) {  // rare: a value near a half-integer takes the IEEE division
        const int e = __ffs(exact) - 1;
        exact &= exact - 1;
        out[e] = static_cast<unsigned char>(quantize_code(slot_value<TOK, BF16>(src, r, cc(), e), sxs[r]));
      }
    }
    fence_proxy_async();  // the codes, written by threads, are read by wgmma (the async proxy)
    mbar_arrive(&full[st]);
  }

  // Pass 2 of the converting warpgroup: its share of every step in order,
  // reloading a slot once it is done with it.
  template <bool BF16>
  __device__ void pass2(const float* sxs, const float* sinv) const {
    constexpr int EB = BF16 ? 2 : 4;
    for (int i = 0; i < n_steps; ++i) {
      produce<BF16>(i, sxs, sinv);
      if (i + slots < n_steps) {
        convert_sync();
        if (loader()) load_x<EB>(n_steps + i);
      }
    }
  }
};

template <int TOK, int CH>
__global__ void __launch_bounds__(Q8XLayout<TOK, CH>::THREADS, TOK == 64 ? 2 : 1) qmm_w8a8_kernel(
    const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w, Q8XArgs a) {
  using L = Q8Layout<TOK, CH>;
  using X = Q8XLayout<TOK, CH>;
  extern __shared__ unsigned char q8_raw[];
  unsigned char* smem = smem_align(q8_raw);
  const int eb = a.x_bf16 ? 2 : 4;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + X::region(a.stages, a.slots, eb));
  uint64_t* empty = full + a.stages;
  uint64_t* afull = empty + a.stages;
  float* sxs = reinterpret_cast<float*>(afull + a.slots);  // the tile's TOK row scales
  float* sinv = sxs + TOK;                                 // their quantize_inv
  float* pmax = sinv + TOK;                                // the rank's partial absmax of each row

  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n0 = (blockIdx.x / n_split) * L::BN, m0 = blockIdx.y * TOK;
  const int steps = (a.k + Q8_BK - 1) / Q8_BK;
  const int s_begin = rank * steps / n_split, s_end = (rank + 1) * steps / n_split;
  const int n_steps = s_end - s_begin;
  const int tid = threadIdx.x, warp = tid >> 5;
  // Resident (no slot loaded twice): the consumer warpgroups convert too.
  const int groups = a.slots >= n_steps ? 1 + L::WGS : 1;

  if (tid == L::CONSUMERS) {
    prefetch_tensormap(&tm_x);
    prefetch_tensormap(&tm_w);
  }
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1 + Q8_CONVERT * groups);  // the weights' bytes and the codes' writers
      mbar_init(&empty[s], L::CONSUMERS);
    }
    for (int s = 0; s < a.slots; ++s) mbar_init(&afull[s], 1);
    mbar_init_fence();
  }
  if (tid < TOK) pmax[tid] = 0.f;
  __syncthreads();

  const bool converter = tid >= L::CONSUMERS;
  const Q8Convert<TOK, CH> cv{smem, smem + a.stages * L::STAGE, full, empty, afull, &tm_x, &tm_w,
                              a.stages, a.slots, n_steps, s_begin, m0, n0, tid & (Q8_CONVERT - 1),
                              converter ? 0 : 1 + (warp >> 2), groups};
  if (converter || groups > 1) {
    if (a.x_bf16) {
      cv.template pass1<true>(pmax);
    } else {
      cv.template pass1<false>(pmax);
    }
  }
  cluster_or_block_sync(cluster, n_split);  // every rank's pass 1 done: its pmax is read by the others
  if (converter) cv.scales(cluster, n_split, rank, pmax, sxs, sinv);
  __syncthreads();  // the scales, for every group that converts

  int acc[CH / 64][TOK / 2] = {};
  if (converter) {
    if (a.x_bf16) {
      cv.template pass2<true>(sxs, sinv);
    } else {
      cv.template pass2<false>(sxs, sinv);
    }
  } else if (groups > 1) {
    // A share of step 0 first; then, while step i's wgmma runs, of step i + 1.
    const auto help = [&](int i) {
      if (a.x_bf16) {
        cv.template produce<true>(i, sxs, sinv);
      } else {
        cv.template produce<false>(i, sxs, sinv);
      }
    };
    help(0);
    q8_consume<TOK, CH>(acc, smem, full, empty, a.stages, n_steps, warp >> 2, [&](int i) {
      if (i + 1 < n_steps) help(i + 1);
    });
  } else {
    q8_consume<TOK, CH>(acc, smem, full, empty, a.stages, n_steps, warp >> 2, [](int) {});
  }
  q8_epilogue<TOK, CH, X::THREADS>(acc, smem, sxs, a.o, cluster, n_split, rank, n0, m0);
}

template <int TOK, int CH>
int max_clusters(int split) {
  using L = Q8Layout<TOK, CH>;
  static bool smem_allowed = false;
  return max_active_clusters(qmm_s8_wgmma_kernel<TOK, CH>, L::THREADS, L::SMEM, smem_allowed, split);
}

template <int TOK, int CH>
int max_clusters_fused(int split, int smem) {
  static bool smem_allowed = false;
  return max_active_clusters(qmm_w8a8_kernel<TOK, CH>, Q8XLayout<TOK, CH>::THREADS, smem, smem_allowed, split);
}

template <int TOK, int CH>
cudaError_t launch_s8(const Q8Args& a, int split, cudaStream_t st) {
  using L = Q8Layout<TOK, CH>;
  CUtensorMap tm_x, tm_w;
  cudaError_t e = tensor_map_2d(&tm_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.xq, a.k, a.o.m, a.k, Q8_BK, TOK);
  if (e != cudaSuccess) return e;
  e = tensor_map_2d(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.w, a.k, a.o.n, a.k, Q8_BK, L::BN);
  if (e != cudaSuccess) return e;
  static bool smem_allowed = false;
  e = allow_smem(qmm_s8_wgmma_kernel<TOK, CH>, L::SMEM, smem_allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid(((a.o.n + L::BN - 1) / L::BN) * split, (a.o.m + TOK - 1) / TOK);
  return launch_clustered(qmm_s8_wgmma_kernel<TOK, CH>, grid, L::THREADS, L::SMEM, split, st, tm_x, tm_w, a);
}

template <int TOK, int CH>
cudaError_t launch_fused(const void* x, const int8_t* w, const Q8XArgs& a, int split, cudaStream_t st) {
  using L = Q8Layout<TOK, CH>;
  using X = Q8XLayout<TOK, CH>;
  const int eb = a.x_bf16 ? 2 : 4;
  const int steps = (a.k + Q8_BK - 1) / Q8_BK, most = (steps + split - 1) / split;
  const int smem = X::smem(a.stages, a.slots, eb);
  // a single stage deadlocks a rank of two or more steps (the consumers free a stage one step late)
  if (a.stages < 1 || a.slots < 1 || (a.stages < 2 && most > 1) || smem > static_cast<int>(MAX_SMEM)) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap tm_x, tm_w;
  cudaError_t e = tensor_map_2d(&tm_x, a.x_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                x, a.k, a.o.m, static_cast<uint64_t>(a.k) * eb, 128 / eb, TOK);
  if (e != cudaSuccess) return e;
  e = tensor_map_2d(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, a.k, a.o.n, a.k, Q8_BK, L::BN);
  if (e != cudaSuccess) return e;
  static bool smem_allowed = false;
  e = allow_smem(qmm_w8a8_kernel<TOK, CH>, smem, smem_allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid(((a.o.n + L::BN - 1) / L::BN) * split, (a.o.m + TOK - 1) / TOK);
  return launch_clustered(qmm_w8a8_kernel<TOK, CH>, grid, X::THREADS, smem, split, st, tm_x, tm_w, a);
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
  const rt::Q8Args a{codes, sx, k, w_t, {m, n, scales, bias, act, out, out_bf16}};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tok == 64 && ch == 64) return static_cast<int>(rt::launch_s8<64, 64>(a, split, st));
  if (tok == 128 && ch == 64) return static_cast<int>(rt::launch_s8<128, 64>(a, split, st));
  if (tok == 128 && ch == 128) return static_cast<int>(rt::launch_s8<128, 128>(a, split, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

// The one-launch kernel's cluster capacity at `smem` bytes of shared memory
// a block (quant_matmul.py cluster_capacity).
extern "C" int rt_quant_matmul_w8a8_fused_clusters(int tok, int ch, int split, int smem) {
  if (split < 1 || split > rt::Q8_MAX_CLUSTER || smem < 0 || smem > static_cast<int>(rt::MAX_SMEM)) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  if (tok == 64 && ch == 64) return rt::max_clusters_fused<64, 64>(split, smem);
  if (tok == 128 && ch == 64) return rt::max_clusters_fused<128, 64>(split, smem);
  if (tok == 128 && ch == 128) return rt::max_clusters_fused<128, 128>(split, smem);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// Its shared memory a block (quant_matmul.py w8a8_smem, held to it by a card test).
extern "C" int rt_quant_matmul_w8a8_fused_smem(int tok, int ch, int stages, int slots, int x_bf16) {
  const int eb = x_bf16 ? 2 : 4;
  if (tok == 64 && ch == 64) return rt::Q8XLayout<64, 64>::smem(stages, slots, eb);
  if (tok == 128 && ch == 64) return rt::Q8XLayout<128, 64>::smem(stages, slots, eb);
  if (tok == 128 && ch == 128) return rt::Q8XLayout<128, 128>::smem(stages, slots, eb);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// The one-launch W8A8 matmul on f32 or bf16 rows x [m, k]: tok, ch and split
// from quant_matmul.py w8a8_plan, stages and slots from w8a8_layout.
extern "C" int rt_quant_matmul_w8a8_fused(
    const void* x, int x_bf16, int m, int k,
    const int8_t* w_t, const float* scales, const float* bias, int n,
    int act, void* out, int out_bf16, int tok, int ch, int split, int stages, int slots,
    void* stream) {
  if (m < 1 || n < 1 || k < 16 || k % 16 || (m + 63) / 64 > 65535 ||
      (reinterpret_cast<uintptr_t>(x) & 15) || (reinterpret_cast<uintptr_t>(w_t) & 15) ||
      split < 1 || split > rt::Q8_MAX_CLUSTER || split > (k + rt::Q8_BK - 1) / rt::Q8_BK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const rt::Q8XArgs a{x_bf16, k, stages, slots, {m, n, scales, bias, act, out, out_bf16}};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tok == 64 && ch == 64) return static_cast<int>(rt::launch_fused<64, 64>(x, w_t, a, split, st));
  if (tok == 128 && ch == 64) return static_cast<int>(rt::launch_fused<128, 64>(x, w_t, a, split, st));
  if (tok == 128 && ch == 128) return static_cast<int>(rt::launch_fused<128, 128>(x, w_t, a, split, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
