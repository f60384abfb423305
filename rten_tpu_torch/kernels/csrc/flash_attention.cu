// flash_attention: tiled online-softmax attention for prefill,
//
//     out = softmax(q @ k^T * sm_scale + mask) @ v
//
// with q [B, Hq, Tq, D] and k, v [B, Hk, S, D] (GQA: q head h reads k/v
// head h / (Hq / Hk), no repeat), per-row q_offset and kv_len read on the
// device, causal or not. Every operand is addressed by its own (batch, head,
// position) strides with D contiguous, so the decoder passes q as a view of
// its packed qkv and receives the output in a [B, Tq, Hq, D] buffer without
// a copy either way.
//
// Replaces rten_tpu/kernels/attention.py flash_attention (:117; Pallas
// kernel _flash_kernel :29) and keeps every part of its function: the mask
// value -0.7 * f32 max (not -inf), the running max and sum in f32, KV tiles
// wholly past kv_len or wholly above the diagonal skipped and never read,
// kv_len clamped to [0, S], P rounded to v's dtype before P.V (the sum l
// from the unrounded P), and 0 for a row with l = 0 (kv_len 0).
//
// Bound on the H100: operations at long prompts (4 * D operations per
// (query, key) pair against 2 * D bytes of k and v per key, reused by all
// rows of a q tile); bytes, and above all latency, for short prompts and
// the chunks of <= 8 rows.
//
// What the first design (kept below as the f32 path) lost time on:
// both products on the CUDA cores in f32, K and V staged synchronously and
// converted to f32 one tile at a time behind two barriers, a grid of (q
// tiles, Hq, B) that put 12 blocks on 132 SMs for a 24-row prompt, and
// every query head of a GQA group staging its kv head's tiles again.
//
// bf16 (the main path), flash_mma_kernel:
// - Both products on the tensor cores with mma.sync.m16n8k16 (bf16 in, f32
//   accumulate): S = Q K^T with Q's fragments in registers for the whole
//   loop, then P (f32, rounded to bf16) reused in registers as the A
//   operand of O += P V, with V read through ldmatrix.trans. Four warps, 16
//   rows each. Not wgmma: at this path's shapes the work is at most ~0.4
//   GFLOP a call (Tq 512, 12 heads), under 2 us even at a third of
//   mma.sync's rate, so the time is latency and the grid, not the
//   tensor-core rate; mma.sync keeps each warp's softmax in its own
//   registers and lets a 64-row tile mix the query heads of a GQA group.
// - K/V tiles of 64 positions in a ring of FB_STAGES bf16 stages filled by
//   cp.async (16 bytes a thread, zero-filled past kv_len, so the tiles need
//   no masking for NaN), one barrier a tile; nothing converts to f32 in
//   shared memory.
// - GQA: a block's 64 rows are (query, head of the group) pairs, query
//   major, so the group's heads share the block's K/V stages and the causal
//   bound stays that of the block's last query.
// - Split-KV where (row tiles x Hk x B) leaves most SMs idle (attention.py
//   flash_plan): a cluster of C blocks (C <= 8) shares a row tile; rank r
//   walks KV tiles [r n / C, (r + 1) n / C) of the n its rows need (n read
//   on the device: kv_len, q_offset). Each rank leaves (m, l, acc) in its
//   shared memory; after a cluster barrier rank r combines a 1/C slice of
//   the tile over ranks 0..C-1 in that order through distributed shared
//   memory (the same bits on every launch) and writes it normalised.
//
// f32 (exact f32 products, no TF32), flash_kernel, the first design:
// - One block of 256 threads per (64-row q tile, q head, batch row). A loop
//   over 64-position K/V tiles inside the block, up to min(kv_len,
//   q_offset + tile end), takes the place of the TPU's sequential kv grid
//   axis; the running max, sum and output accumulator stay in f32
//   registers across it. The block reads its row's q_offset and kv_len
//   itself (the TPU's scalar prefetch).
// - The q tile, each K and V tile and the P tile sit in shared memory with
//   rows padded by one float, so the column reads of the two products hit
//   distinct banks. Only positions below kv_len are read from memory; the
//   rest of a tile is zero.
// - Thread (ty, tx) owns query rows ty + 16 i (i < 4): scores of columns
//   tx + 16 j (j < 4) and output columns tx + 16 j (j < D / 16). A row's
//   maximum and sum reduce over its 16 threads, which share one half-warp.
//
// Head dims: both kernels have instances at D = 16, 32, 64, 128 and 256.
// A head dim d between them (8, 24, 80 for Phi-2, 96 for Phi-3-mini, ...;
// the JAX kernel takes any) runs the next instance up: its rows land in the
// first d columns of the D-wide tiles and the columns past d are zero
// (loads predicated by column, so q . k and P . V are those of d columns),
// and only d columns are stored. Rows are read in pieces of the largest
// size (16, 8, 4 or 2 bytes) that divides every row start and d's bytes
// (`gran`), by cp.async (bf16; a 2-byte piece by a plain load) or by 16-byte
// or scalar loads (f32), so a view whose rows are not 16-byte aligned is
// read as it is.
//
// Above 256 (the JAX kernel takes d as one block, whatever it is) the 256
// instance's WIDE build cuts d into C = ceil(d / 256) column chunks, and a block owns one
// output slice of 256 columns (chunk `slice`; grid x counts row tiles times
// C). For each KV tile it sums the scores over all C chunks of q and k into
// the same f32 scores, then runs the softmax and P.V on its own slice of v,
// whose columns past d are zero as above. The f32 kernel stages chunk after
// chunk behind its barriers; the bf16 kernel makes each KV tile C + 1 steps
// of its ring (q chunk and k chunk, ..., then v's slice), q no longer
// resident. So each of the C blocks of a row tile computes the whole q . k
// again: the scores cost C times the operations of one pass (d 512: the
// products take 1.5 times those of a single block), and the shared memory
// stays that of the 256 instance (bf16 168,960 bytes, f32 214,016).

#include <cooperative_groups.h>

#include <initializer_list>

#include "hopper.cuh"
#include "tile_mma.cuh"

namespace rt {
namespace {

namespace cg = cooperative_groups;

constexpr int FA_BQ = 64, FA_BK = 64, FA_THREADS = 256;
constexpr float FA_MASK = -0.7f * 3.4028234663852886e38f;  // attention.py DEFAULT_MASK_VALUE

struct FlashArgs {
  const void* q;            // element strides: batch, head, position; D contiguous
  long long q_sb, q_sh, q_st;
  const void* k;
  long long k_sb, k_sh, k_ss;
  const void* v;
  long long v_sb, v_sh, v_ss;
  void* o;
  long long o_sb, o_sh, o_st;
  const int* q_offset;  // [B] or null (0)
  const int* kv_len;    // [B] or null (S)
  int hq, hk, tq, s, causal;
  float sm_scale;
  int d;     // head dim: the instance's D, or fewer columns of it
  int gran;  // bytes of a piece of a row: 16, 8, 4 or 2 (every row start and d's bytes a multiple)
};

// Rows [row0, row0 + n_valid) of a [*, d] f32 operand (row stride `stride`
// elements) into a 64-row tile with row stride D + 1; rows past n_valid and
// columns past d are zero. 16-byte loads where the rows allow (vec), else
// one float at a time.
template <int D>
__device__ __forceinline__ void stage_tile(float* dst, const float* src, long long stride, int row0,
                                           int n_valid, int d, bool vec) {
  constexpr int VN = 4;         // floats per 16-byte load
  constexpr int VPR = D / VN;   // loads per row
  for (int i = threadIdx.x; i < FA_BQ * VPR; i += FA_THREADS) {
    const int r = i / VPR, c = (i % VPR) * VN;
    float f[VN];
    if (r < n_valid && c < d && vec) {  // vec: d % 4 == 0, so the 4 columns are d's
      load16(src + (row0 + r) * stride + c, f);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) f[e] = r < n_valid && c + e < d ? src[(row0 + r) * stride + c + e] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) dst[r * (D + 1) + c + e] = f[e];
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// WIDE: a head dim above D (the 256 instance only), in column chunks.
template <int D, bool WIDE>
__global__ void __launch_bounds__(FA_THREADS) flash_kernel(FlashArgs a) {
  constexpr int LD = D + 1, LP = FA_BK + 1, DJ = D / 16;
  extern __shared__ float4 fa_smem[];
  float* qs = reinterpret_cast<float*>(fa_smem);  // [BQ][LD]
  float* ks = qs + FA_BQ * LD;                    // [BK][LD]
  float* vs = ks + FA_BK * LD;                    // [BK][LD]
  float* ps = vs + FA_BK * LD;                    // [BQ][LP]

  // WIDE: C column chunks, this block's output slice.
  const int n_chunks = WIDE ? (a.d + D - 1) / D : 1;
  const int qt = blockIdx.x / n_chunks, slice = blockIdx.x - qt * n_chunks;
  const int col0 = slice * D, d_out = min(D, a.d - col0);
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.hq / a.hk);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qt * FA_BQ;
  const int q_off = (a.causal && a.q_offset) ? a.q_offset[b] : 0;
  const int kv_len = min(max(a.kv_len ? a.kv_len[b] : a.s, 0), a.s);
  // Columns at or past kv_len, and (causal) past the tile's last row, are
  // masked for every row of the tile: their KV tiles are never read.
  const int kv_end = a.causal ? min(kv_len, q_off + q0 + FA_BQ) : kv_len;
  const int n_tiles = kv_end > 0 ? (kv_end + FA_BK - 1) / FA_BK : 0;

  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const bool vec = a.gran == 16;
  const int nq = min(FA_BQ, a.tq - q0);
  if (n_chunks == 1) stage_tile<D>(qs, qp, a.q_st, q0, nq, a.d, vec);

  float m_i[4], l_i[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * FA_BK, nk = min(FA_BK, kv_len - c0);
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int ch = 0; ch < n_chunks; ++ch) {  // one pass below 257 columns
      const int cc = ch * D, dc = min(D, a.d - cc);
      __syncthreads();  // the previous chunk's or tile's readers (and the q staging) are done
      if (n_chunks > 1) stage_tile<D>(qs, qp + cc, a.q_st, q0, nq, dc, vec);
      stage_tile<D>(ks, kp + cc, a.k_ss, c0, nk, dc, vec);
      if (ch == n_chunks - 1) stage_tile<D>(vs, vp + col0, a.v_ss, c0, nk, d_out, vec);
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < D; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q_off + q0 + ty + 16 * i;  // absolute position of the query
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        const bool ok = col < kv_len && (!a.causal || col <= row);
        s[i][j] = ok ? s[i][j] * a.sm_scale : FA_MASK;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], half_warp_max(mx));
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        ps[(ty + 16 * i) * LP + tx + 16 * j] = p;  // v's dtype: no rounding in f32
      }
      l_i[i] = alpha * l_i[i] + half_warp_sum(rs);
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < FA_BK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  float* op = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh + col0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= a.tq) continue;
    const float inv = l_i[i] == 0.f ? 1.f : 1.f / l_i[i];
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      if (tx + 16 * j < d_out) op[r * a.o_st + tx + 16 * j] = acc[i][j] * inv;
    }
  }
}

template <int D, bool WIDE>
cudaError_t launch_flash(const FlashArgs& a, int b, cudaStream_t st) {
  constexpr size_t smem = (3 * FA_BQ * (D + 1) + FA_BQ * (FA_BK + 1)) * sizeof(float);
  static bool smem_allowed = false;
  const cudaError_t e = allow_smem(flash_kernel<D, WIDE>, smem, smem_allowed);
  if (e != cudaSuccess) return e;
  const int slices = WIDE ? (a.d + D - 1) / D : 1;
  const dim3 grid((a.tq + FA_BQ - 1) / FA_BQ * slices, a.hq, b);
  flash_kernel<D, WIDE><<<grid, FA_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}


// ---- bf16: tensor cores, cp.async ring, split-KV across a cluster --------

constexpr int FB_ROWS = 64, FB_KV = 64, FB_THREADS = 128;
constexpr int FB_MAX_CLUSTER = 8;  // attention.py MAX_SPLIT

template <int D>
struct FbLayout {
  static constexpr int LD = D + 8;                  // bf16 row stride: ldmatrix rows in distinct banks
  static constexpr int STAGES = D <= 64 ? 3 : 2;    // K/V ring depth
  static constexpr bool QREG = D <= 128;            // Q's fragments in registers (else reread each tile)
  static constexpr int TILE = FB_ROWS * LD;         // bf16 elements of a Q, K or V tile
  static constexpr int SMEM = (1 + 2 * STAGES) * TILE * 2;
  static constexpr int LDO = D + 4;                 // f32 row stride of the split partials
  static_assert((FB_ROWS * LDO + 2 * FB_ROWS) * 4 <= SMEM, "the partials reuse the tiles");
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }

template <int D, bool WIDE>
__global__ void __launch_bounds__(FB_THREADS) flash_mma_kernel(FlashArgs a) {
  using L = FbLayout<D>;
  constexpr int LD = L::LD;
  extern __shared__ float4 fb_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(fb_smem);
  __nv_bfloat16* ring = qs + L::TILE;  // stage s: K at ring + 2 s TILE, V after it

  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int hkv = blockIdx.y, b = blockIdx.z;
  const int group = a.hq / a.hk, rows = a.tq * group;
  // WIDE: C column chunks; a KV tile is C + 1 ring steps (q and k chunk c
  // at step c, v's slice at step C), else one.
  const int n_chunks = WIDE ? (a.d + D - 1) / D : 1;
  const int spt = n_chunks == 1 ? 1 : n_chunks + 1;
  const int tile_slice = blockIdx.x / n_split, rt = tile_slice / n_chunks;
  const int col0 = (tile_slice - rt * n_chunks) * D, d_out = min(D, a.d - col0);
  const int r0 = rt * FB_ROWS;  // packed row r = query r / group, head r % group
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, mat = lane >> 3, r8 = lane & 7;

  const int q_off = (a.causal && a.q_offset) ? a.q_offset[b] : 0;
  const int kv_len = min(max(a.kv_len ? a.kv_len[b] : a.s, 0), a.s);
  const int last_q = min(r0 + FB_ROWS - 1, rows - 1) / group;
  const int kv_end = a.causal ? min(kv_len, q_off + last_q + 1) : kv_len;
  const int n_tiles = kv_end > 0 ? (kv_end + FB_KV - 1) / FB_KV : 0;
  const int t_begin = rank * n_tiles / n_split;
  const int n_mine = (rank + 1) * n_tiles / n_split - t_begin;

  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + hkv * a.k_sh;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + hkv * a.v_sh;

  // A row's D * 2 bytes in pieces of a.gran: piece c of the tile is row
  // c >> lp, elements [e, e + pe) with e = (c & (pieces - 1)) * pe, read
  // where cc + e < d (columns from cc on; gran divides d's bytes and cc is
  // a multiple of 256, so a piece is all in or all out).
  const int gr = a.gran, pe = gr / 2, lp = ilog2(D * 2) - (__ffs(gr) - 1);
  const auto q_rows = [&](__nv_bfloat16* dst, int cc) {
    for (int c = tid; c < FB_ROWS << lp; c += FB_THREADS) {
      const int r = c >> lp, e = (c & ((1 << lp) - 1)) * pe, pr = r0 + r;
      const bool ok = pr < rows && cc + e < a.d;
      const __nv_bfloat16* src =
          ok ? qp + (hkv * group + pr % group) * a.q_sh + (long long)(pr / group) * a.q_st + cc + e : qp;
      copy_piece(dst + r * LD + e, src, ok, gr);
    }
  };
  // Positions c0 .. c0 + 63 of k or v (columns from cc on) into dst.
  const auto kv_rows = [&](__nv_bfloat16* dst, const __nv_bfloat16* base, long long stride, int c0, int cc) {
    for (int c = tid; c < FB_KV << lp; c += FB_THREADS) {
      const int r = c >> lp, e = (c & ((1 << lp) - 1)) * pe;
      const bool ok = c0 + r < kv_len && cc + e < a.d;
      copy_piece(dst + r * LD + e, ok ? base + (c0 + r) * stride + cc + e : base, ok, gr);
    }
  };
  if (n_chunks == 1) q_rows(qs, 0);
  cp_async_commit();
  // Ring step u: KV tile t_begin + u / spt; one step a tile: its K and V;
  // else q and k chunk c (q in the stage's second tile) or, at c = C, v's slice.
  auto load_step = [&](int u, int stage) {
    const int i = u / spt, c = u - i * spt, c0 = (t_begin + i) * FB_KV;
    __nv_bfloat16* s0 = ring + 2 * stage * L::TILE;
    __nv_bfloat16* s1 = s0 + L::TILE;
    if (spt == 1) {
      for (int p = tid; p < FB_KV << lp; p += FB_THREADS) {
        const int r = p >> lp, e = (p & ((1 << lp) - 1)) * pe;
        const bool ok = c0 + r < kv_len && e < a.d;
        const long long pos = ok ? c0 + r : 0;
        copy_piece(s0 + r * LD + e, kp + pos * a.k_ss + (ok ? e : 0), ok, gr);
        copy_piece(s1 + r * LD + e, vp + pos * a.v_ss + (ok ? e : 0), ok, gr);
      }
    } else if (c < n_chunks) {
      kv_rows(s0, kp, a.k_ss, c0, c * D);
      q_rows(s1, c * D);
    } else {
      kv_rows(s0, vp, a.v_ss, c0, col0);
    }
  };
  const int n_steps = n_mine * spt;
#pragma unroll
  for (int s = 0; s < L::STAGES - 1; ++s) {
    if (s < n_steps) load_step(s, s);
    cp_async_commit();
  }
  cp_async_wait<L::STAGES - 1>();  // the Q group
  __syncthreads();

  uint32_t qf[L::QREG ? D / 16 : 1][4];
  const auto q_frag = [&](const __nv_bfloat16* qt, int kk, uint32_t (&f)[4]) {
    ldmatrix_x4(f, qt + (warp * 16 + r8 + (mat & 1) * 8) * LD + kk * 16 + (mat >> 1) * 8);
  };
  if constexpr (L::QREG) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) q_frag(qs, kk, qf[kk]);
  }
  // This thread's rows: warp * 16 + g and + 8; their queries' absolute positions.
  const int lr0 = warp * 16 + g;
  const int qpos[2] = {q_off + (r0 + lr0) / group, q_off + (r0 + lr0 + 8) / group};
  float m_i[2] = {-INFINITY, -INFINITY}, l_i[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  float s[8][4];
  for (int u = 0; u < n_steps; ++u) {
    cp_async_wait<L::STAGES - 2>();  // step u has landed (this thread's copies) ...
    __syncthreads();                 // ... everyone's, and step u - 1's stage is free
    if (u + L::STAGES - 1 < n_steps) load_step(u + L::STAGES - 1, (u + L::STAGES - 1) % L::STAGES);
    cp_async_commit();
    const int i = u / spt, c = u - i * spt;
    const __nv_bfloat16* st0 = ring + 2 * (u % L::STAGES) * L::TILE;
    const __nv_bfloat16* st1 = st0 + L::TILE;

    if (c == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    }
    if (c < n_chunks) {  // the scores over k (chunk c of q . k)
      const __nv_bfloat16* qt = spt == 1 ? qs : st1;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t(&qk)[4] = qf[L::QREG ? kk : 0];
        if constexpr (!L::QREG) q_frag(qt, kk, qk);
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) {  // key positions jn * 16 .. + 15: two n8 tiles
          unsigned bfr[4];
          ldmatrix_x4(bfr, st0 + (jn * 16 + r8 + (mat >> 1) * 8) * LD + kk * 16 + (mat & 1) * 8);
          mma_bf16(s[2 * jn], qk, bfr[0], bfr[1]);
          mma_bf16(s[2 * jn + 1], qk, bfr[2], bfr[3]);
        }
      }
    }
    if (spt > 1 && c < n_chunks) continue;  // the tile's v step follows
    const __nv_bfloat16* vs = spt == 1 ? st1 : st0;
    const int c0 = (t_begin + i) * FB_KV;

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + 8 * j + 2 * t + (e & 1);
        const bool ok = col < kv_len && (!a.causal || col <= qpos[e >> 1]);
        s[j][e] = ok ? s[j][e] * a.sm_scale : FA_MASK;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m_i[h], quad_max(mx[h]));
      alpha[h] = expf(m_i[h] - m_new);
      m_i[h] = m_new;
    }
    float rs[2] = {0.f, 0.f};
    uint32_t pa[4][4];  // P as the A operand of P V: k16 chunk j / 2
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = expf(s[j][e] - m_i[e >> 1]);
        rs[e >> 1] += p[e];
      }
      pa[j >> 1][(j & 1) * 2] = pack_bf16x2(p[0], p[1]);
      pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16x2(p[2], p[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_i[h] = alpha[h] * l_i[h] + quad_sum(rs[h]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // key positions kk * 16 .. + 15
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        unsigned bfr[4];
        ldmatrix_x4_trans(bfr, vs + (kk * 16 + (mat & 1) * 8 + r8) * LD + dn * 16 + (mat >> 1) * 8);
        mma_bf16(o[2 * dn], pa[kk], bfr[0], bfr[1]);
        mma_bf16(o[2 * dn + 1], pa[kk], bfr[2], bfr[3]);
      }
    }
  }
  cp_async_wait<0>();

  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb;
  if (n_split == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pr = r0 + lr0 + 8 * h;
      if (pr >= rows) continue;
      const float inv = l_i[h] == 0.f ? 1.f : 1.f / l_i[h];
      __nv_bfloat16* row = op + (hkv * group + pr % group) * a.o_sh + (long long)(pr / group) * a.o_st + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * t;
        if (gr >= 4 && col < d_out) {  // d even and the pair 4-byte aligned
          *reinterpret_cast<__nv_bfloat162*>(row + col) =
              __floats2bfloat162_rn(o[j][2 * h] * inv, o[j][2 * h + 1] * inv);
        } else {
          if (col < d_out) row[col] = __float2bfloat16(o[j][2 * h] * inv);
          if (col + 1 < d_out) row[col + 1] = __float2bfloat16(o[j][2 * h + 1] * inv);
        }
      }
    }
    return;
  }

  // Split: (m, l, acc) of the 64 rows into this block's shared memory, then
  // rank r combines its slice of the tile over ranks 0..C-1 in order.
  __syncthreads();  // every warp is done with the tiles
  float* red_o = reinterpret_cast<float*>(fb_smem);  // [64][LDO]
  float* red_m = red_o + FB_ROWS * L::LDO;           // [64]
  float* red_l = red_m + FB_ROWS;                    // [64]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int lr = lr0 + 8 * h;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(red_o + lr * L::LDO + 8 * j + 2 * t) = make_float2(o[j][2 * h], o[j][2 * h + 1]);
    }
    if (t == 0) {
      red_m[lr] = m_i[h];
      red_l[lr] = l_i[h];
    }
  }
  cluster.sync();
  // Four neighbouring d of a row a thread, every rank's (m, l, acc) load in
  // flight before the fixed-order sums.
  constexpr int V = FB_ROWS * D / 4;
  const int v_end = (rank + 1) * V / n_split;
  for (int v = rank * V / n_split + tid; v < v_end; v += FB_THREADS) {
    const int lr = v / (D / 4), d = (v % (D / 4)) * 4, pr = r0 + lr;
    if (pr >= rows) continue;
    float mq[FB_MAX_CLUSTER], lq[FB_MAX_CLUSTER];
    float4 oq[FB_MAX_CLUSTER];
#pragma unroll
    for (int q = 0; q < FB_MAX_CLUSTER; ++q) {
      if (q < n_split) {
        mq[q] = *cluster.map_shared_rank(red_m + lr, q);
        lq[q] = *cluster.map_shared_rank(red_l + lr, q);
        oq[q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(red_o + lr * L::LDO + d, q));
      }
    }
    float m_all = -INFINITY;
#pragma unroll
    for (int q = 0; q < FB_MAX_CLUSTER; ++q)
      if (q < n_split) m_all = fmaxf(m_all, mq[q]);
    float l_sum = 0.f;
    float4 o_sum = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m_all != -INFINITY) {
#pragma unroll
      for (int q = 0; q < FB_MAX_CLUSTER; ++q) {
        if (q < n_split) {
          const float w = expf(mq[q] - m_all);
          l_sum += w * lq[q];
          o_sum = make_float4(o_sum.x + w * oq[q].x, o_sum.y + w * oq[q].y, o_sum.z + w * oq[q].z,
                              o_sum.w + w * oq[q].w);
        }
      }
    }
    const float inv = l_sum == 0.f ? 1.f : 1.f / l_sum;
    __nv_bfloat16* dst =
        op + (hkv * group + pr % group) * a.o_sh + (long long)(pr / group) * a.o_st + col0 + d;
    if (gr >= 8 && d < d_out) {  // d % 4 == 0 and the four 8-byte aligned
      uint2 packed;
      packed.x = pack_bf16x2(o_sum.x * inv, o_sum.y * inv);
      packed.y = pack_bf16x2(o_sum.z * inv, o_sum.w * inv);
      *reinterpret_cast<uint2*>(dst) = packed;
    } else {
      const float f[4] = {o_sum.x, o_sum.y, o_sum.z, o_sum.w};
      for (int e = 0; e < 4 && d + e < d_out; ++e) dst[e] = __float2bfloat16(f[e] * inv);
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <int D, bool WIDE>
cudaError_t launch_flash_mma(const FlashArgs& a, int b, int split, cudaStream_t st) {
  using L = FbLayout<D>;
  static bool smem_allowed = false;
  cudaError_t e = allow_smem(flash_mma_kernel<D, WIDE>, L::SMEM, smem_allowed);
  if (e != cudaSuccess) return e;
  const int row_tiles = (a.tq * (a.hq / a.hk) + FB_ROWS - 1) / FB_ROWS;
  const int slices = WIDE ? (a.d + D - 1) / D : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_tiles * slices * split, a.hk, b);
  cfg.blockDim = dim3(FB_THREADS);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;  // a plain launch is a cluster of one
  e = cudaLaunchKernelEx(&cfg, flash_mma_kernel<D, WIDE>, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace
}  // namespace rt

// split (1..8: blocks of a cluster along the KV axis) comes from
// attention.py flash_plan; the f32 path ignores it. The instances: head
// dims 16, 32, 64, 128 and 256, a head dim d <= 256 running the smallest
// that holds it (its columns past d zero), any larger d the 256 one in
// slices of 256 columns; d < 1 launches nothing.
extern "C" int rt_flash_attention(
    const void* q, long long q_sb, long long q_sh, long long q_st,
    const void* k, long long k_sb, long long k_sh, long long k_ss,
    const void* v, long long v_sb, long long v_sh, long long v_ss,
    void* o, long long o_sb, long long o_sh, long long o_st,
    const int* q_offset, const int* kv_len,
    int bf16, int b, int hq, int hk, int tq, int s, int d, int causal, float sm_scale, int split,
    void* stream) {
  if (b < 1 || b > 65535 || hq < 1 || hq > 65535 || hk < 1 || hq % hk || tq < 1 || s < 1 || split < 1 ||
      split > rt::FB_MAX_CLUSTER || d < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // The piece size: the lowest set bit of every row start's and d's bytes, at most 16.
  const long long elt = bf16 ? 2 : 4;
  unsigned long long bits = 16 | (unsigned long long)(d * elt);
  for (const void* p : {q, k, v, static_cast<const void*>(o)}) bits |= reinterpret_cast<uintptr_t>(p);
  for (long long st : {q_sb, q_sh, q_st, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_st}) {
    bits |= (unsigned long long)(st * elt);
  }
  const int gran = static_cast<int>(bits & (~bits + 1));
  const rt::FlashArgs a{q, q_sb, q_sh, q_st, k, k_sb, k_sh, k_ss, v, v_sb, v_sh, v_ss,
                        o, o_sb, o_sh, o_st, q_offset, kv_len, hq, hk, tq, s, causal, sm_scale, d, gran};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto run = [&](auto dd, auto wide) {
    constexpr int D = decltype(dd)::value;
    constexpr bool WIDE = decltype(wide)::value;
    return bf16 ? rt::launch_flash_mma<D, WIDE>(a, b, split, st) : rt::launch_flash<D, WIDE>(a, b, st);
  };
  const std::false_type narrow{};
  cudaError_t e;
  if (d <= 16) {
    e = run(std::integral_constant<int, 16>{}, narrow);
  } else if (d <= 32) {
    e = run(std::integral_constant<int, 32>{}, narrow);
  } else if (d <= 64) {
    e = run(std::integral_constant<int, 64>{}, narrow);
  } else if (d <= 128) {
    e = run(std::integral_constant<int, 128>{}, narrow);
  } else if (d <= 256) {
    e = run(std::integral_constant<int, 256>{}, narrow);
  } else {
    e = run(std::integral_constant<int, 256>{}, std::true_type{});
  }
  return static_cast<int>(e);
}
