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
// from the unrounded P; in f32 P is not rounded), and 0 for a row with
// l = 0 (kv_len 0).
//
// Bound on the H100: operations at long prompts (4 * D operations per
// (query, key) pair against 2 * D bytes of k and v per key, reused by all
// rows of a q tile); bytes, and above all latency, for short prompts and
// the chunks of <= 8 rows.
//
// One kernel, flash_mma_kernel<T, D, WIDE>, for both element types T (bf16,
// the decoders' main path, and f32, the encoders', vision models' and
// lifted dense models'):
// - Both products on the tensor cores with mma.sync.m16n8k16 (bf16 in, f32
//   accumulate): S = Q K^T, then P (f32) reused in registers as the A
//   operand of O += P V. Four warps, 16 rows each. Not wgmma: at this
//   path's shapes the work is at most ~0.4 GFLOP a call (Tq 512, 12
//   heads), under 2 us even at a third of mma.sync's rate, so the time is
//   latency and the grid, not the tensor-core rate; mma.sync keeps each
//   warp's softmax in its own registers and lets a 64-row tile mix the
//   query heads of a GQA group.
// - K/V tiles of 64 positions in a ring of FbLayout::STAGES stages in T,
//   filled by cp.async (zero-filled past kv_len, so the tiles need no
//   masking for NaN), one barrier a tile.
// - GQA: a block's 64 rows are (query, head of the group) pairs, query
//   major, so the group's heads share the block's K/V stages and the causal
//   bound stays that of the block's last query.
// - Split-KV where (row tiles x Hk x B) leaves most SMs idle (attention.py
//   flash_plan, both types): a cluster of C blocks (C <= 8) shares a row
//   tile; rank r walks KV tiles [r n / C, (r + 1) n / C) of the n its rows
//   need (n read on the device: kv_len, q_offset). Each rank leaves (m, l,
//   acc) in its shared memory; after a cluster barrier rank r combines a
//   1/C slice of the tile over ranks 0..C-1 in that order through
//   distributed shared memory (the same bits on every launch) and writes it
//   normalised.
//
// bf16: K/V tiles in a ring of 3 stages (2 from D 128); Q's fragments
// (ldmatrix) in registers for the whole loop up to D 128; K through
// ldmatrix, V through ldmatrix.trans; P rounded to bf16 as the A operand;
// O = O * alpha + P V in the accumulators.
//
// f32 (products as exact as f32 FMA, no TF32): every operand is split into
// three bf16 parts, x = hi + mid + lo (tile_mma.cuh split3: exact where
// |x| >= 2^-110), and each product is the six mma.sync of weight 2^-16 and
// above (mma_split6: hi.hi, hi.mid, mid.hi, hi.lo, mid.mid, lo.hi). A bf16
// x bf16 product is exact in f32; the three dropped products (mid.lo,
// lo.mid, lo.lo) are each under 2^-22 of |a||b| (nominally 2^-24), the
// size of one f32 rounding, so S and P.V stay within the f32 FMA loop's
// error (tests/test_torch_cuda.py F32_FLASH_F64_TOL, against an f64
// softmax). Six passes at the bf16 rate cost what three TF32 passes would.
// - The split is the work: ~8 instructions an element against 6 mma.sync
//   a 16 x 8 x 16 product. Each f32 K / V tile lands by cp.async in a
//   one-stage ring and is split once for the block, four columns a
//   thread, into three bf16 part tiles in the bf16 kernel's layout; the
//   products then read the parts by ldmatrix (three where bf16 reads one).
//   Each warp splitting its own fragments from the f32 tiles instead (each
//   of the four warps splitting the whole tile) ran at 0.96-1.6x the speed
//   of the CUDA-core kernel it replaced, slower at ViT's 197 positions.
// - Per KV tile: wait for its f32 tiles, barrier, split them, barrier;
//   the ring stage is then free, so the next tile's copies are in flight
//   during this tile's products.
// - Q is split once, from the f32 tile staged where V's parts go: up to
//   D 32 into K's part tiles and from there into registers (3 x D/16 x 4),
//   from D 64 into three part tiles of its own, reread by ldmatrix each KV
//   tile (at 64, 48 resident registers spilled 68 bytes at 255; reread,
//   181 registers and 1.5% faster at the encoders' shapes).
// - Each accumulator's six mma.sync run as one chain: interleaving four
//   chains pass by pass measured the same at D 64 and spilled at D 128.
// - The sums: the tensor cores' f32 accumulation truncates, so a long chain
//   of mma.sync into one accumulator drifts (quant_matmul.cu's f32 route
//   found one over K 3072 10x past an FMA loop). Each k16 step's six
//   products accumulate from zero, the smallest first, and the step's sum
//   is added into the scores (S) or into the tile's P.V (two n8 tiles, 8
//   registers) on the CUDA cores; O = O * alpha + the tile's P.V by FMA.
//   Chained over a tile's whole reduction instead (D/16 x 6 mma for S, 4 x
//   6 for P.V), the f64 test's error was 2.3-4x an FMA loop's on the CUDA
//   cores at D 128, over 1500 positions and at d 320.
// - Shared memory (FbLayout): the ring's K and V in f32 (rows of D
//   floats), their six bf16 parts (rows of D + 8), and from D 64 Q's three:
//   26,624 bytes at D 16, 47,104 at 32, 115,712 at 64 (two blocks an SM),
//   222,208 at 128 (169,984 WIDE; one block). No f32 instance at 256
//   (435,200 bytes), so a head dim above 128 runs the 128 instance's WIDE
//   build (below), a block per 128 output columns.
//
// Head dims: instances at D = 16, 32, 64 and 128 (both types) and 256
// (bf16). A head dim d between them (8, 24, 80 for Phi-2, 96 for
// Phi-3-mini, ...; the JAX kernel takes any) runs the next instance up: its
// rows land in the first d columns of the D-wide tiles and the columns past
// d are zero (loads predicated by column, so q . k and P . V are those of d
// columns), and only d columns are stored. Rows are read in pieces of the
// largest size (16, 8, 4 or 2 bytes) that divides every row start and d's
// bytes (`gran`), by cp.async (a 2-byte bf16 piece by a plain load), so a
// view whose rows are not 16-byte aligned is read as it is.
//
// Above the widest instance (256 in bf16, 128 in f32; the JAX kernel takes
// d as one block, whatever it is) its WIDE build cuts d into C = ceil(d / D)
// column chunks, and a block owns one output slice of D columns (chunk
// `slice`; grid x counts row tiles times C). Each KV tile is C + 1 steps of
// its ring (q chunk and k chunk, ..., then v's slice), q no longer
// resident: it sums the scores over all C chunks into the same f32 scores,
// then runs the softmax and P.V on its own slice of v, whose columns past d
// are zero as above. So each of the C blocks of a row tile computes the
// whole q . k again: the scores cost C times the operations of one pass
// (bf16 d 512: the products take 1.5 times those of a single block; f32
// d 256: 1.5 times, d 512: 2.5 times), and the shared memory stays that of
// the widest instance.

#include <cooperative_groups.h>

#include <initializer_list>
#include <type_traits>

#include "hopper.cuh"
#include "tile_mma.cuh"

namespace rt {
namespace {

namespace cg = cooperative_groups;

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

constexpr int FB_ROWS = 64, FB_KV = 64, FB_THREADS = 128;
constexpr int FB_MAX_CLUSTER = 8;  // attention.py MAX_SPLIT

template <typename T, int D, bool WIDE>
struct FbLayout {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int LD = D + 8;  // bf16 row stride of a tile or split part: ldmatrix rows in distinct banks
  // Ring of T tiles: bf16 STAGES stages of K and V (Q apart); f32 one stage,
  // free again once its tiles are split into parts.
  static constexpr int STAGES = F32 ? 1 : D <= 64 ? 3 : 2;
  static constexpr bool QREG = D <= (F32 ? 32 : 128);  // Q's fragments in registers (else reread each tile)
  static constexpr int LDT = F32 ? D : LD;             // row stride of the ring's T tiles
  static constexpr int TILE = FB_ROWS * LDT;           // elements of a ring tile
  static constexpr int PART = FB_ROWS * LD;            // bf16 elements of a bf16 tile or split part
  // f32: the ring's K and V, K's and V's three parts, and Q's where Q's
  // fragments are reread from shared memory (one pass over d: not WIDE).
  static constexpr int QPART_BYTES = F32 && !QREG && !WIDE ? 3 * PART * 2 : 0;
  static constexpr int SMEM = F32 ? 2 * TILE * 4 + 6 * PART * 2 + QPART_BYTES : (1 + 2 * STAGES) * PART * 2;
  static constexpr int LDO = D + 4;  // f32 row stride of the split partials
  static_assert((FB_ROWS * LDO + 2 * FB_ROWS) * 4 <= SMEM, "the partials reuse the tiles");
  static_assert(SMEM <= (int)MAX_SMEM, "a block's shared memory");
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

template <typename T, int D, bool WIDE>
__global__ void __launch_bounds__(FB_THREADS) flash_mma_kernel(FlashArgs a) {
  using L = FbLayout<T, D, WIDE>;
  constexpr bool F32 = L::F32;
  constexpr int LD = L::LD, LDT = L::LDT, PART = L::PART;
  constexpr int NP = F32 ? 3 : 1;  // parts of an operand: bf16 one, f32 hi, mid, lo
  extern __shared__ float4 fb_smem[];
  // bf16: Q, then the ring. f32: the ring, K's parts, V's parts (Q staged
  // there first, and WIDE's q chunks), Q's parts.
  T* ring = reinterpret_cast<T*>(fb_smem) + (F32 ? 0 : PART);  // stage s: K at ring + 2 s TILE, V after it
  __nv_bfloat16* kpart = reinterpret_cast<__nv_bfloat16*>(reinterpret_cast<float*>(fb_smem) + 2 * L::TILE);
  __nv_bfloat16* vpart = kpart + 3 * PART;
  __nv_bfloat16* qpart = vpart + 3 * PART;
  T* qs = F32 ? reinterpret_cast<T*>(vpart) : reinterpret_cast<T*>(fb_smem);

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

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + hkv * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + hkv * a.v_sh;

  // A row's D * sizeof(T) bytes in pieces of a.gran: piece c of the tile is
  // row c >> lp, elements [e, e + pe) with e = (c & (pieces - 1)) * pe,
  // read where cc + e < d (columns from cc on; gran divides d's bytes and
  // cc is a multiple of D, so a piece is all in or all out).
  const int gr = a.gran, pe = gr / (int)sizeof(T), lp = ilog2(D * (int)sizeof(T)) - (__ffs(gr) - 1);
  const auto q_rows = [&](T* dst, int cc) {
    for (int c = tid; c < FB_ROWS << lp; c += FB_THREADS) {
      const int r = c >> lp, e = (c & ((1 << lp) - 1)) * pe, pr = r0 + r;
      const bool ok = pr < rows && cc + e < a.d;
      const T* src = ok ? qp + (hkv * group + pr % group) * a.q_sh + (long long)(pr / group) * a.q_st + cc + e : qp;
      copy_piece(dst + r * LDT + e, src, ok, gr);
    }
  };
  // Positions c0 .. c0 + 63 of k or v (columns from cc on) into dst.
  const auto kv_rows = [&](T* dst, const T* base, long long stride, int c0, int cc) {
    for (int c = tid; c < FB_KV << lp; c += FB_THREADS) {
      const int r = c >> lp, e = (c & ((1 << lp) - 1)) * pe;
      const bool ok = c0 + r < kv_len && cc + e < a.d;
      copy_piece(dst + r * LDT + e, ok ? base + (c0 + r) * stride + cc + e : base, ok, gr);
    }
  };
  // f32: a ring tile's 64 rows into their three bf16 parts at dst (hi, mid,
  // lo PART apart; split3), four columns a thread, once for the block.
  const auto split_tile = [&](const float* src, __nv_bfloat16* dst) {
    for (int i = tid; i < FB_ROWS * D / 4; i += FB_THREADS) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      const float4 x = *reinterpret_cast<const float4*>(src + r * D + c);
      unsigned h0, m0, l0, h1, m1, l1;
      split3_pair(x.x, x.y, h0, m0, l0);
      split3_pair(x.z, x.w, h1, m1, l1);
      __nv_bfloat16* row = dst + r * LD + c;
      *reinterpret_cast<uint2*>(row) = make_uint2(h0, h1);
      *reinterpret_cast<uint2*>(row + PART) = make_uint2(m0, m1);
      *reinterpret_cast<uint2*>(row + 2 * PART) = make_uint2(l0, l1);
    }
  };
  if (n_chunks == 1) q_rows(qs, 0);
  cp_async_commit();
  // Ring step u: KV tile t_begin + u / spt; one step a tile: its K and V;
  // else q and k chunk c (q in the stage's second tile) or, at c = C, v's slice.
  auto load_step = [&](int u, int stage) {
    const int i = u / spt, c = u - i * spt, c0 = (t_begin + i) * FB_KV;
    T* s0 = ring + 2 * stage * L::TILE;
    T* s1 = s0 + L::TILE;
    if (spt == 1) {
      for (int p = tid; p < FB_KV << lp; p += FB_THREADS) {
        const int r = p >> lp, e = (p & ((1 << lp) - 1)) * pe;
        const bool ok = c0 + r < kv_len && e < a.d;
        const long long pos = ok ? c0 + r : 0;
        copy_piece(s0 + r * LDT + e, kp + pos * a.k_ss + (ok ? e : 0), ok, gr);
        copy_piece(s1 + r * LDT + e, vp + pos * a.v_ss + (ok ? e : 0), ok, gr);
      }
    } else if (c < n_chunks) {
      kv_rows(s0, kp, a.k_ss, c0, c * D);
      q_rows(s1, c * D);
    } else {
      kv_rows(s0, vp, a.v_ss, c0, col0);
    }
  };
  const int n_steps = n_mine * spt;
  constexpr int PRE = F32 ? 1 : L::STAGES - 1;  // steps in flight before the loop
#pragma unroll
  for (int s = 0; s < PRE; ++s) {
    if (s < n_steps) load_step(s, s);
    cp_async_commit();
  }
  cp_async_wait<PRE>();  // the Q group
  __syncthreads();

  // Q's fragments: bf16 one set, f32 its three parts (hi, mid, lo).
  unsigned qf[L::QREG ? D / 16 : 1][NP][4];
  const auto q_frag = [&](const __nv_bfloat16* qt, int kk, unsigned (&f)[NP][4]) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      ldmatrix_x4(f[p], qt + p * PART + (warp * 16 + r8 + (mat & 1) * 8) * LD + kk * 16 + (mat >> 1) * 8);
    }
  };
  // f32: Q's parts, into K's part tiles (free until the loop) where the
  // fragments stay in registers, else into Q's own; WIDE reads q by chunks.
  if constexpr (F32 && !WIDE) {
    split_tile(reinterpret_cast<const float*>(qs), L::QREG ? kpart : qpart);
    __syncthreads();
  }
  if constexpr (L::QREG) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) q_frag(F32 ? kpart : reinterpret_cast<const __nv_bfloat16*>(qs), kk, qf[kk]);
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
    const int i = u / spt, c = u - i * spt;
    // The step's bf16 tiles: Q (non-resident), K and V; f32 their hi parts,
    // mid and lo PART after each.
    const __nv_bfloat16 *qt, *kt, *vt;
    if constexpr (F32) {
      cp_async_wait<0>();  // step u has landed (this thread's copies) ...
      __syncthreads();     // ... everyone's, and the parts of step u - 1 are free
      const float* st0 = reinterpret_cast<const float*>(ring);
      if (spt == 1 || c < n_chunks) {
        split_tile(st0, kpart);
        split_tile(st0 + L::TILE, vpart);  // V, or WIDE's q chunk
      } else {
        split_tile(st0, vpart);
      }
      __syncthreads();  // the parts are ready and the ring stage free
      if (u + 1 < n_steps) load_step(u + 1, 0);
      cp_async_commit();
      qt = spt == 1 ? qpart : vpart;
      kt = kpart;
      vt = vpart;
    } else {
      cp_async_wait<L::STAGES - 2>();  // step u has landed (this thread's copies) ...
      __syncthreads();                 // ... everyone's, and step u - 1's stage is free
      if (u + L::STAGES - 1 < n_steps) load_step(u + L::STAGES - 1, (u + L::STAGES - 1) % L::STAGES);
      cp_async_commit();
      const __nv_bfloat16* st0 = ring + 2 * (u % L::STAGES) * L::TILE;
      const __nv_bfloat16* st1 = st0 + L::TILE;
      qt = spt == 1 ? reinterpret_cast<const __nv_bfloat16*>(qs) : st1;
      kt = st0;
      vt = spt == 1 ? st1 : st0;
    }

    if (c == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    }
    if (c < n_chunks) {  // the scores over k (chunk c of q . k)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        unsigned(&qk)[NP][4] = qf[L::QREG ? kk : 0];
        if constexpr (!L::QREG) q_frag(qt, kk, qk);
        if constexpr (F32) {
#pragma unroll
          for (int jn = 0; jn < 4; ++jn) {  // key positions jn * 16 .. + 15: two n8 tiles
            unsigned bfr[3][4];
#pragma unroll
            for (int p = 0; p < 3; ++p) {
              ldmatrix_x4(bfr[p], kt + p * PART + (jn * 16 + r8 + (mat >> 1) * 8) * LD + kk * 16 + (mat & 1) * 8);
            }
            mma_split6(s[2 * jn], qk, bfr, 0);
            mma_split6(s[2 * jn + 1], qk, bfr, 1);
          }
        } else {
#pragma unroll
          for (int jn = 0; jn < 4; ++jn) {  // key positions jn * 16 .. + 15: two n8 tiles
            unsigned bfr[4];
            ldmatrix_x4(bfr, kt + (jn * 16 + r8 + (mat >> 1) * 8) * LD + kk * 16 + (mat & 1) * 8);
            mma_bf16(s[2 * jn], qk[0], bfr[0], bfr[1]);
            mma_bf16(s[2 * jn + 1], qk[0], bfr[2], bfr[3]);
          }
        }
      }
    }
    if (spt > 1 && c < n_chunks) continue;  // the tile's v step follows
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
    // P as the A operand of P V, k16 chunk j / 2: bf16 rounded, f32 split.
    unsigned pa[4][NP][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = expf(s[j][e] - m_i[e >> 1]);
        rs[e >> 1] += p[e];
      }
      unsigned(&pj)[NP][4] = pa[j >> 1];
      if constexpr (F32) {
        split3_pair(p[0], p[1], pj[0][(j & 1) * 2], pj[1][(j & 1) * 2], pj[2][(j & 1) * 2]);
        split3_pair(p[2], p[3], pj[0][(j & 1) * 2 + 1], pj[1][(j & 1) * 2 + 1], pj[2][(j & 1) * 2 + 1]);
      } else {
        pj[0][(j & 1) * 2] = pack_bf16x2(p[0], p[1]);
        pj[0][(j & 1) * 2 + 1] = pack_bf16x2(p[2], p[3]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_i[h] = alpha[h] * l_i[h] + quad_sum(rs[h]);
    if constexpr (F32) {
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {  // output columns dn * 16 .. + 15: two n8 tiles
        float acc[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // key positions kk * 16 .. + 15
          unsigned bfr[3][4];
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            ldmatrix_x4_trans(bfr[p], vt + p * PART + (kk * 16 + (mat & 1) * 8 + r8) * LD + dn * 16 + (mat >> 1) * 8);
          }
          mma_split6(acc[0], pa[kk], bfr, 0);
          mma_split6(acc[1], pa[kk], bfr, 1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          o[2 * dn][e] = fmaf(o[2 * dn][e], alpha[e >> 1], acc[0][e]);
          o[2 * dn + 1][e] = fmaf(o[2 * dn + 1][e], alpha[e >> 1], acc[1][e]);
        }
      }
    } else {
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
          ldmatrix_x4_trans(bfr, vt + (kk * 16 + (mat & 1) * 8 + r8) * LD + dn * 16 + (mat >> 1) * 8);
          mma_bf16(o[2 * dn], pa[kk][0], bfr[0], bfr[1]);
          mma_bf16(o[2 * dn + 1], pa[kk][0], bfr[2], bfr[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  T* op = static_cast<T*>(a.o) + b * a.o_sb;
  if (n_split == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pr = r0 + lr0 + 8 * h;
      if (pr >= rows) continue;
      const float inv = l_i[h] == 0.f ? 1.f : 1.f / l_i[h];
      T* row = op + (hkv * group + pr % group) * a.o_sh + (long long)(pr / group) * a.o_st + col0;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int col = 8 * j + 2 * t;
        const float v0 = o[j][2 * h] * inv, v1 = o[j][2 * h + 1] * inv;
        if (gr >= 2 * (int)sizeof(T) && col < d_out) {  // d even and the pair aligned to its size
          if constexpr (F32) {
            *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(v0, v1);
          }
        } else {
          if (col < d_out) store_elt(row + col, v0);
          if (col + 1 < d_out) store_elt(row + col + 1, v1);
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
    T* dst = op + (hkv * group + pr % group) * a.o_sh + (long long)(pr / group) * a.o_st + col0 + d;
    const float f[4] = {o_sum.x * inv, o_sum.y * inv, o_sum.z * inv, o_sum.w * inv};
    if (gr >= 4 * (int)sizeof(T) && d < d_out) {  // d % 4 == 0 and the four aligned to their size
      if constexpr (F32) {
        *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
      } else {
        *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]));
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (d + e < d_out) store_elt(dst + e, f[e]);
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <typename T, int D, bool WIDE>
cudaError_t launch_flash_mma(const FlashArgs& a, int b, int split, cudaStream_t st) {
  using L = FbLayout<T, D, WIDE>;
  static bool smem_allowed = false;
  cudaError_t e = allow_smem(flash_mma_kernel<T, D, WIDE>, L::SMEM, smem_allowed);
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
  e = cudaLaunchKernelEx(&cfg, flash_mma_kernel<T, D, WIDE>, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The instance of head dim d: the smallest of 16 .. WIDEST that holds it,
// or WIDEST's WIDE build above it.
template <typename T, int WIDEST>
cudaError_t launch_for_head_dim(const FlashArgs& a, int b, int split, cudaStream_t st) {
  if (a.d <= 16) return launch_flash_mma<T, 16, false>(a, b, split, st);
  if (a.d <= 32) return launch_flash_mma<T, 32, false>(a, b, split, st);
  if (a.d <= 64) return launch_flash_mma<T, 64, false>(a, b, split, st);
  if (a.d <= 128) return launch_flash_mma<T, 128, false>(a, b, split, st);
  if constexpr (WIDEST == 256) {
    if (a.d <= 256) return launch_flash_mma<T, 256, false>(a, b, split, st);
  }
  return launch_flash_mma<T, WIDEST, true>(a, b, split, st);
}

}  // namespace
}  // namespace rt

// split (1..8: blocks of a cluster along the KV axis) comes from
// attention.py flash_plan. The instances: head dims 16, 32, 64, 128 and
// (bf16) 256, a head dim d up to the widest running the smallest that holds
// it (its columns past d zero), any larger d the widest one in slices of
// that many columns (attention.py flash_slices); d < 1 launches nothing.
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
  const cudaError_t e = bf16 ? rt::launch_for_head_dim<__nv_bfloat16, 256>(a, b, split, st)
                             : rt::launch_for_head_dim<float, 128>(a, b, split, st);
  return static_cast<int>(e);
}
