// decode_block: a whole transformer block of one decode token (batch 1) as
// one persistent cooperative kernel:
//
//     attn = softmax(q k^T / sqrt(D)) v   over the cache prefix + the new token
//     h    = attn @ W_o * s_o + b_o + residual            (f32, not rounded)
//     out  = act(norm2(h) @ W_up * s_up + b_up) @ W_down * s_down + b_down + h
//     qkv  = norm1_next(out_f32) @ W_qkv * s_qkv + b_qkv   (optional)
//
// with the new token's k/v appended to the [1, Hk, S, D] cache in place. Hq
// query heads over Hk kv heads (query head g reads kv head g / (Hq / Hk);
// Hq == Hk is MHA), given as three operands q [Hq, D], k_new and v_new
// [Hk, D]: three views of a packed MHA q|k|v row, or the RoPE'd q and k of
// a grouped-query (GQA / MQA) or RoPE model.
//
// Replaces the whole-block ("mega") mode of rten_tpu/kernels/
// decode_attention.py decode_attention (:734; _decode_attn_kernel's mega
// branch :118-148 and :357-405), which the JAX decoder takes under
// RTEN_DECODE_FUSE=mega at batch 1, packed (MHA without RoPE) or unpacked.
// Its numbers are the TPU kernel's, not those of decode_attention followed
// by quant_mlp_int8: the hidden state h after wo + bias + residual stays
// f32 (ln2 normalises it unrounded and the down projection adds it as its
// residual); the normalised row, the activated up row and the next-qkv
// input are rounded to the model dtype before their int8 dots (bf16 in a
// bf16 model); out and qkv are stored in the model dtype, and the next qkv
// normalises the f32 out. A row with no room (kv_len outside [0, S))
// appends nothing and its outputs are NaN.
//
// Bound on the H100: bytes, the four int8 weight matrices (7.08 MB at
// GPT-2-small with the next qkv, 6.0 MB at tiny_starcoder_py's) and the
// valid KV prefix, read once: ~2-3 us. What costs beyond that is latency:
// the first bytes of each matrix, the grid-wide waits, and one row's
// reductions.
//
// Design: one cooperative launch of one block of DB_THREADS threads on
// each SM (grid = the SM count, or the caller's), so that the blocks' shared
// memory together holds every weight of the layer.
//   - Weights resident from kernel entry. Block b owns the rows (output
//     columns) [b N / G, (b + 1) N / G) of each of the four matrices
//     ([N, K] int8, K contiguous): one contiguous run of bytes a matrix,
//     copied by 1-D bulk copies (cp.async.bulk on an mbarrier) into its
//     shared memory. The copies are issued at entry, right after the
//     block's first attention item and before kv_len is read, so the whole
//     weight stream runs under the attention and the grid-wide waits, as
//     the TPU kernel's DMAs run under its softmax. Each GEMV phase waits
//     only on its own runs' barriers. Where a block's runs do not all fit
//     its shared memory (a layer whose wo is far wider than its MLP), they
//     are cut into waves that do: wave 0 at entry, each later wave issued
//     as soon as the block has finished with the one before
//     (block_segments). One thread lays the runs out once, at entry, into
//     a table in shared memory: the phases read it, and no integer
//     division is left on a phase's path (a 64-bit one cost ~4 us a call on
//     the H100).
//     Nothing falls back to another kernel.
//   - Attention with the query group in one pass. The valid prefix plus
//     the new token is cut into chunks of DB_CHUNK positions; the items are
//     (chunk, kv head, tile of DB_GT query heads of the group), chunk-major,
//     strided over the blocks, so that MQA at kv_len 767 still spreads over
//     36 SMs and MHA over every SM. An item arrives by five bulk copies into
//     one of two stages: the chunk's K and V rows, the tile's q rows and the
//     kv head's new k and v (the block's first item's at entry, its
//     second's once kv_len has arrived). The item scores all the tile's
//     query heads against each K row in one pass (VPR
//     lanes a row, the row's slice in registers, the heads' q slices from
//     the stage), takes each head's chunk max and sum, and sums P.V by
//     (head, column pair) threads over the chunk's positions. Its
//     unnormalised state (P.V, max, sum) goes to an f32 scratch. The items
//     whose chunk holds kv_len write the new k/v into their stage, where it
//     is scored as any other row; tile 0 appends it to the cache, once per
//     kv head.
//   - No combine phase: after the first grid-wide wait every block reads
//     the states of every (head, chunk) straight from L2 and combines them
//     (a warp a head takes the chunks' maximum and denominator, a thread
//     per four outputs weighs the P.V rows, exp(m_c - M) / den, in chunk
//     order) into the dot operand of wo; nothing of it is staged in shared
//     memory, so a long cache needs no more of it. So the kernel has four
//     grid-wide waits with the next qkv (three without): attention | wo |
//     ln2 + up | down | next qkv.
//   - Short one-row phases: one round trip after each wait. Each block
//     reads the phase's input row once from L2 (data other blocks wrote
//     before the wait); its norm's scale and bias and each column's
//     epilogue operands (scale, bias, residual) were loaded into registers
//     before the wait. The row goes into shared memory as f32 (normalised,
//     rounded to the model dtype where the TPU rounds), permuted so that
//     lane c's float4 reads of its 16-byte chunk are conflict-free. A
//     column's dot is cut into pieces of DB_PIECE bytes of K; the (column
//     pair, piece) items go round the block's warps, lane l taking bytes
//     16 l and 512 + 16 l of the piece of both columns from shared memory, each byte turned to f32 by
//     a byte permute and one subtraction (unpack16) and multiplied on the
//     CUDA cores in f32 (exact products of int8 and bf16); the lanes' sums
//     add up across the warp, the pieces in order, then the epilogue by one
//     thread a column.
//   - Determinism: a column's sum order is fixed by K alone (pieces, lanes,
//     the warp's shuffle tree), an item's by (kv_len, shapes), the combine's
//     by the chunk count, and the norms are block reductions in a fixed
//     order; so the same inputs give the same bits from a grid of any size.
//   - The card's toolkit accepts a cooperative launch with a cluster
//     dimension (cudaLaunchKernelEx with both attributes; PERF.md), but the
//     combine needs every item's state in every block, which no cluster
//     spans: it goes through L2.
// Head dims: instances at 16, 32, 64 and 128 (the cache rows whole 16-byte
// bulk copies in either dtype). Head dims 8, 4, 2 and 1, which the JAX mega
// rule admits too (every divisor of 128), run the 16 instance with narrow
// rows: every thread of the block stages an item's rows (d elements each)
// into the stage's 16-wide rows in pieces of `gran` bytes (16, 8, 4, 2 or
// 1: the largest that divides d's bytes and every operand's address;
// cp.async from 4 bytes up, plain loads below, hopper.cuh copy_piece),
// the columns past d zero, so the scores and P.V run on 16 columns of
// which those past d add nothing; the items' states stay 16 + 4 floats a
// head, and the combine writes only each head's d outputs into wo's
// operand row (K = Hq d). The double-buffered item stages then wait on
// cp.async groups instead of an mbarrier. The score scale is the caller's
// 1 / sqrt(d).
// Data that other blocks wrote in an earlier phase is read with __ldcg
// (L2), never through the read-only path. A grid that cannot be co-resident
// is refused by the launch (cudaErrorCooperativeLaunchTooLarge); nothing
// falls back.

#include <cooperative_groups.h>

#include <initializer_list>

#include "hopper.cuh"

namespace rt {
namespace {

namespace cg = cooperative_groups;

constexpr int DB_THREADS = 512;
constexpr int DB_WARPS = DB_THREADS / 32;
constexpr int DB_CHUNK = 64;         // cache positions an attention item (kernels/decode_attention.py CHUNK)
constexpr int DB_GT = 4;             // query heads an attention item scores (a tile of the group)
constexpr int DB_PIECE = 1024;       // K bytes of a column a warp sums in one item
constexpr int DB_CB = 8;             // chunks' states a thread of the combine has in flight
constexpr int DB_MAX_SEG = 64;       // weight runs a block may have (each its own mbarrier)
constexpr int DB_PART = 2048;        // f32 piece sums of one batch of columns
constexpr int DB_PHASES = 4;         // wo, up, down, next qkv
constexpr int DB_MAX_DM = 4 * 4 * DB_THREADS;  // a normalised row: at most 4 float4 a thread
constexpr int DB_STAMPS = 20;        // %globaltimer stamps a block records in the TIMED build (decode_block_kernel)

struct DbPhase {
  const int8_t* w;     // [n, k] int8, k % 16 == 0, 16-byte aligned
  const float* scale;  // [n]
  const float* bias;   // [n] or null
  int n, k;
};

struct BlockArgs {
  // The attention of row 0.
  const void* q;       // [hq, d]
  const void* k_new;   // [hk, d]
  const void* v_new;
  void* k;             // [hk, cap, d]
  void* v;
  const int* kv_len;   // [1], the valid length before this token
  int hq, hk, cap, nc;  // nc: chunks of cap
  int tiles;           // head tiles of a group: ceil(group / DB_GT)
  int dh;              // the head dim: the instance's D, or 8, 4, 2 or 1 on the 16 one (narrow rows)
  int gran;            // bytes of a piece of a narrow row (a power of two up to 16)
  float sm_scale;
  float* part;         // [hq, nc, d + 4]: each item's per-head P.V, max and sum (state_floats)
  // The GEMV phases and their epilogues.
  DbPhase ph[DB_PHASES];
  int phases;          // 4 with the next qkv, else 3
  const void* residual;  // [dm] in the model dtype
  float* h_buf;        // [dm] f32 h
  float* u_buf;        // [ff] f32 activated up row
  float* out_f32;      // [dm] f32 block output (with the next qkv)
  void* out;           // [dm] model dtype
  void* qkv_out;       // [nq] model dtype
  const float* ln2_scale;
  const float* ln2_bias;
  const float* next_scale;
  const float* next_bias;
  int norm;            // 1 layernorm, 2 rmsnorm
  float eps;
  int act;
  // Shared-memory layout (db_layout) and instrumentation.
  int region;          // bytes of the weight region
  int uni_bytes;       // the attention scratch or the dot operand row (a union)
  long long* stamps;   // [grid, DB_STAMPS] %globaltimer stamps (the TIMED build only)
};

// A run of a block's weights: rows [r0, r1) of phase p at byte `off` of
// the region, in wave `wave`.
struct DbSeg {
  int p, r0, r1, off, wave;
};

// Offsets of the dynamic shared memory: the union (attention scratch in
// phase 1, the dot operand row after), the batch's piece sums, the block
// reductions' scratch, the run table (DB_MAX_SEG runs, then each phase's
// first run), the mbarriers (DB_MAX_SEG runs, 2 attention stages), the
// weight region.
struct DbLayout {
  int part, red, segs, seg_lo, bars, region, total;
};

__host__ __device__ __forceinline__ int align_to(int v, int a) { return (v + a - 1) / a * a; }

__host__ __device__ __forceinline__ DbLayout db_layout(int uni_bytes, int region) {
  DbLayout l;
  l.part = align_to(uni_bytes, 128);
  l.red = l.part + DB_PART * 4;
  l.segs = l.red + 64 * 4;
  l.seg_lo = l.segs + DB_MAX_SEG * (int)sizeof(DbSeg);
  l.bars = align_to(l.seg_lo + (DB_PHASES + 1) * 4, 16);
  l.region = align_to(l.bars + (DB_MAX_SEG + 2) * 8, 128);
  l.total = l.region + region;
  return l;
}

// Threads of the P.V sum that share a (head, column pair): the largest power
// of two that keeps every thread busy once (1 where the tile's pairs
// outnumber the threads).
__host__ __device__ __forceinline__ int pv_slices(int gt, int d) {
  const int pairs = gt * d / 2;
  int ts = 1;
  while (2 * ts * pairs <= DB_THREADS && ts < DB_CHUNK) ts *= 2;
  return ts;
}

// The attention scratch: two stages, each a chunk's K and V rows, the
// tile's q rows and the kv head's new k and v (all as the operands hold
// them); the scores, the maxima and sums, and the P.V slices. gt: heads of
// a tile (at most DB_GT).
template <typename T, int D>
struct DbAtt {
  static constexpr int ROW = D * (int)sizeof(T);
  static constexpr int TILE = DB_CHUNK * ROW;
  __host__ __device__ static int q(int) { return 2 * TILE; }            // within a stage: [gt, D]
  __host__ __device__ static int kn(int gt) { return q(gt) + gt * ROW; }  // [D], then v_new [D]
  __host__ __device__ static int stage(int gt) { return align_to(kn(gt) + 2 * ROW, 128); }
  __host__ __device__ static int sc(int gt) { return 2 * stage(gt); }
  __host__ __device__ static int ml(int gt) { return sc(gt) + gt * DB_CHUNK * 4; }
  __host__ __device__ static int pv(int gt) { return ml(gt) + align_to(2 * gt * 4, 16); }
  __host__ __device__ static int bytes(int gt) {
    const int ts = pv_slices(gt, D);
    return pv(gt) + (ts > 1 ? ts * gt * D * 4 : 0);
  }
};

// An item's state of one head in the f32 scratch: P.V [D], then max, sum.
__host__ __device__ __forceinline__ int state_floats(int d) { return d + 4; }

// Start of part i of `total` rows cut into `parts` (i * total < 2^31: the
// entry point checks).
__host__ __device__ __forceinline__ int range_at(int i, int total, int parts) { return i * total / parts; }

// Shared-memory float of natural column e of a row of k = 16 kc values:
// element t of float4 q of 16-byte chunk c sits at float4 q kc + c, so lane
// c's four float4 reads of chunk c are conflict-free across lanes. Four
// consecutive columns (e % 4 == 0) stay one float4.
__device__ __forceinline__ int perm_index(int e, int kc) {
  const int c = e >> 4, q = (e >> 2) & 3, t = e & 3;
  return ((q * kc + c) << 2) | t;
}

// The block's weight runs in the order the phases use them: for each phase
// the rows [b n / G, (b + 1) n / G), cut where the region is full; a cut
// starts a new wave at offset 0. f(run) for each; returns the count.
#pragma nv_exec_check_disable
template <typename F>
__host__ __device__ __forceinline__ int block_segments(const BlockArgs& a, int blk, int grid, const F& f) {
  int off = 0, wave = 0, j = 0;
  for (int p = 0; p < a.phases; ++p) {
    const int n = a.ph[p].n, k = a.ph[p].k;
    int r = range_at(blk, n, grid);
    const int hi = range_at(blk + 1, n, grid);
    while (r < hi) {
      const int fit = (a.region - off) / k;
      if (fit == 0) {
        ++wave;
        off = 0;
        continue;
      }
      const int cnt = min(fit, hi - r);
      f(DbSeg{p, r, r + cnt, off, wave});
      off += cnt * k;
      r += cnt;
      ++j;
    }
  }
  return j;
}

// Issue wave `wave` of the block's runs (`segs`, `n_segs` of them), one
// thread.
__device__ __forceinline__ void issue_wave(const BlockArgs& a, const DbSeg* segs, int n_segs, int wave,
                                           unsigned char* region, uint64_t* bars) {
  fence_proxy_async();
  for (int j = 0; j < n_segs; ++j) {
    const DbSeg s = segs[j];
    if (s.wave != wave) continue;
    const int k = a.ph[s.p].k;
    const unsigned bytes = (unsigned)(s.r1 - s.r0) * k;
    mbar_expect_tx(&bars[j], bytes);
    bulk_g2s(region + s.off, a.ph[s.p].w + (size_t)s.r0 * k, bytes, &bars[j]);
  }
}

// Attention item `it` = ((chunk c, kv head h), head tile t), chunk-major.
struct DbItem {
  int c, h, t, g0, gt;  // g0: the tile's first head of the group, gt: its heads
};

__device__ __forceinline__ DbItem item_at(const BlockArgs& a, int it) {
  DbItem r;
  const int per_chunk = a.hk * a.tiles, group = a.hq / a.hk;
  r.c = it / per_chunk;
  const int rem = it - r.c * per_chunk;
  r.h = rem / a.tiles;
  r.t = rem - r.h * a.tiles;
  r.g0 = r.t * DB_GT;
  r.gt = min(DB_GT, group - r.g0);
  return r;
}

// An item into a stage, by one thread: the chunk's K and V rows inside the
// cache, the tile's q rows and the kv head's new k and v; one barrier for
// the five copies.
template <typename T, int D>
__device__ __forceinline__ void issue_item(const BlockArgs& a, int it, unsigned char* stage, uint64_t* bar) {
  using A = DbAtt<T, D>;
  const DbItem m = item_at(a, it);
  const int gtile = min(DB_GT, a.hq / a.hk);  // the stage's layout: a full tile
  const int rows = min(DB_CHUNK, a.cap - m.c * DB_CHUNK);
  const unsigned bytes = (unsigned)rows * A::ROW;
  const size_t row0 = (size_t)m.h * a.cap + (size_t)m.c * DB_CHUNK;
  const size_t q0 = (size_t)m.h * (a.hq / a.hk) + m.g0;
  mbar_expect_tx(bar, 2 * bytes + (m.gt + 2) * A::ROW);
  bulk_g2s(stage, static_cast<const T*>(a.k) + row0 * D, bytes, bar);
  bulk_g2s(stage + A::TILE, static_cast<const T*>(a.v) + row0 * D, bytes, bar);
  bulk_g2s(stage + A::q(gtile), static_cast<const T*>(a.q) + q0 * D, m.gt * A::ROW, bar);
  bulk_g2s(stage + A::kn(gtile), static_cast<const T*>(a.k_new) + (size_t)m.h * D, A::ROW, bar);
  bulk_g2s(stage + A::kn(gtile) + A::ROW, static_cast<const T*>(a.v_new) + (size_t)m.h * D, A::ROW, bar);
}

// An item into a stage by every thread of the block, for narrow rows (head
// dims under 16 on the 16 instance): the same rows as issue_item, each of
// d elements into a stage row of D, in pieces of a.gran bytes, the pieces
// past d zero; cp.async in the caller's commit group (2- and 1-byte pieces
// by plain loads).
template <typename T, int D>
__device__ __forceinline__ void issue_item_narrow(const BlockArgs& a, int it, unsigned char* stage) {
  using A = DbAtt<T, D>;
  const DbItem m = item_at(a, it);
  const int gtile = min(DB_GT, a.hq / a.hk);
  const int rows = min(DB_CHUNK, a.cap - m.c * DB_CHUNK);
  const int dh = a.dh, pe = a.gran / (int)sizeof(T), ppr = D / pe;  // pieces a stage row
  const size_t row0 = (size_t)m.h * a.cap + (size_t)m.c * DB_CHUNK;
  const size_t q0 = (size_t)m.h * (a.hq / a.hk) + m.g0;
  T* kt = reinterpret_cast<T*>(stage);
  T* vt = reinterpret_cast<T*>(stage + A::TILE);
  T* qt = reinterpret_cast<T*>(stage + A::q(gtile));
  T* nt = reinterpret_cast<T*>(stage + A::kn(gtile));
  const int total = (2 * rows + m.gt + 2) * ppr;
  for (int p = threadIdx.x; p < total; p += DB_THREADS) {
    const int r = p / ppr, e = (p - r * ppr) * pe;
    const T* src;
    T* dst;
    if (r < rows) {
      src = static_cast<const T*>(a.k) + (row0 + r) * dh;
      dst = kt + r * D;
    } else if (r < 2 * rows) {
      src = static_cast<const T*>(a.v) + (row0 + r - rows) * dh;
      dst = vt + (r - rows) * D;
    } else if (r < 2 * rows + m.gt) {
      src = static_cast<const T*>(a.q) + (q0 + r - 2 * rows) * dh;
      dst = qt + (r - 2 * rows) * D;
    } else {
      const int j = r - 2 * rows - m.gt;  // 0: k_new, 1: v_new
      src = static_cast<const T*>(j ? a.v_new : a.k_new) + (size_t)m.h * dh;
      dst = nt + j * D;
    }
    const bool ok = e < dh;
    copy_piece(dst + e, ok ? src + e : src, ok, a.gran);
  }
}

// One attention item whose stage has landed: the append (tile 0 of the
// chunk that holds kv_len), the tile's scores, softmax statistics and P.V,
// written to the f32 scratch.
template <typename T, int D>
__device__ __forceinline__ void attend_item(const BlockArgs& a, int it, int len, unsigned char* uni,
                                            unsigned char* stage) {
  using A = DbAtt<T, D>;
  constexpr int VN = 16 / sizeof(T);  // elements of a 16-byte vector
  constexpr int VPR = D / VN;         // lanes a cache row
  constexpr int RPW = 32 / VPR;       // rows a warp scores at a time
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const DbItem m = item_at(a, it);
  const int gtile = min(DB_GT, a.hq / a.hk), gt = m.gt;
  const int start = m.c * DB_CHUNK, npos = min(DB_CHUNK, len + 1 - start);
  T* kt = reinterpret_cast<T*>(stage);
  T* vt = reinterpret_cast<T*>(stage + A::TILE);
  const T* qt = reinterpret_cast<const T*>(stage + A::q(gtile));
  const T* nt = reinterpret_cast<const T*>(stage + A::kn(gtile));  // k_new, then v_new
  float* sc = reinterpret_cast<float*>(uni + A::sc(gtile));
  float* mls = reinterpret_cast<float*>(uni + A::ml(gtile));
  float* pv = reinterpret_cast<float*>(uni + A::pv(gtile));

  const int t_new = len - start, dh = D == 16 ? a.dh : D;
  if (t_new < DB_CHUNK && tid < 2 * D) {  // the new token: into the cache once per kv head, and the stage
    const bool is_v = tid >= D;
    const int e = is_v ? tid - D : tid;
    if (e < dh) {
      const T val = nt[tid];
      if (m.t == 0) static_cast<T*>(is_v ? a.v : a.k)[((size_t)m.h * a.cap + len) * dh + e] = val;
      (is_v ? vt : kt)[t_new * D + e] = val;
    }
  }
  __syncthreads();

  // Scores: warp w's lanes (rw, sub) read row t's 16-byte slice sub once and
  // dot it with every head's q slice; the VPR lanes of a row reduce.
  const int sub = lane % VPR, rw = lane / VPR;
  for (int t0 = warp * RPW; t0 < npos; t0 += DB_WARPS * RPW) {
    const int t = t0 + rw;
    float kf[VN];
    if (t < npos) {
      load16(kt + t * D + sub * VN, kf);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) kf[e] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < DB_GT; ++g) {
      if (g >= gt) break;
      float qf[VN];
      load16(qt + g * D + sub * VN, qf);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < VN; ++e) dot += qf[e] * kf[e];
#pragma unroll
      for (int o = VPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (sub == 0 && t < npos) sc[g * DB_CHUNK + t] = dot * a.sm_scale;
    }
  }
  __syncthreads();

  // Each head's chunk max and sum (a warp a head); p = exp(s - max) in place.
  if (warp < gt) {
    float* s = sc + warp * DB_CHUNK;
    const float s0 = lane < npos ? s[lane] : -INFINITY;
    const float s1 = lane + 32 < npos ? s[lane + 32] : -INFINITY;
    const float mx = warp_max(fmaxf(s0, s1));
    const float p0 = lane < npos ? expf(s0 - mx) : 0.f;
    const float p1 = lane + 32 < npos ? expf(s1 - mx) : 0.f;
    s[lane] = p0;
    s[lane + 32] = p1;
    const float l = warp_sum(p0 + p1);
    if (lane == 0) {
      mls[2 * warp] = mx;
      mls[2 * warp + 1] = l;
    }
  }
  __syncthreads();

  // P.V: thread (slice, head, column pair) sums positions slice, slice + TS,
  // ...; the slices add in order.
  const int half = D / 2, pairs = gt * half, ts_n = pv_slices(gt, D), sf = state_floats(D);
  const auto state = [&](int g) {
    return a.part + ((size_t)(m.h * (a.hq / a.hk) + m.g0 + g) * a.nc + m.c) * sf;
  };
  for (int o = tid; o < ts_n * pairs; o += DB_THREADS) {
    const int ts = o / pairs, pr = o - ts * pairs, g = pr / half, dp = pr - g * half;
    const float* p = sc + g * DB_CHUNK;
    float acc0 = 0.f, acc1 = 0.f;
    for (int t = ts; t < npos; t += ts_n) {
      const float w = p[t];
      float v0, v1;
      if constexpr (sizeof(T) == 2) {
        const unsigned u = *reinterpret_cast<const unsigned*>(vt + t * D + 2 * dp);
        v0 = __uint_as_float(u << 16);
        v1 = __uint_as_float(u & 0xffff0000u);
      } else {
        const float2 f = *reinterpret_cast<const float2*>(vt + t * D + 2 * dp);
        v0 = f.x;
        v1 = f.y;
      }
      acc0 += w * v0;
      acc1 += w * v1;
    }
    if (ts_n == 1) {
      *reinterpret_cast<float2*>(state(g) + 2 * dp) = make_float2(acc0, acc1);
    } else {
      *reinterpret_cast<float2*>(pv + (ts * gt + g) * D + 2 * dp) = make_float2(acc0, acc1);
    }
  }
  if (ts_n > 1) {
    __syncthreads();
    for (int o = tid; o < gt * D; o += DB_THREADS) {
      float s = 0.f;
      for (int ts = 0; ts < ts_n; ++ts) s += pv[ts * gt * D + o];
      const int g = o / D;
      state(g)[o - g * D] = s;
    }
  }
  if (tid < gt) *reinterpret_cast<float2*>(state(tid) + D) = make_float2(mls[2 * tid], mls[2 * tid + 1]);
  __syncthreads();  // the stage and the scratch are free
}

// The attention vector of every head, combined from the items' states,
// into the dot operand row of wo (f32, permuted; each head's d = dh
// outputs, the state's columns past d dropped): NaN for a row with no
// room. The states are read straight from L2, so the shared memory the
// combine needs does not grow with the cache: a warp a head takes its
// chunks' maximum M and 1 / den, den = sum_c exp(m_c - M) l_c (lane l:
// chunks l, l + 32, ..., then the warp's fixed tree), into `ml` (2 hq
// floats); then a thread per four outputs sums exp(m_c - M) / den . P.V_c
// over the chunks in order, DB_CB chunks' loads in flight at a time, the
// first batch issued before the warps' reductions.
template <int D>
__device__ __forceinline__ void combine_into(const BlockArgs& a, int len, float* xs, float* ml) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int dh = D == 16 ? a.dh : D, lg = __ffs(dh) - 1;
  // A thread takes four outputs of one head (d >= 4), else one.
  const bool vec = dh >= 4;
  const int per = vec ? 4 : 1;
  const int k = a.hq * dh, kc = k >> 4, nv = k / per, sf = state_floats(D);
  if (len < 0 || len >= a.cap) {
    for (int e = tid; e < k; e += DB_THREADS) xs[perm_index(e, kc)] = NAN;
    __syncthreads();
    return;
  }
  const int nch = (len + DB_CHUNK) / DB_CHUNK;  // ceil((len + 1) / CHUNK)
  const auto state = [&](int g, int c) { return a.part + ((size_t)g * a.nc + c) * sf; };
  float4 pv[DB_CB];
  float mc[DB_CB];
  const auto fetch = [&](int v, int c0) {  // thread v's outputs of chunks c0 .. c0 + DB_CB - 1
    const int g = (per * v) >> lg, e = per * v - (g << lg);
#pragma unroll
    for (int u = 0; u < DB_CB; ++u) {
      if (c0 + u < nch) {
        const float* st = state(g, c0 + u);
        pv[u] = vec ? __ldcg(reinterpret_cast<const float4*>(st + e)) : make_float4(__ldcg(st + e), 0.f, 0.f, 0.f);
        mc[u] = __ldcg(st + D);
      }
    }
  };
  if (tid < nv) fetch(tid, 0);
  for (int g = warp; g < a.hq; g += DB_WARPS) {
    const float2 first = lane < nch ? __ldcg(reinterpret_cast<const float2*>(state(g, lane) + D))
                                    : make_float2(-INFINITY, 0.f);
    float mx = first.x;
    for (int c = lane + 32; c < nch; c += 32) mx = fmaxf(mx, __ldcg(state(g, c) + D));
    mx = warp_max(mx);
    float den = lane < nch ? expf(first.x - mx) * first.y : 0.f;
    for (int c = lane + 32; c < nch; c += 32) {
      const float2 m_l = __ldcg(reinterpret_cast<const float2*>(state(g, c) + D));
      den += expf(m_l.x - mx) * m_l.y;
    }
    den = warp_sum(den);
    if (lane == 0) {
      ml[2 * g] = mx;
      ml[2 * g + 1] = 1.f / den;
    }
  }
  __syncthreads();
  float4* x4 = reinterpret_cast<float4*>(xs);
  for (int v = tid; v < nv; v += DB_THREADS) {
    const int g = (per * v) >> lg;
    const float mx = ml[2 * g], inv = ml[2 * g + 1];
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c0 = 0; c0 < nch; c0 += DB_CB) {
      if (v != tid || c0 != 0) fetch(v, c0);
#pragma unroll
      for (int u = 0; u < DB_CB; ++u) {
        if (c0 + u < nch) {
          const float w = expf(mc[u] - mx) * inv;
          num.x += w * pv[u].x;
          num.y += w * pv[u].y;
          num.z += w * pv[u].z;
          num.w += w * pv[u].w;
        }
      }
    }
    if (vec) {
      x4[perm_index(4 * v, kc) >> 2] = num;
    } else {
      xs[perm_index(v, kc)] = num.x;
    }
  }
  __syncthreads();
}

// A norm's scale and bias for the float4s tid, tid + DB_THREADS, ... of a
// row, in registers: loaded before the grid-wide wait that precedes their
// phase, so that they arrive during it.
struct NormPre {
  float4 s[4], b[4];
};

__device__ __forceinline__ NormPre norm_prefetch(const float* ns, const float* nb, int k) {
  NormPre r;
  const int nv = k >> 2;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = threadIdx.x + i * DB_THREADS;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    r.s[i] = v < nv ? __ldg(reinterpret_cast<const float4*>(ns) + v) : zero;
    r.b[i] = v < nv && nb ? __ldg(reinterpret_cast<const float4*>(nb) + v) : zero;
  }
  return r;
}

// The phase input row [k] of f32 (written by other blocks before the last
// grid-wide wait) into the dot operand: normalised (with `norm`; k at most
// DB_MAX_DM) and rounded to bf16 (BF).
template <bool BF>
__device__ __forceinline__ void row_into(const BlockArgs& a, const float* src, int k, const NormPre* norm, float* xs,
                                         float* red) {
  const int tid = threadIdx.x, nv = k >> 2, kc = k >> 4;
  const float4* s4 = reinterpret_cast<const float4*>(src);
  float4* x4 = reinterpret_cast<float4*>(xs);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const auto store = [&](int v, float4 y) {
    if (BF) y = make_float4(round_bf16(y.x), round_bf16(y.y), round_bf16(y.z), round_bf16(y.w));
    x4[perm_index(4 * v, kc) >> 2] = y;
  };
  if (norm == nullptr) {
#pragma unroll 4
    for (int v = tid; v < nv; v += DB_THREADS) store(v, __ldcg(s4 + v));
    __syncthreads();
    return;
  }
  float4 y[4];
  float part = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = tid + i * DB_THREADS;
    y[i] = v < nv ? __ldcg(s4 + v) : zero;
    part += norm_part4(y[i], a.norm);
  }
  const float kf = (float)k;
  float mean, inv;
  norm_stats(a.norm, block_reduce<false, DB_WARPS>(part, red), kf, a.eps, mean, inv);
  if (a.norm == 1) {  // layernorm: the variance, from the centred values
    part = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (tid + i * DB_THREADS < nv) part += centred_sq4(y[i], mean);
    }
    inv = norm_inv(block_reduce<false, DB_WARPS>(part, red), kf, a.eps);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int v = tid + i * DB_THREADS;
    if (v < nv) store(v, normalize4(y[i], mean, inv, norm->s[i], norm->b[i]));
  }
  __syncthreads();
}

// A column's epilogue operands: its scale, its bias (0 without) and its
// residual (0 without: wo adds the block input, down the f32 h).
struct Ep {
  float s, b, r;
};

__device__ __forceinline__ Ep ep_load(const BlockArgs& a, int p, int col, bool bf) {
  const DbPhase& ph = a.ph[p];
  Ep e;
  e.s = __ldg(ph.scale + col);
  e.b = ph.bias ? __ldg(ph.bias + col) : 0.f;
  e.r = p == 0 ? load_act(a.residual, bf, col) : p == 2 ? __ldcg(a.h_buf + col) : 0.f;
  return e;
}

// The block's columns [lo, hi) of phase p, from the run table.
__device__ __forceinline__ int2 phase_rows(const DbSeg* segs, const int* seg_lo, int p) {
  const int j0 = seg_lo[p], j1 = seg_lo[p + 1];
  return j0 < j1 ? make_int2(segs[j0].r0, segs[j1 - 1].r1) : make_int2(0, 0);
}

// Thread t's operands for the phase's column lo + t (lo: the block's first),
// loaded before the grid-wide wait that precedes the phase; a column past
// the block's gets zeros.
__device__ __forceinline__ Ep ep_prefetch(const BlockArgs& a, int p, const DbSeg* segs, const int* seg_lo, bool bf) {
  const int2 rows = phase_rows(segs, seg_lo, p);
  const int col = rows.x + (int)threadIdx.x;
  return col < rows.y ? ep_load(a, p, col, bf) : Ep{0.f, 0.f, 0.f};
}

// One GEMV phase of the block: its runs of phase p (from the run table), in
// batches of columns; each (column pair, piece) item by one warp, the pieces
// added in order and the epilogue epi(col, sum, operands) by one thread a
// column, from `pre` where the batch starts at the block's first column
// (thread t: column lo + t), else loaded then. Waits on each run's barrier;
// issues a later wave once the block is done with the one before.
template <typename Epi>
__device__ __forceinline__ void gemv_phase(const BlockArgs& a, int p, bool bf, const Ep& pre, const float* xs,
                                           float* part, const DbSeg* segs, const int* seg_lo, unsigned char* region,
                                           uint64_t* bars, int& cur_wave, bool timed, long long& ready,
                                           const Epi& epi) {
  const int k = a.ph[p].k, kc = k >> 4, pieces = (k + DB_PIECE - 1) / DB_PIECE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per_batch = min(DB_THREADS, DB_PART / pieces);
  // Items i = warp, warp + DB_WARPS, ... as (column pair, piece): columns
  // 2 (i / pieces) and the next, piece i % pieces, stepped without a division.
  const int row0 = 2 * (warp / pieces), pc0 = warp - (row0 / 2) * pieces;
  const int srow = 2 * (DB_WARPS / pieces), spc = DB_WARPS - (srow / 2) * pieces;
  const int lo = segs[seg_lo[p]].r0, j1 = seg_lo[p + 1];
  const float4* x4 = reinterpret_cast<const float4*>(xs);
  for (int j = seg_lo[p]; j < j1; ++j) {
    const DbSeg sg = segs[j];
    if (sg.wave != cur_wave) {  // the block is done with the previous wave's runs
      __syncthreads();
      if (tid == 0) issue_wave(a, segs, seg_lo[DB_PHASES], sg.wave, region, bars);
      cur_wave = sg.wave;
    }
    mbar_wait(&bars[j], 0);
    if (timed && ready == 0) ready = global_ns();
    for (int b0 = sg.r0; b0 < sg.r1; b0 += per_batch) {
      const int nb = min(per_batch, sg.r1 - b0);
      const unsigned char* w0 = region + sg.off + (size_t)(b0 - sg.r0) * k;
      for (int row = row0, pc = pc0; row < nb;) {
        // columns row and row + 1 (the second past the batch: row again, its
        // sum dropped), K piece pc: the x loads and the warp's reductions shared
        const int row2 = row + 1 < nb ? row + 1 : row;
        const unsigned char* wa = w0 + (size_t)row * k;
        const unsigned char* wb = w0 + (size_t)row2 * k;
        float acc = 0.f, acc2 = 0.f;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int ch = pc * (DB_PIECE / 16) + s * 32 + lane;  // this lane's 16-byte chunk of the column
          if (ch < kc) {
            float wf[16], wg[16];
            unpack16(*reinterpret_cast<const int4*>(wa + 16 * ch), wf);
            unpack16(*reinterpret_cast<const int4*>(wb + 16 * ch), wg);
            const float4 x[4] = {x4[ch], x4[kc + ch], x4[2 * kc + ch], x4[3 * kc + ch]};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              acc += wf[4 * q] * x[q].x + wf[4 * q + 1] * x[q].y + wf[4 * q + 2] * x[q].z + wf[4 * q + 3] * x[q].w;
              acc2 += wg[4 * q] * x[q].x + wg[4 * q + 1] * x[q].y + wg[4 * q + 2] * x[q].z + wg[4 * q + 3] * x[q].w;
            }
          }
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          acc += __shfl_xor_sync(0xffffffffu, acc, o);
          acc2 += __shfl_xor_sync(0xffffffffu, acc2, o);
        }
        if (lane == 0) {
          part[row * pieces + pc] = acc;
          if (row2 != row) part[row2 * pieces + pc] = acc2;
        }
        row += srow;
        pc += spc;
        if (pc >= pieces) {
          pc -= pieces;
          row += 2;
        }
      }
      __syncthreads();
      if (tid < nb) {
        float sum = 0.f;
        for (int pc = 0; pc < pieces; ++pc) sum += part[tid * pieces + pc];
        const int col = b0 + tid;
        epi(col, sum, b0 == lo ? pre : ep_load(a, p, col, bf));
      }
      __syncthreads();
    }
  }
}

template <typename T, int D, bool TIMED>
__global__ void __launch_bounds__(DB_THREADS, 1) decode_block_kernel(BlockArgs a) {
  using A = DbAtt<T, D>;
  constexpr bool BF = sizeof(T) == 2;
  extern __shared__ __align__(128) unsigned char db_smem[];
  const DbLayout lay = db_layout(a.uni_bytes, a.region);
  unsigned char* uni = db_smem;
  float* xs = reinterpret_cast<float*>(db_smem);
  float* part = reinterpret_cast<float*>(db_smem + lay.part);
  float* red = reinterpret_cast<float*>(db_smem + lay.red);
  DbSeg* segs = reinterpret_cast<DbSeg*>(db_smem + lay.segs);
  int* seg_lo = reinterpret_cast<int*>(db_smem + lay.seg_lo);  // [phase]: its first run; [DB_PHASES]: the count
  uint64_t* bars = reinterpret_cast<uint64_t*>(db_smem + lay.bars);
  unsigned char* region = db_smem + lay.region;
  cg::grid_group grid_g = cg::this_grid();
  const int grid = gridDim.x, blk = blockIdx.x, tid = threadIdx.x;
  const int stage_bytes = A::stage(min(DB_GT, a.hq / a.hk));
  // Narrow rows: the item stages filled by every thread (issue_item_narrow),
  // one cp.async group an item, instead of one thread's bulk copies.
  const bool narrow = D == 16 && a.dh < 16;
  // The measurement build (TIMED) has thread 0 of each block record the
  // %globaltimer into a.stamps at: 0 entry; 1 its first item landed; 2 the
  // attention done; then for each GEMV phase q = 0..3 (wo, up, down, next
  // qkv), from 3 + 4 q: the wait before it done, its operand row ready, its
  // first weights ready, the phase done. A stamp not reached stays 0. The
  // build the decoder runs has none of it.
  long long stamp[DB_STAMPS];
  const bool timed = TIMED && tid == 0;
  const auto mark = [&](int i) {
    if (timed) stamp[i] = global_ns();
  };
  if (timed) {
#pragma unroll
    for (int i = 0; i < DB_STAMPS; ++i) stamp[i] = 0;
  }
  mark(0);

  // Entry, one thread: the barriers, the block's first attention item (its
  // chunk known without kv_len), then the run table and wave 0 of the
  // weights.
  const int first = blk;
  const int per_chunk = a.hk * a.tiles;
  const bool spec = first < a.nc * per_chunk;
  if (tid == 0) {
    for (int i = 0; i < DB_MAX_SEG + 2; ++i) mbar_init(&bars[i], 1);
    mbar_init_fence();
    if (spec && !narrow) issue_item<T, D>(a, first, uni, &bars[DB_MAX_SEG]);
    int j = 0, p_next = 0;
    block_segments(a, blk, grid, [&](const DbSeg& s) {
      while (p_next <= s.p) seg_lo[p_next++] = j;
      segs[j++] = s;
    });
    while (p_next <= DB_PHASES) seg_lo[p_next++] = j;
    issue_wave(a, segs, j, 0, region, bars);
  }
  int cur_wave = 0;
  if (narrow) {
    if (spec) issue_item_narrow<T, D>(a, first, uni);
    cp_async_commit();
  }

  // Phase 1: the attention items.
  const int len = a.kv_len[0];
  const int items = (len >= 0 && len < a.cap) ? (len + DB_CHUNK) / DB_CHUNK * per_chunk : 0;
  __syncthreads();  // the barriers and the run table are ready
  Ep ep = ep_prefetch(a, 0, segs, seg_lo, BF);
  if (narrow) {
    if (first + grid < items) issue_item_narrow<T, D>(a, first + grid, uni + stage_bytes);
    cp_async_commit();
  } else if (tid == 0 && first + grid < items) {
    issue_item<T, D>(a, first + grid, uni + stage_bytes, &bars[DB_MAX_SEG + 1]);
  }
  int n = 0;
  for (int it = first; it < items; it += grid, ++n) {
    if (narrow) {
      cp_async_wait<1>();  // this thread's pieces of item n (the next item's group may be in flight) ...
      __syncthreads();     // ... and everyone's
    } else {
      mbar_wait(&bars[DB_MAX_SEG + (n & 1)], (n >> 1) & 1);
    }
    if (n == 0) mark(1);
    attend_item<T, D>(a, it, len, uni, uni + (n & 1) * stage_bytes);
    if (narrow) {
      if (it + 2 * grid < items) issue_item_narrow<T, D>(a, it + 2 * grid, uni + (n & 1) * stage_bytes);
      cp_async_commit();
    } else if (tid == 0 && it + 2 * grid < items) {
      fence_proxy_async();
      issue_item<T, D>(a, it + 2 * grid, uni + (n & 1) * stage_bytes, &bars[DB_MAX_SEG + (n & 1)]);
    }
  }
  if (narrow) {
    cp_async_wait<0>();  // a first item past the row: let it land
  } else if (spec && first >= items) {
    mbar_wait(&bars[DB_MAX_SEG], 0);  // a first item past the row: let it land
  }
  const int dm = a.ph[0].n;
  NormPre norm = norm_prefetch(a.ln2_scale, a.ln2_bias, dm);
  mark(2);
  grid_g.sync();
  mark(3);

  // Phase 2: the combine into wo's operand; h = attn @ W_o * s + b + residual (f32).
  combine_into<D>(a, len, xs, xs + a.ph[0].k);
  mark(4);
  gemv_phase(a, 0, BF, ep, xs, part, segs, seg_lo, region, bars, cur_wave, timed, stamp[5],
             [&](int col, float acc, const Ep& e) { a.h_buf[col] = acc * e.s + e.b + e.r; });
  ep = ep_prefetch(a, 1, segs, seg_lo, BF);
  mark(6);
  grid_g.sync();
  mark(7);

  // Phase 3: u = act(norm2(h) @ W_up * s + b) (f32); down's operands (h is whole now).
  const Ep ep_down = ep_prefetch(a, 2, segs, seg_lo, BF);
  row_into<BF>(a, a.h_buf, dm, &norm, xs, red);
  mark(8);
  gemv_phase(a, 1, BF, ep, xs, part, segs, seg_lo, region, bars, cur_wave, timed, stamp[9],
             [&](int col, float acc, const Ep& e) { a.u_buf[col] = activate(acc * e.s + e.b, a.act); });
  if (a.phases == DB_PHASES) {
    norm = norm_prefetch(a.next_scale, a.next_bias, dm);
    ep = ep_prefetch(a, 3, segs, seg_lo, BF);
  }
  mark(10);
  grid_g.sync();
  mark(11);

  // Phase 4: out = u @ W_down * s + b + h.
  row_into<BF>(a, a.u_buf, a.ph[1].n, nullptr, xs, red);
  mark(12);
  gemv_phase(a, 2, BF, ep_down, xs, part, segs, seg_lo, region, bars, cur_wave, timed, stamp[13],
             [&](int col, float acc, const Ep& e) {
               const float v = acc * e.s + e.b + e.r;
               store_act(a.out, BF, col, v);
               if (a.out_f32) a.out_f32[col] = v;
             });
  mark(14);

  // Phase 5: the next layer's qkv = norm1_next(out) @ W_qkv * s + b.
  if (a.phases == DB_PHASES) {
    grid_g.sync();
    mark(15);
    row_into<BF>(a, a.out_f32, dm, &norm, xs, red);
    mark(16);
    gemv_phase(a, 3, BF, ep, xs, part, segs, seg_lo, region, bars, cur_wave, timed, stamp[17],
               [&](int col, float acc, const Ep& e) { store_act(a.qkv_out, BF, col, acc * e.s + e.b); });
    mark(18);
  }
  if (timed) {
    for (int i = 0; i < DB_STAMPS; ++i) a.stamps[(size_t)blk * DB_STAMPS + i] = stamp[i];
  }
}

template <typename T, int D, bool TIMED = false>
cudaError_t launch_block(BlockArgs& a, int grid, size_t smem, cudaStream_t st) {
  static bool raised = false;
  cudaError_t e = allow_smem(decode_block_kernel<T, D, TIMED>, smem, raised);
  if (e != cudaSuccess) return e;
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(decode_block_kernel<T, D, TIMED>), dim3(grid),
                                     dim3(DB_THREADS), args, smem, st);
}

// The head dims decode_block takes: every divisor of 128, as the JAX mega
// rule admits (instances at 16, 32, 64 and 128; 8, 4, 2 and 1 on the 16
// one with narrow rows).
bool block_dim_ok(int d) { return d >= 1 && d <= 128 && 128 % d == 0; }

// f(T{}, integral_constant<D>) for the instance of (dtype, head dim d), or
// `refused` for a head dim it is not built for (nothing launched).
template <typename R, typename F>
R with_block_dim(int bf16, int d, R refused, const F& f) {
  const auto as = [&](auto dd) -> R { return bf16 ? f(__nv_bfloat16{}, dd) : f(0.f, dd); };
  switch (d) {
    case 1:
    case 2:
    case 4:
    case 8:
    case 16: return as(std::integral_constant<int, 16>{});
    case 32: return as(std::integral_constant<int, 32>{});
    case 64: return as(std::integral_constant<int, 64>{});
    case 128: return as(std::integral_constant<int, 128>{});
    default: return refused;
  }
}

bool phase_ok(const DbPhase& p) {
  const auto mis = [](const void* q) { return (reinterpret_cast<uintptr_t>(q) & 15) != 0; };
  return p.k % 16 == 0 && p.k >= 16 && p.n >= 1 && !mis(p.w) && p.scale != nullptr;
}

}  // namespace
}  // namespace rt

extern "C" int rt_decode_block(
    const void* q, const void* k_new, const void* v_new, int bf16, int hq, int hk, int d,
    void* k_cache, void* v_cache, int s_max, const int* kv_len,
    float* part, int n_chunks,
    const int8_t* wo_t, const float* wo_scales, const float* wo_bias, int dm,
    const void* residual, float* h_buf,
    const int8_t* w_up_t, const float* s_up, const float* b_up, int ff, float* u_buf,
    const int8_t* w_down_t, const float* s_down, const float* b_down,
    const float* ln2_scale, const float* ln2_bias, int norm, float eps, int act,
    void* out, float* out_f32,
    const int8_t* w_qkv_t, const float* s_qkv, const float* b_qkv, int nq,
    const float* next_scale, const float* next_bias, void* qkv_out,
    float sm_scale, int grid, int region, long long* stamps, void* stream) {
  using namespace rt;
  const auto mis = [](const void* p) { return p != nullptr && (reinterpret_cast<uintptr_t>(p) & 15) != 0; };
  // Narrow rows (d < 16) are read in pieces of the largest size that divides
  // d's bytes and every row operand's address; wider rows by bulk copies
  // from 16-byte aligned operands.
  const bool narrow = d < 16;
  unsigned long long bits = 16 | (unsigned long long)(d * (bf16 ? 2 : 4));
  for (const void* p : {q, k_new, v_new, static_cast<const void*>(k_cache), static_cast<const void*>(v_cache)}) {
    bits |= reinterpret_cast<uintptr_t>(p);
  }
  const bool rows_mis = !narrow && (mis(q) || mis(k_new) || mis(v_new) || mis(k_cache) || mis(v_cache));
  if (rows_mis || mis(part) || hq < 1 || hk < 1 ||
      hq % hk || s_max < 1 || n_chunks * DB_CHUNK < s_max || (norm != 1 && norm != 2) || !block_dim_ok(d) ||
      grid < 1 || dm % 16 || dm > DB_MAX_DM || ff % 16 || mis(ln2_scale) || mis(ln2_bias) || mis(next_scale) ||
      mis(next_bias) || mis(h_buf) || mis(u_buf) || mis(out_f32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BlockArgs a{};
  a.q = q;
  a.k_new = k_new;
  a.v_new = v_new;
  a.k = k_cache;
  a.v = v_cache;
  a.kv_len = kv_len;
  a.hq = hq;
  a.hk = hk;
  a.cap = s_max;
  a.nc = n_chunks;
  a.sm_scale = sm_scale;
  a.part = part;
  a.tiles = (hq / hk + DB_GT - 1) / DB_GT;
  a.dh = d;
  a.gran = static_cast<int>(bits & (~bits + 1));
  a.ph[0] = DbPhase{wo_t, wo_scales, wo_bias, dm, hq * d};
  a.ph[1] = DbPhase{w_up_t, s_up, b_up, ff, dm};
  a.ph[2] = DbPhase{w_down_t, s_down, b_down, dm, ff};
  a.phases = 3;
  if (w_qkv_t) {
    a.ph[3] = DbPhase{w_qkv_t, s_qkv, b_qkv, nq, dm};
    a.phases = 4;
    if (out_f32 == nullptr || next_scale == nullptr || qkv_out == nullptr) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  for (int p = 0; p < a.phases; ++p) {  // range_at's products stay in 32 bits
    if (!phase_ok(a.ph[p]) || (long long)(grid + 1) * a.ph[p].n >= (1LL << 31)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  a.residual = residual;
  a.h_buf = h_buf;
  a.u_buf = u_buf;
  a.out_f32 = w_qkv_t ? out_f32 : nullptr;
  a.out = out;
  a.qkv_out = qkv_out;
  a.ln2_scale = ln2_scale;
  a.ln2_bias = ln2_bias;
  a.next_scale = next_scale;
  a.next_bias = next_bias;
  a.norm = norm;
  a.eps = eps;
  a.act = act;
  a.stamps = stamps;

  // The union: the attention scratch, or the widest dot operand row and
  // each head's maximum and 1 / den for the combine (neither grows with the
  // cache).
  const int gt = hq / hk < DB_GT ? hq / hk : DB_GT;
  const int att = with_block_dim(bf16, d, 0, [&](auto t, auto dd) {
    return DbAtt<decltype(t), decltype(dd)::value>::bytes(gt);
  });
  int kmax = hq * d > dm ? hq * d : dm;
  kmax = kmax > ff ? kmax : ff;
  const int row = 4 * kmax + 8 * hq;
  a.uni_bytes = align_to(att > row ? att : row, 128);
  // The weight region: the largest block's runs where they fit, else what
  // is left (the runs then come in waves); never less than one row.
  size_t need = 0;
  int widest = 0;
  for (int p = 0; p < a.phases; ++p) {
    need += (size_t)((a.ph[p].n + grid - 1) / grid) * a.ph[p].k;
    widest = widest > a.ph[p].k ? widest : a.ph[p].k;
  }
  const DbLayout fixed = db_layout(a.uni_bytes, 0);
  const long long room = (long long)MAX_SMEM - fixed.total;
  long long r = (long long)need < room ? (long long)need : room;
  if (region > 0 && region < r) r = region;
  r = r / 16 * 16;
  if (r < widest) return static_cast<int>(cudaErrorInvalidValue);
  a.region = (int)r;
  int most = 0;  // the most runs of any block: each needs its own barrier
  for (int b = 0; b < grid; ++b) {
    const int runs = block_segments(a, b, grid, [](const DbSeg&) {});
    most = most > runs ? most : runs;
  }
  if (most > DB_MAX_SEG) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)db_layout(a.uni_bytes, a.region).total;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stamps) {  // the measurement build: bf16, head dim 64 only
    return static_cast<int>(bf16 && d == 64 ? launch_block<__nv_bfloat16, 64, true>(a, grid, smem, st)
                                            : cudaErrorInvalidValue);
  }
  return static_cast<int>(with_block_dim(bf16, d, cudaErrorInvalidValue, [&](auto t, auto dd) {
    return launch_block<decltype(t), decltype(dd)::value>(a, grid, smem, st);
  }));
}
