// Split-KV decode attention over a KV cache that is either one contiguous
// row per sequence ([B, Hk, S, D]) or pages of a shared pool ([P, Hk, page, D]
// found through a [B, max_pages] page table), with bf16/f32 or int8 payloads
// (int8 with one f32 scale per (token, kv head): [B, Hk, S] or [P, Hk, page]).
// One query token per row, Hq query heads over Hk kv heads (grouped-query
// attention: query head h reads kv head h / (Hq / Hk); Hq == Hk is MHA). The
// operands are three pointers with row strides: q [B, Hq, D], k_new and
// v_new [B, Hk, D], each row's heads contiguous, so a packed MHA q|k|v
// buffer [B, 3 * H * D] is three views of one tensor and RoPE'd q and k
// arrive as their own tensors. The new token's k/v are appended in place at
// kv_len (quantized first for int8) and the output is the attention vector
// [B, Hq * D] in the activations' dtype (or f32 for a caller that projects
// it unrounded: decode_attention.cu's wo).
//
// Shared by decode_attention.cu, paged_attention.cu, decode_attention_int8.cu
// and paged_attention_int8.cu (rten_tpu/kernels/decode_attention.py
// _decode_attn_kernel, _decode_attn_int8_kernel; paged_attention.py
// _paged_attn_kernel, _paged_attn_int8_kernel). On the TPU one grid cell per
// row walks its pages (or blocks) in order under a running online softmax,
// with the new token seeding it and the group's query rows scored together.
//
// Bound on the H100: bytes, the valid prefix's payload (and scales) read
// once per kv head: 0.2-0.9 us at the decoders' shapes, so what costs is
// fixed latency and idle SMs. Design: one launch, no partials in device
// memory.
//   - Grid (C, Hk * tiles, B) as clusters of C blocks along x (C <= 8,
//     attention.py kv_plan): one cluster a (kv head, head tile, row). A
//     head tile is the whole group up to KV_GT = 8 query heads (MHA: one);
//     a larger group is tiled over more clusters, each reading the chunks
//     again (from L2, mostly).
//   - A row's 64-position chunks belong to V = min(8, chunks of cap) virtual
//     ranks, virtual rank v walking chunks v, v + V, ... of the valid prefix
//     plus the new token under a running online softmax; rank r of the
//     cluster runs virtual ranks r, r + C, ... in turn. V, not C, orders a
//     row's sums, so the plan may size C by the batch and the device and a
//     row still gets the same bits in any batch, from any of the four
//     kernels (the serving engines' streams are held against their solo
//     streams). Its first chunk is requested before kv_len has arrived;
//     each chunk's K and V rows (and int8 scales) come by cp.async into a
//     ring of 3 shared-memory stages (2 for f32 at head dim 128), requested
//     two chunks ahead of the one the block computes, across its virtual
//     ranks. Each row is found on its own (paged: its page from the table),
//     so a chunk may span pages of any size the JAX rules admit (pages of
//     8 positions at head dim 128, 16 at 64, or 48 or 80 at 64), and a paged
//     row sums exactly as its dense twin.
//   - Head dims: instances at 32, 64 and 128, and at 16 for every head dim
//     that divides 16 (16, 8, 4, 2, 1; the JAX rule takes any divisor of
//     128): a row narrower than the instance lands in the first a.d columns
//     of its stage row, whose other columns are zero from the kernel's
//     start; the new token, q and the output are read and written at a.d
//     columns, and the scale is 1 / sqrt(a.d) (the caller's). Rows of 16
//     bytes and more come in 16-byte cp.async pieces, narrower ones as one
//     piece of 8 or 4 bytes by cp.async, or of 2 or 1 by plain loads.
//   - A chunk in one pass for the whole head tile, each warp on its own,
//     in blocks of 8 warps (MHA) or 16 (GQA): warp w takes head w % gt and
//     the part w / gt of the chunk's positions (MHA: 8 parts of 8; Qwen2's
//     group of 7: 2 parts of 32), lane (rw, sub) the part's rows rw, rw + RPW, ...
//     and their 16-byte column slice sub, with its slice of q in registers.
//     It scores its rows (the VPR lanes of a row dot their slices and reduce
//     by shuffles), moves the running max over NSTEP row steps at a time,
//     and adds p and p * v of its rows to its own sum and P.V slice. The
//     lane that scores a row is the lane that reads its V, so the softmax
//     needs no shared array and no barrier: one barrier a chunk (its stage
//     has landed; one more where the new token is written into it).
//   - Numerics in f32 on CUDA cores: score q.k * sm_scale (int8: q.k_int8 *
//     k_scale * sm_scale), P.V sum p * v (int8: (p * v_scale) * v_int8).
//   - The end of a virtual rank: each warp sums its lanes' row slices by
//     shuffles; a head's parts merge in shared memory, in part order; each
//     head's max and sum and the P.V of each output go straight into the
//     shared memory of the rank that owns that output (rank r owns outputs
//     [r * share, (r + 1) * share) of the tile), in the virtual rank's slot.
//     After the last, one cluster barrier; each rank then combines its share
//     from its own shared memory, the virtual ranks' states in order, so no
//     rank reads another's memory. A virtual rank or part with no position
//     contributes max -inf and sum 0. Every rank arrives on the cluster
//     barrier at its start and waits before its first remote store, so no
//     store reaches a block that has not started.
//   - The rank whose chunk holds kv_len appends the new token there, once
//     per kv head (head tile 0), and writes it into that chunk's stage, where
//     it is scored as any other row; no rank reads from device memory a row
//     another writes. The int8 append
//     quantizes per kv head as the TPU wrapper does: absmax over D, scale =
//     absmax / 127 (1 where absmax is 0), code = rint(x / scale) clipped to
//     +-127 (IEEE division and round-half-even, the jnp.round rule), and the
//     new token's score and value use the dequantized code * scale.
//   - Faults: kv_len outside [0, cap) writes nothing and gives NaN; a page
//     id outside the pool for a position the row needs gives NaN for the
//     row (such a page is never read, and a chunk that needs one is neither
//     scored nor appended to).
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "hopper.cuh"

namespace rt {
namespace {

constexpr int KV_CHUNK = 64;      // positions per chunk (kernels/decode_attention.py CHUNK)
// Threads of a block: 8 warps for an MHA head, 16 for a GQA head tile (two
// position parts a head at Qwen2's group of 7).
template <int GT>
__host__ __device__ constexpr int kv_threads() { return GT == 1 ? 256 : 512; }
constexpr int KV_GT = 8;          // query heads a GQA cluster scores (attention.py KV_GROUP_TILE)
constexpr int KV_MAX_SPLIT = 8;   // ranks of a cluster (the portable cluster size)
static_assert(KV_GT <= kv_threads<KV_GT>() / 32, "a warp for each head of a tile");

struct KvArgs {
  const void* q;         // [B, Hq, D]: row b at q + b * q_stride (elements)
  const void* k_new;     // [B, Hk, D]
  const void* v_new;
  long long q_stride, kn_stride, vn_stride;
  void* k;               // payload: [B, Hk, cap, D] contiguous, or [n_pages, Hk, page, D]
  void* v;
  float* k_scale;        // int8 only: [B, Hk, cap] or [n_pages, Hk, page]
  float* v_scale;
  const int* kv_len;     // [B], valid length before this token
  const int* table;      // paged only: [B, max_pages]
  int hq, hk;            // query heads, kv heads (hq % hk == 0)
  int d;                 // head dim: the instance's D, or (D 16) any divisor of it
  int cap;               // positions a row can hold: S, or max_pages * page
  int page, max_pages, n_pages;  // paged only
  float sm_scale;
};

// One shared-memory stage: a chunk's K rows, its V rows and (int8) their
// scales; a ring of STAGES a block: 3 (two chunks ahead of the one computed)
// where they fit 100 KB, else 2.
template <typename KV, int D>
struct KvStage {
  static constexpr int ROW = D * static_cast<int>(sizeof(KV));  // bytes of a cache row
  static constexpr int TILE = KV_CHUNK * ROW;
  static constexpr int SCALES = sizeof(KV) == 1 ? KV_CHUNK * 4 : 0;
  static constexpr int BYTES = 2 * TILE + 2 * SCALES;
  static constexpr int STAGES = 3 * BYTES <= 100 * 1024 ? 3 : 2;
  static constexpr int SMEM = STAGES * BYTES;
};

// 16 bytes of a cache row to f32: 4 floats, 8 bf16 values or 16 int8 codes.
__device__ __forceinline__ void load16(const int8_t* p, float* f) {
  unpack16(*reinterpret_cast<const int4*>(p), *reinterpret_cast<float(*)[16]>(f));
}

// Chunk c's K and V rows and, int8, their scales into a stage, by
// cp.async; one commit group. row(t) is the payload row of position t, or
// -1 for a row not read (past the positions needed, or on a page outside
// the pool), whose stage row is zero-filled. A row of dt elements lands
// in the first a.d columns of its D-wide stage row, in pieces of 16 bytes
// (or one piece, a row narrower than that).
template <typename KV, int D, int THREADS, typename Row>
__device__ __forceinline__ void kv_issue_chunk(const KvArgs& a, unsigned char* stage, int c, int dt, const Row& row) {
  using L = KvStage<KV, D>;
  const int rb = dt * static_cast<int>(sizeof(KV));  // bytes of a cache row: a power of two
  const int gr = rb < 16 ? rb : 16;                   // bytes a piece
  const int lp = __ffs(rb / gr) - 1;                  // log2 of the pieces a row
  const unsigned char* kg = static_cast<const unsigned char*>(a.k);
  const unsigned char* vg = static_cast<const unsigned char*>(a.v);
  for (int i = threadIdx.x; i < KV_CHUNK << lp; i += THREADS) {
    const int t = i >> lp, off = (i - (t << lp)) * gr;
    const long long r = row(c * KV_CHUNK + t);
    const size_t src = r >= 0 ? (size_t)r * rb + off : 0;
    copy_piece(stage + t * L::ROW + off, kg + src, r >= 0, gr);
    copy_piece(stage + L::TILE + t * L::ROW + off, vg + src, r >= 0, gr);
  }
  if constexpr (L::SCALES > 0) {  // scales 4 bytes at a time: a row's may start anywhere
    const int i = threadIdx.x;
    if (i < 2 * KV_CHUNK) {
      const int t = i % KV_CHUNK;
      const long long r = row(c * KV_CHUNK + t);
      const float* src = (i < KV_CHUNK ? a.k_scale : a.v_scale) + (r >= 0 ? r : 0);
      cp_async4(stage + 2 * L::TILE + i * 4, src, r >= 0);
    }
  }
  cp_async_commit();
}

// The cluster (kv head, head tile, row) = (blockIdx.y / tiles, blockIdx.y %
// tiles, blockIdx.z), rank blockIdx.x of gridDim.x. GT: heads a tile holds
// (1 for MHA, KV_GT under GQA); O: the output's type.
template <typename T, typename KV, int D, bool PAGED, int GT, typename O>
__global__ void __launch_bounds__(kv_threads<GT>()) kv_attention_kernel(KvArgs a, O* out, int tiles) {
  namespace cg = cooperative_groups;
  constexpr bool INT8 = std::is_same<KV, int8_t>::value;
  static_assert(INT8 || std::is_same<KV, T>::value, "a float cache holds the activations' dtype");
  using L = KvStage<KV, D>;
  constexpr int S = L::STAGES;
  constexpr int VN = 16 / sizeof(KV);  // elements in a 16-byte vector
  constexpr int VPR = D / VN;          // lanes a cache row
  constexpr int RPW = 32 / VPR;        // rows a warp reads at a time (the P.V slices of a warp)
  constexpr int DL = (D + 31) / 32;    // new-token elements a lane of warp 0 holds
  constexpr int NSTEP = 8;             // row steps (RPW rows each) under one running-max update
  constexpr int THREADS = kv_threads<GT>(), WARPS = THREADS / 32;

  extern __shared__ __align__(16) unsigned char kv_smem[];
  __shared__ float st_m[WARPS], st_l[WARPS];
  __shared__ __align__(16) float st_acc[WARPS][D];
  // The combine's inbox: from each virtual rank v, each head's max and sum
  // and its P.V for this rank's share of the tile's outputs; from each rank,
  // whether it met a page outside the pool.
  __shared__ float in_m[KV_MAX_SPLIT][GT], in_l[KV_MAX_SPLIT][GT];
  __shared__ float in_acc[KV_MAX_SPLIT * (GT * D + 1)];
  __shared__ int in_bad[KV_MAX_SPLIT];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = gridDim.x, rank = blockIdx.x;
  const int kvh = blockIdx.y / tiles, tile = blockIdx.y % tiles, b = blockIdx.z;
  const int group = a.hq / a.hk, g0 = tile * GT, gt = min(GT, group - g0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nc = (a.cap + KV_CHUNK - 1) / KV_CHUNK;
  const int dt = D == 16 ? a.d : D;  // the head dim: the D-wide stage rows' first dt columns
  const int len = a.kv_len[b];
  // Arrive on the cluster barrier at once (relaxed: a release would stall
  // on the loads in flight); its wait, before the first store into another
  // rank's shared memory, then knows every rank has started.
  const int share = (gt * D + split - 1) / split;  // outputs a rank combines: [rank * share, ...)
  const int V = min(KV_MAX_SPLIT, nc);
  if (split > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // Payload row of position t, or -1 at or past `lim` (the positions the
  // row needs, or the cap before kv_len has arrived) and, paged, on a page
  // outside the pool: each position finds its own page, so a chunk may
  // span pages.
  int lim = a.cap;
  const auto row_at = [&](int t) -> long long {
    if (t >= lim) return -1;
    if constexpr (PAGED) {
      const int pg = a.table[(size_t)b * a.max_pages + t / a.page];
      return pg >= 0 && pg < a.n_pages ? ((long long)pg * a.hk + kvh) * a.page + t % a.page : -1;
    } else {
      return ((long long)b * a.hk + kvh) * a.cap + t;
    }
  };
  const auto stage_at = [&](int i) { return kv_smem + (i % S) * L::BYTES; };
  if (dt < D) {  // a narrower head dim: the stage rows' columns past it stay zero
    const int rb = dt * static_cast<int>(sizeof(KV));
    for (int i = tid; i < S * 2 * KV_CHUNK; i += THREADS) {
      unsigned char* r = kv_smem + (i / (2 * KV_CHUNK)) * L::BYTES + (i % (2 * KV_CHUNK)) * L::ROW;
      for (int x = rb; x < L::ROW; ++x) r[x] = 0;
    }
  }

  // The row's sums are ordered by V virtual ranks, V = min(8, chunks of
  // cap), a number the batch and C do not change: virtual rank v walks
  // chunks v, v + V, ..., and this block (rank r of C) runs virtual ranks
  // r, r + C, ... in turn. Its stream of chunks is theirs, one after
  // another; `advance` moves (v, c) to the next chunk of the stream (c = -1
  // past its end).
  int n_chunks = nc;  // the row's chunks: known once kv_len has arrived
  const auto advance = [&](int& v, int& c) {
    if (c < 0) return;
    c += V;
    while (c >= n_chunks) {
      v += split;
      if (v >= V || v >= n_chunks) {
        c = -1;
        return;
      }
      c = v;
    }
  };
  // The stream's first chunk (chunk `rank`), requested before kv_len is
  // known.
  int iv = rank, ic = rank < V ? rank : -1;  // the next chunk to request
  if (ic >= 0) {
    kv_issue_chunk<KV, D, THREADS>(a, stage_at(0), ic, dt, row_at);
  } else {
    cp_async_commit();
  }

  // Warp w takes head hg = w % gt of the tile and the part w / gt of every
  // chunk's positions (MHA: 8 parts of 8); lane (rw, sub) the rows rw,
  // rw + RPW, ... of it and their 16-byte column slice sub, so it holds its
  // slice of q in registers.
  int parts = WARPS / gt;                    // position parts of a head: a power of two,
  while (parts & (parts - 1)) parts &= parts - 1;  // so that they split the chunk evenly
  const int pp = KV_CHUNK / parts;           // positions of a part in each chunk
  const bool pv_warp = warp < gt * parts;
  const int hg = warp % gt, part = warp / gt;
  const int sub = lane % VPR, rw = lane / VPR;
  float qr[VN];
  {
    const T* qg = static_cast<const T*>(a.q) + b * a.q_stride + ((size_t)kvh * group + g0 + (pv_warp ? hg : 0)) * dt;
#pragma unroll
    for (int e = 0; e < VN; ++e) qr[e] = sub * VN + e < dt ? to_f32(qg[sub * VN + e]) : 0.f;
  }
  // Warp 0 holds the new token as the cache stores it (int8: codes, with
  // their scales sk / sv): appended to the cache, and written into the
  // stage of its chunk, where every warp reads it as any other row.
  KV wk[DL], wv[DL];
  float sk = 1.f, sv = 1.f;
  if (warp == 0) {
    const T* kg = static_cast<const T*>(a.k_new) + b * a.kn_stride + (size_t)kvh * dt;
    const T* vg = static_cast<const T*>(a.v_new) + b * a.vn_stride + (size_t)kvh * dt;
    if constexpr (INT8) {
      float xk[DL], xv[DL], ak = 0.f, av = 0.f;
#pragma unroll
      for (int i = 0; i < DL; ++i) {
        const bool in = lane + 32 * i < dt;  // columns past the head dim hold code 0
        xk[i] = in ? to_f32(kg[lane + 32 * i]) : 0.f;
        xv[i] = in ? to_f32(vg[lane + 32 * i]) : 0.f;
        ak = fmaxf(ak, fabsf(xk[i]));
        av = fmaxf(av, fabsf(xv[i]));
      }
      ak = warp_max(ak);
      av = warp_max(av);
      sk = ak == 0.f ? 1.f : ak / 127.f;
      sv = av == 0.f ? 1.f : av / 127.f;
#pragma unroll
      for (int i = 0; i < DL; ++i) {
        wk[i] = static_cast<int8_t>(fminf(fmaxf(rintf(xk[i] / sk), -127.f), 127.f));
        wv[i] = static_cast<int8_t>(fminf(fmaxf(rintf(xv[i] / sv), -127.f), 127.f));
      }
    } else {
#pragma unroll
      for (int i = 0; i < DL; ++i) {
        const bool in = lane + 32 * i < dt;
        wk[i] = in ? kg[lane + 32 * i] : KV{};
        wv[i] = in ? vg[lane + 32 * i] : KV{};
      }
    }
  }

  O* dst = out + ((size_t)b * a.hq + (size_t)kvh * group + g0) * dt;
  if (len < 0 || len >= a.cap) {  // no room to append: nothing written, NaN out (the whole cluster)
    if (rank == 0) {
      for (int i = tid; i < gt * dt; i += THREADS) store_elt(dst + i, NAN);
    }
    cp_async_wait<0>();
    return;
  }
  const int total = len + 1;
  lim = total;
  n_chunks = (total + KV_CHUNK - 1) / KV_CHUNK;
  const int c_new = len / KV_CHUNK;
  if (ic >= n_chunks) ic = -1;  // the row is shorter than the first request
  // The rest of the ring's first S - 1 chunks: one commit group a stage,
  // empty past the stream's end.
  advance(iv, ic);
#pragma unroll
  for (int k = 1; k < S - 1; ++k) {
    if (ic >= 0) {
      kv_issue_chunk<KV, D, THREADS>(a, stage_at(k), ic, dt, row_at);
    } else {
      cp_async_commit();
    }
    advance(iv, ic);
  }
  const auto inbox = [&](auto* p, int r) { return r == rank ? p : cluster.map_shared_rank(p, r); };
  bool waited = split == 1;  // on the cluster barrier's first phase

  float m_run, l_run, acc[VN];  // l_run: this lane's rows' share of the sum
  bool bad = false;
  int pos = 0;  // the stream position computed
  for (int v = rank; v < V; v += split) {  // one past the row's chunks sends an empty state
    m_run = -INFINITY;
    l_run = 0.f;
#pragma unroll
    for (int e = 0; e < VN; ++e) acc[e] = 0.f;
    for (int c = v; c < n_chunks; c += V, ++pos) {
      cp_async_wait<S - 2>();
      __syncthreads();  // chunk c landed; every warp is done with the stage it replaces
      if (ic >= 0) {  // the chunk S - 1 places ahead, into the stage chunk pos - 1 left
        kv_issue_chunk<KV, D, THREADS>(a, stage_at(pos + S - 1), ic, dt, row_at);
      } else {
        cp_async_commit();
      }
      advance(iv, ic);
      const int start = c * KV_CHUNK;
      const int n_pos = min(KV_CHUNK, total - start);
      if constexpr (PAGED) {  // a page id outside the pool among the chunk's: NaN for the row, nothing written
        bool miss = false;
        for (int p = start / a.page + lane; p <= (start + n_pos - 1) / a.page; p += 32) {
          const int pg = a.table[(size_t)b * a.max_pages + p];
          miss |= pg < 0 || pg >= a.n_pages;
        }
        if (__any_sync(0xffffffffu, miss)) {  // the same answer in every warp
          bad = true;
          continue;
        }
      }
      unsigned char* stage = stage_at(pos);
      const KV* kt = reinterpret_cast<const KV*>(stage);
      const KV* vt = reinterpret_cast<const KV*>(stage + L::TILE);
      float* kst = reinterpret_cast<float*>(stage + 2 * L::TILE);
      const float* vst = kst + KV_CHUNK;
      if (c == c_new) {  // the new token: appended at position len (once per kv head) and into the stage
        const int t_new = len - start;
        if (warp == 0) {
          const size_t at = row_at(len);
          KV* kc = static_cast<KV*>(a.k) + at * dt;
          KV* vc = static_cast<KV*>(a.v) + at * dt;
          KV* ks = reinterpret_cast<KV*>(stage) + t_new * D;
          KV* vs = reinterpret_cast<KV*>(stage + L::TILE) + t_new * D;
#pragma unroll
          for (int j = 0; j < DL; ++j) {
            const int e = lane + 32 * j;
            if (tile == 0 && e < dt) {
              kc[e] = wk[j];
              vc[e] = wv[j];
            }
            if (e < D) {
              ks[e] = wk[j];
              vs[e] = wv[j];
            }
          }
          if (INT8 && lane == 0) {
            if (tile == 0) {
              a.k_scale[at] = sk;
              a.v_scale[at] = sv;
            }
            kst[t_new] = sk;
            kst[KV_CHUNK + t_new] = sv;
          }
        }
        __syncthreads();
      }

      // (Head hg, part)'s positions [pb, pe) of the chunk, NSTEP row steps at
      // a time: each lane's rows' scores (VPR lanes dot their slices and
      // reduce by shuffles), the running max moved to cover them, then p =
      // exp(score - max) into the lane's sum and its slice of P.V.
      const int pb = part * pp, pe = min(pb + pp, n_pos);
      if (pv_warp) {
        for (int base = pb; base < pe; base += RPW * NSTEP) {
          float sc[NSTEP];
          float mx = -INFINITY;
#pragma unroll
          for (int k = 0; k < NSTEP; ++k) sc[k] = -INFINITY;
#pragma unroll
          for (int k = 0; k < NSTEP; ++k) {
            if (base + k * RPW >= pe) break;  // uniform over the warp
            const int t = base + k * RPW + rw;
            float f[VN];
            if (t < pe) {
              load16(kt + t * D + sub * VN, f);
            } else {
#pragma unroll
              for (int e = 0; e < VN; ++e) f[e] = 0.f;
            }
            float dot = 0.f;
#pragma unroll
            for (int e = 0; e < VN; ++e) dot += qr[e] * f[e];
#pragma unroll
            for (int o = VPR / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
            if (t < pe) sc[k] = INT8 ? dot * kst[t] * a.sm_scale : dot * a.sm_scale;
            mx = fmaxf(mx, sc[k]);
          }
#pragma unroll
          for (int o = VPR; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          const float m_new = fmaxf(m_run, mx);
          const float alpha = expf(m_run - m_new);  // 0 while m_run is -inf
          l_run *= alpha;
#pragma unroll
          for (int e = 0; e < VN; ++e) acc[e] *= alpha;
          m_run = m_new;
#pragma unroll
          for (int k = 0; k < NSTEP; ++k) {
            if (base + k * RPW >= pe) break;
            const int t = base + k * RPW + rw;
            if (t < pe) {
              const float p = expf(sc[k] - m_new);
              l_run += p;
              float f[VN];
              load16(vt + t * D + sub * VN, f);
              const float pv = INT8 ? p * vst[t] : p;
#pragma unroll
              for (int e = 0; e < VN; ++e) acc[e] += pv * f[e];
            }
          }
        }
      }
    }

    // Virtual rank v's state: each (head, part) warp's row slices summed by
    // shuffles; the parts of a head merged in part order; each head's max
    // and sum and the P.V of each output stored straight into the shared
    // memory of the rank that owns that output (rank r: outputs [r * share,
    // (r + 1) * share) of the tile's gt * D), in its slot v.
#pragma unroll
    for (int o = VPR; o < 32; o <<= 1) {
#pragma unroll
      for (int e = 0; e < VN; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
      l_run += __shfl_xor_sync(0xffffffffu, l_run, o);
    }
    if (pv_warp) {
      if (lane < VPR) {
#pragma unroll
        for (int e = 0; e < VN; ++e) st_acc[warp][lane * VN + e] = acc[e];
      }
      if (lane == 0) {
        st_m[warp] = m_run;
        st_l[warp] = l_run;
      }
    }
    __syncthreads();
    if (!waited) {
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
      waited = true;
    }
    for (int o = tid; o < gt * D; o += THREADS) {
      const int g = o / D, d = o % D, r = o / share;
      float mx = -INFINITY;
      for (int p = 0; p < parts; ++p) mx = fmaxf(mx, st_m[p * gt + g]);
      float num = 0.f, den = 0.f;
      if (mx != -INFINITY) {
        for (int p = 0; p < parts; ++p) {
          const float w = expf(st_m[p * gt + g] - mx);
          den += w * st_l[p * gt + g];
          num += w * st_acc[p * gt + g][d];
        }
      }
      *inbox(&in_acc[v * share + o - r * share], r) = num;
      if (d == 0) {
        for (int q = 0; q < split; ++q) {
          *inbox(&in_m[v][g], q) = mx;
          *inbox(&in_l[v][g], q) = den;
        }
      }
    }
    __syncthreads();  // st_* free for the next virtual rank
  }
  cp_async_wait<0>();  // requests past the stream's end (the first, speculative one) still in flight
  if (!waited) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (tid == 0) {  // whether this rank met a page outside the pool (NaN for the row)
    for (int q = 0; q < split; ++q) *inbox(&in_bad[rank], q) = bad;
  }
  if (split > 1) {
    cluster.sync();  // every rank's states delivered; no rank reads another's memory after this
  } else {
    __syncthreads();
  }

  // This rank's share of the outputs: the virtual ranks' states in order.
  bool nan = false;
  for (int q = 0; q < split; ++q) nan |= in_bad[q] != 0;
  for (int j = tid; j < share && rank * share + j < gt * D; j += THREADS) {
    const int o = rank * share + j, g = o / D;
    float mx = -INFINITY;
    for (int v = 0; v < V; ++v) mx = fmaxf(mx, in_m[v][g]);
    float num = 0.f, den = 0.f;
    for (int v = 0; v < V; ++v) {
      const float w = expf(in_m[v][g] - mx);
      den += w * in_l[v][g];
      num += w * in_acc[v * share + j];
    }
    if (o % D < dt) store_elt(dst + g * dt + o % D, nan ? NAN : num * (den == 0.f ? 1.f : 1.f / den));
  }
}

template <typename T, typename KV, int D, bool PAGED, int GT, typename O>
struct KvKernel {
  using Out = O;
  static constexpr int SMEM = KvStage<KV, D>::SMEM;

  // The kernel's dynamic shared-memory limit set to SMEM, once: with its
  // static shared memory the block may pass the default 48 KB (and the
  // static part counts against the same 227 KB, so not MAX_SMEM).
  static cudaError_t prepare() {
    static const cudaError_t e = cudaFuncSetAttribute(kv_attention_kernel<T, KV, D, PAGED, GT, O>,
                                                      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    return e;
  }

  static cudaError_t launch(const KvArgs& a, int b, O* out, int split, cudaStream_t st) {
    const cudaError_t e = prepare();
    if (e != cudaSuccess) return e;
    const int tiles = GT == 1 ? 1 : (a.hq / a.hk + GT - 1) / GT;
    return launch_clustered(kv_attention_kernel<T, KV, D, PAGED, GT, O>, dim3(split, a.hk * tiles, b), kv_threads<GT>(),
                            SMEM, split, st, a, out, tiles);
  }

  // Clusters of `split` blocks the device holds at once (minus a CUDA error).
  static int clusters(int split) {
    const cudaError_t e = prepare();
    if (e != cudaSuccess) return -static_cast<int>(e);
    bool prepared = true;
    return max_active_clusters(kv_attention_kernel<T, KV, D, PAGED, GT, O>, kv_threads<GT>(), SMEM, prepared,
                               split);
  }
};

// body(KvKernel<...>{}) for the kernel of (activation dtype, head dim, MHA
// or GQA): the cache holds the activations' dtype or int8 codes (INT8_KV);
// the attention vector is written in the activations' dtype, or in f32
// (F32_OUT). The instances: head dims 128, 64 and 32, and 16 for 16, 8, 4,
// 2 and 1 (with 32, 64 and 128 the divisors of 128 that the JAX rule
// admits, decode_attention.py:684); any other d launches nothing and gives
// `refused`.
template <bool INT8_KV, bool PAGED, bool F32_OUT, typename Body>
int with_kv_kernel(int bf16, int d, bool gqa, int refused, const Body& body) {
  const auto pick = [&](auto dd) -> int {
    constexpr int D = decltype(dd)::value;
    const auto as = [&](auto t) -> int {
      using T = decltype(t);
      using KV = std::conditional_t<INT8_KV, int8_t, T>;
      using O = std::conditional_t<F32_OUT, float, T>;
      return gqa ? body(KvKernel<T, KV, D, PAGED, KV_GT, O>{}) : body(KvKernel<T, KV, D, PAGED, 1, O>{});
    };
    return bf16 ? as(__nv_bfloat16{}) : as(0.f);
  };
  switch (d) {
    case 128: return pick(std::integral_constant<int, 128>{});
    case 64: return pick(std::integral_constant<int, 64>{});
    case 32: return pick(std::integral_constant<int, 32>{});
    case 16: case 8: case 4: case 2: case 1: return pick(std::integral_constant<int, 16>{});
    default: return refused;
  }
}

// One launch of the KV attention of `b` rows as clusters of `split` blocks.
template <bool INT8_KV, bool PAGED, bool F32_OUT = false>
int run_kv_attention(KvArgs a, int bf16, int b, int d, void* out, int split, void* stream) {
  const int refused = static_cast<int>(cudaErrorInvalidValue);
  if (b < 1 || a.hk < 1 || a.hq < a.hk || a.hq % a.hk || a.cap < 1 || split < 1 || split > KV_MAX_SPLIT ||
      (PAGED && (a.page < 1 || a.max_pages < 1 || a.n_pages < 1))) {
    return refused;
  }
  a.d = d;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_kv_kernel<INT8_KV, PAGED, F32_OUT>(bf16, d, a.hq > a.hk, refused, [&](auto k) {
    using K = decltype(k);
    return static_cast<int>(K::launch(a, b, static_cast<typename K::Out*>(out), split, st));
  });
}

// The clusters of `split` blocks of that kernel the device holds at once,
// or minus a CUDA error: attention.py kv_plan keeps every cluster of a
// launch resident within it.
template <bool INT8_KV, bool PAGED, bool F32_OUT = false>
int kv_clusters(int bf16, int d, int gqa, int split) {
  const int refused = -static_cast<int>(cudaErrorInvalidValue);
  if (split < 1 || split > KV_MAX_SPLIT) return refused;
  return with_kv_kernel<INT8_KV, PAGED, F32_OUT>(bf16, d, gqa != 0, refused,
                                                 [&](auto k) { return decltype(k)::clusters(split); });
}

// The arguments every KV entry point shares: the three operands with their
// row strides, the head counts and the lengths.
KvArgs kv_args(const void* q, const void* k_new, const void* v_new, long long q_stride, long long kn_stride,
               long long vn_stride, int hq, int hk, const int* kv_len, float sm_scale) {
  KvArgs a{};
  a.q = q;
  a.k_new = k_new;
  a.v_new = v_new;
  a.q_stride = q_stride;
  a.kn_stride = kn_stride;
  a.vn_stride = vn_stride;
  a.hq = hq;
  a.hk = hk;
  a.kv_len = kv_len;
  a.sm_scale = sm_scale;
  return a;
}

}  // namespace
}  // namespace rt
