// Paged attention over the shared KV block pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel paged_attention_pallas
// (src/repro/kernels/paged_attention/kernel.py, _paged_attention_kernel).
// For each batch row b it
//   * stores the row's S new K/V cells in place through the *write*
//     table at pos = cache_index[b] + s (block pos / bs, offset pos % bs);
//     positions past the table width go to the trash block 0, as
//     models/attention.py's paged_write_cells does (the TPU kernel clips
//     the column instead; the two agree on every state the scheduler
//     reaches); a trash cell that several (row, position) pairs write
//     (every row not decoding writes there) takes the last one's value in
//     row-major order, as the plain version's sequential scatter, so it
//     holds the same bits whatever order the threads run in;
//   * reads the row's keys through the *read* table, cropped to T;
//   * scores in f32 times 1/sqrt(hd), masks kpos <= qpos with -1e30,
//     applies the optional tanh softcap, takes a plain softmax (max, exp,
//     sum, divide), casts the probabilities to bf16 and sums p * V in
//     f32, written in bf16.
// q, k_new, v_new: [B,S,KV,G,hd] / [B,S,KV,hd] of type QT (bf16 or f32);
// pools [NB,bs,KV,hd] bf16; out [B,S,KV,G,hd] bf16.
//
// What bounds it: each (row, KV head) reads ~2 * T * hd pool elements
// and does ~4 * T * hd flops per query, about 4 flops per byte for G = 8,
// so device-memory bytes bound it; at decode depths of a few hundred
// tokens the bound is well under a microsecond and the time is latency:
// the launch, the table lookup, and the dependent loads of the rows.
//
// What the design does about it:
//   * A CTA of `warps` warps (8) per (row, KV head, group of queries,
//     part of the window); a warp owns one query (s, g), so the G heads
//     and S queries that share a KV head read each staged key and value
//     row once from shared memory.
//   * Rows are staged `chunk` (128) keys a tile with cp.async, 16-byte
//     lanes on neighbouring addresses of a pool row, through a ring of
//     `stages` tiles: a part's K tiles, then its V tiles.  The first
//     tiles (at decode: the whole K and V of the window) are requested
//     first thing, before the row's cache_index is known, so the read is
//     one round of memory latency, overlapped with the loads that the
//     masking depends on.  Rows are padded in shared memory
//     so the score loop (one key per lane) reads without bank conflicts.
//   * The exact plain softmax of the reference: each warp keeps its
//     query's scores in shared memory, takes their max m and the sum l
//     of exp(s - m); p = bf16(exp(s - m) / l) then weights V, summed in
//     f32, every lane reading p_t at once and V with the widest loads
//     its dims allow.
//   * A window longer than one tile is split over `splits` CTAs (up to
//     8), which form one thread block cluster; CTA r takes the window's
//     tiles r, r + splits, ...  After its K tiles each CTA puts its
//     queries' (m, l) in its shared memory; after a cluster barrier
//     every CTA reads all of them through distributed shared memory, in
//     rank order, and so holds the window's max and sum, against which
//     it rounds p as the reference does.  Each CTA's p * V is left in its
//     shared memory; after a second barrier CTA r adds every CTA's part
//     of its share of the outputs, in rank order, and writes them.  The
//     order of every sum is fixed, so two runs on the same inputs give
//     the same bits, and no buffer, ticket or atomic outlives the
//     launch, so calls on any streams are independent.
//   * Two launches from one entry point, in one stream: the first stores
//     every row's new cells (the pools are updated in place: the TPU
//     kernel's input_output_aliases), the second attends, and stream
//     order makes every store visible to it.  CTAs of one launch have no
//     order between them, so a single launch needs the CTA that reads a
//     row's cells to hold the stored values itself; that design (the CTA
//     stores its row's cells and patches its own copies of them) was
//     measured slower on an H100 at decode, 0.0117 against 0.0104 ms at
//     T=81 and 0.0146 against 0.0114 at T=128 (PERF.md): its
//     store and patch sit on the path of the only 8 CTAs, where the
//     store launch spreads the store over the card.
// With no softcap the keys stop at the CTA's last query position:
// masked keys contribute exactly 0 after exp, so that changes no result;
// with a softcap a masked score is tanh(-1e30/c)*c = -c, not -inf, so
// all T keys are visited, as the composition does.
//
// The launch plan (warps, chunk, padded row, query groups, splits, score
// slots, ring depth, shared bytes and where each region of them sits) is
// made by attention_plan in ops.py; this file only checks that it can
// run it.  The limits the plan shares with it (MAX_WARPS, MMA_ROWS,
// MAX_STAGES, MAX_HD) are ops.NVCC_DEFINES, given to nvcc as -D macros
// by kernels/_build.py.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <utility>

#if !defined(MAX_WARPS) || !defined(MMA_ROWS) || !defined(MAX_STAGES) || \
    !defined(MAX_HD)
#error "build with the -D macros of paged_attention/ops.py (kernels/_build.py)"
#endif
static_assert(MMA_ROWS == 16, "the rows of an m16n8k16 mma tile");
static_assert(MAX_WARPS <= MMA_ROWS, "a CTA's queries fit one mma tile");

namespace cg = cooperative_groups;

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_DEVICES = 64;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 to_bf16(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most min(n, N) of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait_upto(int n) {
  if constexpr (N == 0) {
    asm volatile("cp.async.wait_group 0;\n" ::);
  } else {
    if (n >= N)
      asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
    else
      cp_wait_upto<N - 1>(n);
  }
}
// wait until at most n of this thread's groups are in flight (all but
// the ring's MAX_STAGES - 1 newest at most)
__device__ __forceinline__ void cp_wait(int n) {
  cp_wait_upto<MAX_STAGES - 1>(n);
}

// the pool cell (block, offset) new position pos of row b goes to;
// past-width positions go to the trash block 0
__device__ __forceinline__ int write_block(const int* write_table, int b,
                                           int pos, int bs, int W) {
  const int col = pos / bs;
  return col < W ? write_table[(size_t)b * W + col] : 0;
}

// whether a later (row, position) of the call, in row-major order,
// writes the trash cell (0, off) too; only block 0 is shared between rows
// (the rows not decoding and the positions past a table's width all
// write there), and its last writer wins, as in the plain version
__device__ __forceinline__ bool overwritten_later(
    const int* write_table, const int* cache_index, int b, int s, int off,
    int B, int S, int bs, int W) {
  for (int j = b * S + s + 1; j < B * S; ++j) {
    const int pos = cache_index[j / S] + j % S;
    if (pos % bs == off && write_block(write_table, j / S, pos, bs, W) == 0)
      return true;
  }
  return false;
}

// one element of a row's new cells into the pool
template <typename QT>
__device__ __forceinline__ void store_cell(
    const QT* k_new, const QT* v_new, bf16* k_pool, bf16* v_pool,
    const int* write_table, const int* cache_index, int b, int s, int h,
    int d, int B, int S, int KV, int hd, int bs, int W) {
  const size_t src = (((size_t)b * S + s) * KV + h) * hd + d;
  const int pos = cache_index[b] + s;
  const int phys = write_block(write_table, b, pos, bs, W);
  if (phys == 0 && overwritten_later(write_table, cache_index, b, s,
                                     pos % bs, B, S, bs, W))
    return;
  const size_t dst = (((size_t)phys * bs + pos % bs) * KV + h) * hd + d;
  k_pool[dst] = to_bf16(to_f(k_new[src]));
  v_pool[dst] = to_bf16(to_f(v_new[src]));
}

// every row's new cells: one thread per element of k_new / v_new
template <typename QT>
__global__ void store_kernel(const QT* __restrict__ k_new,
                             const QT* __restrict__ v_new, bf16* k_pool,
                             bf16* v_pool,
                             const int* __restrict__ write_table,
                             const int* __restrict__ cache_index, int B,
                             int S, int KV, int hd, int bs, int W) {
  const size_t n = (size_t)B * S * KV * hd;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    const int d = (int)(i % hd);
    const int h = (int)(i / hd % KV);
    const int s = (int)(i / ((size_t)hd * KV) % S);
    const int b = (int)(i / ((size_t)hd * KV * S));
    store_cell(k_new, v_new, k_pool, v_pool, write_table, cache_index, b, s,
               h, d, B, S, KV, hd, bs, W);
  }
}

// ldmatrix and mma.sync on bf16 tiles in shared memory: an 8 x 8 matrix
// of 16-bit elements is 8 rows of 16 bytes, whose addresses lanes 8i..8i+7
// give for the i-th matrix; lane l receives row l / 4, elements
// 2 (l % 4) and 2 (l % 4) + 1 of each
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x2_trans(unsigned (&r)[2],
                                              const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}
// c += a (16 x 16, row-major) * b (16 x 8, column-major), f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Shared memory of a CTA, placed by ops.smem_layout (byte offsets): each
// warp's p * V (f32, for the cluster's sum) from 0, each warp's (max,
// sum) at `stats`, each warp's scores of up to kpc keys at `scores`, the
// queries as MMA_ROWS bf16 rows at `qhi` (their high parts) and `qlo`
// (what f32 queries have below bf16), p as MMA_ROWS bf16 rows of `prow`
// elements at `probs`, then the ring of `stages` tiles of chunk rows of
// `row` bf16 elements at `tiles`.
struct Smem {
  int stats, scores, qhi, qlo, probs, tiles, prow;
};

// the layout is 16-byte aligned and each region holds what the kernel
// puts in it
bool layout_fits(const Smem& l, int warps, int hd, int kpc, int chunk,
                 int row, int stages, int smem) {
  typedef long long ll;
  const int offs[] = {l.stats, l.scores, l.qhi, l.qlo, l.probs, l.tiles};
  for (int o : offs)
    if (o % 16 != 0) return false;
  return l.stats >= (ll)warps * hd * (ll)sizeof(float) &&
         l.scores >= l.stats + (ll)warps * (ll)sizeof(float2) &&
         l.qhi >= l.scores + (ll)warps * kpc * (ll)sizeof(float) &&
         l.qlo >= l.qhi + (ll)MMA_ROWS * row * (ll)sizeof(bf16) &&
         l.probs >= l.qlo + (ll)MMA_ROWS * row * (ll)sizeof(bf16) &&
         l.prow >= kpc && l.prow % 8 == 0 &&
         l.tiles >= l.probs + (ll)MMA_ROWS * l.prow * (ll)sizeof(bf16) &&
         (ll)smem >= l.tiles + (ll)stages * chunk * row * (ll)sizeof(bf16);
}

template <typename QT, int DPL>
__global__ void __launch_bounds__(MAX_WARPS * 32)
paged_attention_kernel(const QT* __restrict__ q,
                       const bf16* __restrict__ k_pool,
                       const bf16* __restrict__ v_pool,
                       const int* __restrict__ block_table,
                       const int* __restrict__ cache_index,
                       bf16* __restrict__ out, int S, int KV, int G, int bs,
                       int W, int T, float softcap, float scale, int chunk,
                       int kpc, int row, int stages, Smem lay) {
  constexpr int hd = 32 * DPL;
  constexpr int CPR = hd / 8;                     // 16-byte parts of a row
  constexpr int DTILES = hd / 8;                  // mma column tiles of hd
  constexpr int MAX_DT = (DTILES + MAX_WARPS - 1) / MAX_WARPS;  // a warp's
  constexpr bool F32Q = sizeof(QT) == 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const int nthr = blockDim.x;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int grp = lane / 4;                       // mma row of this lane
  const int quad = lane % 4;                      // its column pair
  const int rank = blockIdx.x;                    // in the cluster
  const int splits = gridDim.x;
  const int qg = blockIdx.y;                      // query group
  const int b = blockIdx.z / KV;
  const int h = blockIdx.z % KV;
  const int nq = S * G;
  const int qi = qg * warps + warp;               // this warp's query
  const bool live = qi < nq;
  const int s = live ? qi / G : 0;
  const int g = live ? qi % G : 0;
  const int prow = lay.prow;                       // bf16 per row of p

  float* parts = reinterpret_cast<float*>(smem);  // [warps][hd]
  float2* stats = reinterpret_cast<float2*>(smem + lay.stats);
  float* scw = reinterpret_cast<float*>(smem + lay.scores) +
               (size_t)warp * kpc;
  bf16* qhi = reinterpret_cast<bf16*>(smem + lay.qhi);
  bf16* qlo = reinterpret_cast<bf16*>(smem + lay.qlo);
  bf16* probs = reinterpret_cast<bf16*>(smem + lay.probs);
  bf16* tiles = reinterpret_cast<bf16*>(smem + lay.tiles);

  // this CTA's tiles of the window: chunks rank, rank + splits, ...; K
  // tiles first, then V tiles; tile i sits in ring slot i % stages.
  // Thread tid copies 16-byte part tid % CPR of rows tid / CPR + k * RP.
  const int* table = block_table + (size_t)b * W;
  const int nch_T = (T + chunk - 1) / chunk;
  const int nloc_T = (nch_T - rank + splits - 1) / splits;
  const int ntiles = 2 * nloc_T;
  const int part = tid % CPR;
  const int RP = nthr / CPR;                      // rows per pass
  const int r0 = tid / CPR < RP ? tid / CPR : chunk;   // idle past RP
  auto chunk0 = [&](int i) {
    return (rank + (i < nloc_T ? i : i - nloc_T) * splits) * chunk;
  };
  auto slot = [&](int i) { return tiles + (size_t)(i % stages) * chunk * row; };
  // request rows [c0, min(c0 + chunk, limit)) of tile i
  auto issue = [&](int i, int limit) {
    const bf16* pool = i < nloc_T ? k_pool : v_pool;
    const int c0 = chunk0(i);
    const int rows = min(chunk, limit - c0);
    bf16* dst = slot(i) + part * 8;
#pragma unroll 4
    for (int r = r0; r < rows; r += RP) {
      const int t = c0 + r;
      const int blk = __ldg(table + t / bs);
      cp_async16(dst + r * row,
                 pool + (((size_t)blk * bs + t % bs) * KV + h) * hd +
                     part * 8);
    }
    cp_commit();
  };

  // first what needs no cache_index: the first tiles, up to T
  const int ci = cache_index[b];
  int issued = min(stages, ntiles);
  for (int i = 0; i < issued; ++i) issue(i, T);
  // this warp's query as the bf16 row `warp` of the mma's A operand (an
  // f32 query also as what it has below bf16, a second row); rows of no
  // query only reach mma rows that are not read
  if (live) {
    const QT* qp = q + ((((size_t)b * S + s) * KV + h) * G + g) * hd;
    for (int d = lane; d < hd; d += 32) {
      const float f = to_f(qp[d]);
      const bf16 hi = to_bf16(f);
      qhi[warp * row + d] = hi;
      if (F32Q) qlo[warp * row + d] = to_bf16(f - __bfloat162float(hi));
    }
  }
  // keys the CTA's queries see: up to its last query's position, or all T
  const int s_last = min(nq - 1, qg * warps + warps - 1) / G;
  const int tend = softcap > 0.f ? T : min(ci + s_last + 1, T);
  const int nch = (tend + chunk - 1) / chunk;
  const int nloc = rank < nch ? (nch - rank + splits - 1) / splits : 0;

  cg::cluster_group cluster = cg::this_cluster();
  float m = -INFINITY, l = 0.f;
  // p * V: this warp's column tiles of hd (dims 8 dt .. 8 dt + 7) for
  // every mma row (rows of no query are not read)
  float acc[MAX_DT][4];
#pragma unroll
  for (int i = 0; i < MAX_DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    const int j = i < nloc_T ? i : i - nloc_T;    // local chunk
    const int c0 = chunk0(i);
    const int n = min(chunk, tend - c0);          // keys of the tile seen
    if (i == nloc_T && live) {
      // every K tile done: the softmax's max and sum over this CTA's keys
      for (int jj = 0; jj < nloc; ++jj) {
        const int nn = min(chunk, tend - chunk0(jj));
        for (int r = lane; r < nn; r += 32) m = fmaxf(m, scw[jj * chunk + r]);
      }
      m = warp_max(m);
      for (int jj = 0; jj < nloc; ++jj) {
        const int nn = min(chunk, tend - chunk0(jj));
        for (int r = lane; r < nn; r += 32) l += expf(scw[jj * chunk + r] - m);
      }
      l = warp_sum(l);
    }
    if (i == nloc_T && splits > 1) {
      // the window's max and sum, from every CTA's, in rank order
      if (lane == 0) stats[warp] = make_float2(m, l);
      cluster.sync();
      float mw = -INFINITY, lw = 0.f;
      for (int r = 0; r < splits; ++r)
        mw = fmaxf(mw, cluster.map_shared_rank(stats, r)[warp].x);
      for (int r = 0; r < splits; ++r) {
        const float2 st = cluster.map_shared_rank(stats, r)[warp];
        if (st.y > 0.f) lw += st.y * expf(st.x - mw);
      }
      m = mw;
      l = lw;
    }
    if (i == nloc_T && live) {
      // p = bf16(exp(s - m) / l), row `warp` of the second mma's A
      // operand; 0 past the keys seen, up to the mma's 16-key steps
      for (int jj = 0; jj < nloc; ++jj) {
        const int nn = min(chunk, tend - chunk0(jj));
        const int n16 = min(chunk, (nn + 15) / 16 * 16);
        bf16* pr = probs + warp * prow + jj * chunk;
        for (int r = lane; r < n16; r += 32)
          pr[r] = r < nn ? to_bf16(expf(scw[jj * chunk + r] - m) / l)
                         : to_bf16(0.f);
      }
    }

    cp_wait(issued - i - 1);
    if (i >= nloc_T && j < nloc) {
      // V rows past the keys seen, up to the 16-key step, may hold any
      // bits; p is 0 there, and 0 * V must be 0
      const int n16 = min(chunk, (n + 15) / 16 * 16);
      bf16* vt = slot(i);
      for (int idx = n * CPR + tid; idx < n16 * CPR; idx += nthr)
        *reinterpret_cast<uint4*>(vt + (idx / CPR) * row + (idx % CPR) * 8) =
            make_uint4(0, 0, 0, 0);
    }
    __syncthreads();
    if (j < nloc) {
      const bf16* tile = slot(i);
      if (i < nloc_T) {
        // scores: warp w takes the tile's key groups w, w + warps, ... of
        // 8 keys; mma rows are the CTA's queries
        for (int kt = warp; kt * 8 < n; kt += warps) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int ks = 0; ks < hd / 16; ++ks) {
            unsigned a[4], bk[2];
            ldsm_x4(a, qhi + (lane % 16) * row + ks * 16 + (lane / 16) * 8);
            ldsm_x2(bk, tile + (kt * 8 + lane % 8) * row + ks * 16 +
                            ((lane / 8) % 2) * 8);
            mma_bf16(c, a, bk);
            if (F32Q) {
              ldsm_x4(a, qlo + (lane % 16) * row + ks * 16 + (lane / 16) * 8);
              mma_bf16(c, a, bk);
            }
          }
          // lane holds query grp's scores of keys kt * 8 + 2 quad (+1)
          const int qo = qg * warps + grp;
          if (grp < warps && qo < nq) {
            const int qp = ci + qo / G;
            float* sc = scw + (size_t)(grp - warp) * kpc + j * chunk;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int r = kt * 8 + 2 * quad + e;
              if (r >= n) continue;
              float v = c[e] * scale;
              if (c0 + r > qp) v = NEG_INF;
              if (softcap > 0.f) v = tanhf(v / softcap) * softcap;
              sc[r] = v;
            }
          }
        }
      } else {
        // p * V: warp w takes column tiles w, w + warps, ... of hd; the
        // keys in steps of 16, V read transposed into the B operand
        const int ksteps = (n + 15) / 16;
        const bf16* pr = probs + j * chunk;
#pragma unroll
        for (int u = 0; u < MAX_DT; ++u) {
          const int dt = warp + u * warps;
          if (dt >= DTILES) break;
          for (int ks = 0; ks < ksteps; ++ks) {
            unsigned a[4], bv[2];
            ldsm_x4(a, pr + (lane % 16) * prow + ks * 16 + (lane / 16) * 8);
            ldsm_x2_trans(bv, tile + (ks * 16 + lane % 8 +
                                      ((lane / 8) % 2) * 8) * row + dt * 8);
            mma_bf16(acc[u], a, bv);
          }
        }
      }
    }
    __syncthreads();                              // the slot is free
    if (issued < ntiles) issue(issued++, tend);
  }

  // lane holds rows grp (and grp + 8, not read) of its column tiles:
  // query qg * warps + grp, dims 8 dt + 2 quad (+1)
  const int qo = qg * warps + grp;
  const bool mine = grp < warps && qo < nq;
  if (splits == 1) {
    if (mine) {
      bf16* op = out + ((((size_t)b * S + qo / G) * KV + h) * G + qo % G) * hd;
#pragma unroll
      for (int u = 0; u < MAX_DT; ++u) {
        const int dt = warp + u * warps;
        if (dt >= DTILES) break;
        *reinterpret_cast<__nv_bfloat162*>(op + dt * 8 + 2 * quad) =
            __floats2bfloat162_rn(acc[u][0], acc[u][1]);
      }
    }
    return;
  }
  // each CTA's p * V in its shared memory; CTA `rank` sums every CTA's
  // part of each rank-th block of outputs, in rank order
  if (grp < warps) {
#pragma unroll
    for (int u = 0; u < MAX_DT; ++u) {
      const int dt = warp + u * warps;
      if (dt >= DTILES) break;
      parts[grp * hd + dt * 8 + 2 * quad] = acc[u][0];
      parts[grp * hd + dt * 8 + 2 * quad + 1] = acc[u][1];
    }
  }
  cluster.sync();
  for (int idx = rank * nthr + tid; idx < warps * hd; idx += splits * nthr) {
    const int qq = qg * warps + idx / hd;
    if (qq >= nq) continue;
    float sum = 0.f;
    for (int r = 0; r < splits; ++r)
      sum += cluster.map_shared_rank(parts, r)[idx];
    out[((((size_t)b * S + qq / G) * KV + h) * G + qq % G) * hd + idx % hd] =
        to_bf16(sum);
  }
  cluster.sync();            // no CTA leaves while its part is being read
}

template <typename QT, int DPL>
int launch(const void* q, const void* k_new, const void* v_new, void* k_pool,
           void* v_pool, const void* block_table, const void* write_table,
           const void* cache_index, void* out, int B, int S, int KV, int G,
           int bs, int W, int T, float softcap, float scale, int warps,
           int chunk, int row, int query_groups, int splits, int kpc,
           int stages, int smem, Smem lay, cudaStream_t st) {
  constexpr int hd = 32 * DPL;
  // the new cells first
  const size_t cells = (size_t)B * S * KV * hd;
  const int sblocks = (int)((cells + 255) / 256);
  store_kernel<QT><<<sblocks, 256, 0, st>>>(
      static_cast<const QT*>(k_new), static_cast<const QT*>(v_new),
      static_cast<bf16*>(k_pool), static_cast<bf16*>(v_pool),
      static_cast<const int*>(write_table),
      static_cast<const int*>(cache_index), B, S, KV, hd, bs, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto kern = paged_attention_kernel<QT, DPL>;
  // the shared-memory attribute, set once per device and size
  static int attr_set[MAX_DEVICES] = {};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (smem > attr_set[dev]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = smem;
  }
  const dim3 grid(splits, query_groups, B * KV);
#define PA_KARGS static_cast<const QT*>(q), static_cast<const bf16*>(k_pool), \
    static_cast<const bf16*>(v_pool), static_cast<const int*>(block_table),  \
    static_cast<const int*>(cache_index), static_cast<bf16*>(out), S, KV,    \
    G, bs, W, T, softcap, scale, chunk, kpc, row, stages, lay
  if (splits == 1) {
    kern<<<grid, warps * 32, smem, st>>>(PA_KARGS);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, PA_KARGS);
#undef PA_KARGS
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the instantiation of head_dim hd = 32 (I + 1), one of I = 0, 1, ...,
// MAX_HD / 32 - 1, or an error
template <typename QT, int... I>
int launch_hd(std::integer_sequence<int, I...>, int hd, const void* q,
              const void* k_new, const void* v_new, void* k_pool,
              void* v_pool, const void* block_table,
              const void* write_table, const void* cache_index, void* out,
              int B, int S, int KV, int G, int bs, int W, int T,
              float softcap, float scale, int warps, int chunk, int row,
              int query_groups, int splits, int kpc, int stages, int smem,
              Smem lay, cudaStream_t st) {
  int r = (int)cudaErrorInvalidValue;
  ((hd == 32 * (I + 1) &&
    (r = launch<QT, I + 1>(q, k_new, v_new, k_pool, v_pool, block_table,
                           write_table, cache_index, out, B, S, KV, G, bs, W,
                           T, softcap, scale, warps, chunk, row,
                           query_groups, splits, kpc, stages, smem, lay, st),
     true)) ||
   ...);
  return r;
}

}  // namespace

// The plan, from ops.attention_plan: `warps` queries per CTA, `chunk`
// keys a tile, `row` bf16 elements per staged row, `query_groups` CTAs
// over the S * G queries, `splits` CTAs (one cluster) over the window,
// `kpc` score slots per warp, `stages` ring tiles, `smem` dynamic
// shared bytes, laid out as ops.smem_layout says: the byte offsets
// `stats` ... `tiles` and `prow` bf16 elements per row of p (Smem).
extern "C" int paged_attention_launch(
    const void* q, const void* k_new, const void* v_new, void* k_pool,
    void* v_pool, const void* block_table, const void* write_table,
    const void* cache_index, void* out, int B, int S, int KV, int G, int hd,
    int bs, int W, int T, float softcap, float scale, int q_bf16, int warps,
    int chunk, int row, int query_groups, int splits, int kpc, int stages,
    int smem, int stats, int scores, int qhi, int qlo, int probs, int tiles,
    int prow, void* stream) {
  const Smem lay = {stats, scores, qhi, qlo, probs, tiles, prow};
  const long long nch = chunk > 0 ? ((long long)T + chunk - 1) / chunk : 0;
  const int rp = hd >= 8 ? warps * 32 / (hd / 8) : 0;  // rows per copy pass
  const bool ok =
      B > 0 && S > 0 && G > 0 && KV > 0 && hd % 32 == 0 && hd > 0 &&
      hd <= MAX_HD && rp > 0 && bs > 0 && W > 0 && T > 0 &&
      (long long)T <= (long long)W * bs && warps > 0 && warps <= MAX_WARPS &&
      warps * ((hd / 8 + MAX_WARPS - 1) / MAX_WARPS) >= hd / 8 &&
      chunk > 0 && chunk % 16 == 0 &&
      row >= hd && row % 8 == 0 &&
      query_groups > 0 && (long long)query_groups * warps >= (long long)S * G &&
      splits >= 1 && splits <= nch && kpc % chunk == 0 &&
      (long long)kpc >= (nch + splits - 1) / splits * chunk && stages >= 2 &&
      stages <= MAX_STAGES &&
      layout_fits(lay, warps, hd, kpc, chunk, row, stages, smem);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PA_ARGS hd, q, k_new, v_new, k_pool, v_pool, block_table, \
    write_table, cache_index, out, B, S, KV, G, bs, W, T, softcap, scale, \
    warps, chunk, row, query_groups, splits, kpc, stages, smem, lay, st
  const auto dims = std::make_integer_sequence<int, MAX_HD / 32>{};
  if (q_bf16) return launch_hd<bf16>(dims, PA_ARGS);
  return launch_hd<float>(dims, PA_ARGS);
#undef PA_ARGS
}
