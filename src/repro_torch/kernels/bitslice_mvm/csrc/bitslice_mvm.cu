// Bit-sliced integer MVM with the shift-and-add fused into the
// accumulation, for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/bitslice_mvm/kernel.py:
//   SCALED=true  -> bitslice_mvm_scaled_pallas (_bitslice_mvm_scaled_kernel):
//                   out[M,N] f32 = (sum_s (x @ P_s) << (bps*s)).to(f32) * row_scale
//   SCALED=false -> bitslice_mvm_pallas (_bitslice_mvm_kernel):
//                   out[M,N] i32 =  sum_s (x @ P_s) << (bps*s)
// with x [M,K] int8 (rows ldx bytes apart), P [S,K,N] int8 (S <= 4),
// row_scale [M] f32.
//
// What bounds it: at decode M is 1..32, so each plane byte is used by at
// most M multiply-adds; the kernel reads S*K*N plane bytes and is bound
// by device-memory bytes (Qwen2.5-3B: 4 planes x 2048 x 11008 = 90 MB
// per up-projection, 27 us at 3.35 TB/s), not by integer operations.
// What it takes to reach that: enough bytes in flight on every SM, and
// few enough instructions per plane byte that issue does not limit.
//
// What the design does about it:
//   * A CTA owns BN = 128 output columns, so every K row of a plane it
//     reads is one full 128-byte line, and MT rows of x (1, 4, 8 or 16,
//     chosen by the plan from M, so no registers go to rows that do not
//     exist; larger M takes several row tiles).  Row tiles sit on grid z,
//     which CUDA caps at 65535 CTAs (MAX_GRID_Z), so past that a CTA
//     walks the row tiles blockIdx.z, blockIdx.z + gridDim.z, ... in
//     turn (WALK, row tiles of 16 only): one launch takes any M (a
//     ResNet-20 conv over 1024 images has 1024 x 32 x 32 rows, 65536
//     tiles of 16).  The walk is an instantiation of its own: a loop
//     around the pipeline in every instantiation took each to the
//     128-register cap of two CTAs an SM, with spills in half of them,
//     and slowed K2 at decode by a third on an H100.  Up to 65535 tiles,
//     as at every decode and prefill shape, each CTA takes one tile in
//     a loop that never repeats, which compiles as the single tile did.
//   * Split-K over a thread block cluster: where the output tiles alone
//     leave SMs idle, the plan cuts the K range into `splits` parts, one
//     CTA each, and the parts of one output tile form one cluster (grid
//     x).  Each CTA sums its part in its own shared memory; after a
//     cluster barrier, CTA r of the cluster reads every CTA's part of
//     its share of the tile through distributed shared memory, in rank
//     order, adds them and runs the epilogue once on the *full* integer
//     sum, so int -> f32 (rn) x row_scale is bit-exact with the plain
//     version.  No workspace in device memory, no ticket and no atomic
//     outside the CTA: nothing outlives the launch, so calls on any
//     streams are independent, and integer sums are exact, so the
//     result is the same on every run.
//   * A cp.async ring of BK = 64 K rows a stage (S x 64 x 128 plane
//     bytes + MT x 64 x bytes), the next stages loading while one is
//     used; the plan picks the depth (more stages when a stage is
//     small, as with one plane).
//   * Both multiply units want four K-consecutive bytes of one column in
//     a register; the planes hold N-consecutive bytes.  A lane reads one
//     32-bit word (four columns) from each of four K rows and eight
//     __byte_perm turn them into four K-major words, one per column.
//   * Row tiles of 1 and 4 multiply with __dp4a: warp w takes K rows
//     8w..8w+7 of a stage and lane l the columns 4l..4l+3, so each word
//     above meets MT rows of x.  Row tiles of 8 and 16 multiply on the
//     tensor cores, int8 mma.sync m16n8k32 with int32 sums: the MT rows
//     are those of one 16-row A tile (rows past MT are zeros), and one
//     instruction does 16 x 8 x 32 multiply-adds where __dp4a does 4 a
//     lane, so the work per plane byte no longer grows with M; warp w
//     takes the K half w % 2 of a stage (one mma step of 32 rows) and
//     the 32 columns w / 2, four mma n-tiles, the four words of a lane
//     one for each tile (tile j's n-th column is column 4n + j).  On an
//     H100 the tensor cores lost to __dp4a at one and four rows
//     (PERF.md), where the kernel waits on memory, not on issue.
//   * A warp's read of four columns from each of four K rows touches one
//     row at a time with __dp4a, 32 lanes on one 128-byte row; with mma
//     it touches four rows at once, so there the 16-byte chunks of a
//     staged row sit XOR-swizzled by the row's K quad, and the 32 lanes
//     hit 32 banks.
//   * Each plane's sums over a stage are shifted by bps*s as they are
//     added (the paper's shift during transfer); the warps that share
//     an output meet through shared-memory integer atomics.
// Bounds: per plane |partial| <= 127*3*11008 < 2^23 and shifted by at
// most 6 bits it stays < 2^31; the recombined sum is x @ wq with
// |x|, |wq| <= 127, < 2^31 for K < 2^17.
//
// The launch plan (mt, stages, splits, the ring's bytes) is made by
// mvm_plan in ops.py; this file only checks that it can run it.  The
// constants the plan shares with it (BN, BK, VEC, MAX_S, CTAS_PER_SM,
// the row tiles ROW_TILE0..3 and ring depths SHALLOW and DEEP it is
// built for) are ops.NVCC_DEFINES, given to nvcc as -D macros by
// kernels/_build.py.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(BN) || !defined(BK) || !defined(VEC) || !defined(MAX_S) || \
    !defined(CTAS_PER_SM) || !defined(SHALLOW) || !defined(DEEP) ||        \
    !defined(ROW_TILE0) || !defined(ROW_TILE1) || !defined(ROW_TILE2) ||  \
    !defined(ROW_TILE3) || !defined(MAX_GRID_Z)
#error "build with the -D macros of bitslice_mvm/ops.py (kernels/_build.py)"
#endif
#define ROW_TILES ROW_TILE0, ROW_TILE1, ROW_TILE2, ROW_TILE3
#define STAGE_DEPTHS SHALLOW, DEEP

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KQ = BK / WARPS / 4;        // __dp4a: K quads a warp a stage
constexpr int KHALF = 32;                 // mma: K rows of one mma step
constexpr int WCOLS = 32;                 // mma: columns of a warp
constexpr int MMA_MIN_ROWS = 8;           // row tiles from 8 on use mma
static_assert(KQ * WARPS * 4 == BK && BN == 32 * 4,
              "__dp4a: a warp's K quads, a lane's four columns");
static_assert(BK == 2 * KHALF && BN == WCOLS * (WARPS / 2),
              "mma: two K halves x the tile's column groups");
static_assert(VEC == 16 && BN == 8 * VEC, "eight 16-byte chunks a row");
constexpr int MAX_DEVICES = 64;

// with mma, a staged K row's 16-byte chunk c sits at c ^ swizzle(row):
// 2 x the row's K quad mod 4, so the four K quads of an mma step read
// distinct banks
template <bool TENSOR>
__device__ __forceinline__ int swizzle(int row) {
  return TENSOR ? 2 * ((row / 4) % 4) : 0;
}

// c += a (16 x 32, row-major) * b (32 x 8, column-major), int8 in,
// int32 sums: lane (g, t) = (lane / 4, lane % 4) holds a = rows g, g + 8
// at K bytes 4t..4t+3 and 4t+16..4t+19, b = column g at the same K
// bytes, and c = rows g, g + 8 at columns 2t, 2t + 1
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;            // 0: fill with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// bytes of one stage: S planes x BK x BN, then MT x BK of x
__host__ __device__ constexpr int stage_bytes(int S, int MT) {
  return S * BK * BN + MT * BK;
}

// the four columns of the words at q of four consecutive staged K rows,
// each as four K-consecutive bytes (the first row's in the low byte)
__device__ __forceinline__ void transpose4(const unsigned char* q,
                                           unsigned (&col)[4]) {
  const unsigned w0 = *reinterpret_cast<const unsigned*>(q);
  const unsigned w1 = *reinterpret_cast<const unsigned*>(q + BN);
  const unsigned w2 = *reinterpret_cast<const unsigned*>(q + 2 * BN);
  const unsigned w3 = *reinterpret_cast<const unsigned*>(q + 3 * BN);
  const unsigned t0 = __byte_perm(w0, w1, 0x5140);
  const unsigned t1 = __byte_perm(w2, w3, 0x5140);
  const unsigned t2 = __byte_perm(w0, w1, 0x7362);
  const unsigned t3 = __byte_perm(w2, w3, 0x7362);
  col[0] = __byte_perm(t0, t1, 0x5410);
  col[1] = __byte_perm(t0, t1, 0x7632);
  col[2] = __byte_perm(t2, t3, 0x5410);
  col[3] = __byte_perm(t2, t3, 0x7632);
}

// one staged K tile at `base` with __dp4a (MT < MMA_MIN_ROWS): acc[m][c]
// is row m at column 4 lane + c
template <int MT>
__device__ __forceinline__ void stage_dp4a(const unsigned char* base, int S,
                                           int bps, int (&acc)[MT][4]) {
  const int lane = threadIdx.x % 32;
  const int kq0 = threadIdx.x / 32 * KQ;   // this warp's first K quad
  const unsigned char* xb = base + S * BK * BN;
  int xw[MT][KQ];
#pragma unroll
  for (int q = 0; q < KQ; ++q)
#pragma unroll
    for (int m = 0; m < MT; ++m)
      xw[m][q] = *reinterpret_cast<const int*>(xb + m * BK + (kq0 + q) * 4);
#pragma unroll
  for (int p = 0; p < MAX_S; ++p) {
    if (p >= S) break;
    unsigned col[KQ][4];
#pragma unroll
    for (int q = 0; q < KQ; ++q)
      transpose4(base + (p * BK + (kq0 + q) * 4) * BN + lane * 4, col[q]);
    const int sh = bps * p;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int part = 0;
#pragma unroll
        for (int q = 0; q < KQ; ++q)
          part = __dp4a(xw[m][q], (int)col[q][c], part);
        acc[m][c] += part << sh;
      }
  }
}

// one staged K tile at `base` on the tensor cores (MT >= MMA_MIN_ROWS):
// acc[j][e] is n-tile j's row g + 8 (e / 2) at column wc + 4 n + j,
// n = 2t + e % 2, for lane (g, t) of a warp with first column wc
template <int MT>
__device__ __forceinline__ void stage_mma(const unsigned char* base, int S,
                                          int bps, int (&acc)[4][4]) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kh = threadIdx.x / 32 % 2;     // this warp's K half
  const int wc = threadIdx.x / 32 / 2 * WCOLS;
  // A: x rows g and g + 8 (zeros past MT) of this warp's K half
  const unsigned char* xk = base + S * BK * BN + kh * KHALF + 4 * t;
  unsigned a[4] = {0u, 0u, 0u, 0u};
  a[0] = *reinterpret_cast<const unsigned*>(xk + g * BK);
  a[2] = *reinterpret_cast<const unsigned*>(xk + g * BK + 16);
  if (g + 8 < MT) {
    a[1] = *reinterpret_cast<const unsigned*>(xk + (g + 8) * BK);
    a[3] = *reinterpret_cast<const unsigned*>(xk + (g + 8) * BK + 16);
  }
#pragma unroll
  for (int p = 0; p < MAX_S; ++p) {
    if (p >= S) break;
    // B: K bytes 4t..4t+3 (h = 0) and 4t+16..4t+19 (h = 1) of the
    // columns wc + 4g + j, one register per n-tile j
    unsigned b[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = p * BK + kh * KHALF + h * 16 + 4 * t;
      transpose4(base + row * BN +
                     ((wc / VEC + g / 4) ^ swizzle<true>(row)) * VEC +
                     (g % 4) * 4,
                 b[h]);
    }
    // the plane's products over the stage, shifted as they are added
    const int sh = bps * p;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int part[4] = {0, 0, 0, 0};
      mma_s8(part, a, b[0][j], b[1][j]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[e] << sh;
    }
  }
}

template <int MT, int STAGES, bool SCALED, bool WALK>
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
bitslice_mvm_kernel(const int8_t* __restrict__ x,
                    const int8_t* __restrict__ planes,
                    const float* __restrict__ row_scale,
                    void* __restrict__ out, int M, int K, int N, int ldx,
                    int S, int bps) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red[MT][BN];

  static_assert(MT <= 16, "the rows of one mma tile");
  constexpr bool TENSOR = MT >= MMA_MIN_ROWS;
  const int tid = threadIdx.x;
  const int split = blockIdx.x;            // rank in the cluster
  const int splits = gridDim.x;
  const int n0 = blockIdx.y * BN;
  const int ktiles = (K + BK - 1) / BK;
  const int kt0 = (int)((long long)split * ktiles / splits);
  const int kt1 = (int)((long long)(split + 1) * ktiles / splits);
  const int sb = stage_bytes(S, MT);
  cg::cluster_group cluster = cg::this_cluster();

  // the row tiles of this CTA, gridDim.z apart (one unless WALK); a
  // cluster's CTAs share blockIdx.z, so they walk the same tiles and
  // meet at every barrier
  for (int m0 = blockIdx.z * MT; m0 < M; m0 += gridDim.z * MT) {
    for (int i = tid; i < MT * BN; i += THREADS) (&red[0][0])[i] = 0;

    // stage a K tile: plane rows (8 chunks of 16 B per 128-byte row, chunk
    // c at c ^ swizzle(row)) and x rows; chunks past K, N, M or the x row
    // are zero-filled
    auto issue = [&](int kt, int slot) {
      unsigned char* base = smem + (size_t)slot * sb;
      const int k0 = kt * BK;
      const int pchunks = S * BK * (BN / VEC);
      for (int c = tid; c < pchunks; c += THREADS) {
        const int part = c % (BN / VEC);
        const int r = c / (BN / VEC);            // s * BK + kk
        const int s = r / BK;
        const int k = k0 + r % BK;
        const int n = n0 + part * VEC;
        const bool ok = k < K && n < N;
        const int8_t* src = ok ? planes + ((size_t)s * K + k) * N + n : planes;
        cp_async16(base + r * BN + (part ^ swizzle<TENSOR>(r)) * VEC, src, ok);
      }
      unsigned char* xb = base + S * BK * BN;
      for (int c = tid; c < MT * (BK / VEC); c += THREADS) {
        const int m = c / (BK / VEC);
        const int k = k0 + (c % (BK / VEC)) * VEC;
        const bool ok = m0 + m < M && k < ldx;
        const int8_t* src = ok ? x + (size_t)(m0 + m) * ldx + k : x;
        cp_async16(xb + m * BK + (c % (BK / VEC)) * VEC, src, ok);
      }
    };

    // the sums of this thread's outputs (stage_dp4a and stage_mma say which)
    int acc[TENSOR ? 4 : MT][4];
#pragma unroll
    for (int i = 0; i < (TENSOR ? 4 : MT); ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0;

    const int nt = kt1 - kt0;
#pragma unroll
    for (int j = 0; j < STAGES - 1; ++j) {
      if (j < nt) issue(kt0 + j, j);
      cp_commit();
    }
    for (int it = 0; it < nt; ++it) {
      cp_wait<STAGES - 2>();
      __syncthreads();
      if (it + STAGES - 1 < nt)
        issue(kt0 + it + STAGES - 1, (it + STAGES - 1) % STAGES);
      cp_commit();
      const unsigned char* base = smem + (size_t)(it % STAGES) * sb;
      if constexpr (TENSOR)
        stage_mma<MT>(base, S, bps, acc);
      else
        stage_dp4a<MT>(base, S, bps, acc);
    }
    cp_wait<0>();

    // the warps that share an output meet in shared memory
    const int lane = tid % 32;
    if constexpr (TENSOR) {
      const int g = lane / 4, t = lane % 4;
      const int wc = tid / 32 / 2 * WCOLS;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = g + 8 * (e / 2);
          if (m < MT)
            atomicAdd(&red[m][wc + 4 * (2 * t + e % 2) + j], acc[j][e]);
        }
    } else {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) atomicAdd(&red[m][lane * 4 + c], acc[m][c]);
    }

    // the cluster's K parts meet: CTA `split` finishes every splits-th
    // block of THREADS outputs of the tile, summing the parts in rank order
    if (splits > 1)
      cluster.sync();
    else
      __syncthreads();
    for (int i = split * THREADS + tid; i < MT * BN; i += splits * THREADS) {
      const int m = i / BN, c = i % BN;
      if (m0 + m >= M || n0 + c >= N) continue;
      int sum = 0;
      if (splits == 1)
        sum = (&red[0][0])[i];
      else
        for (int r = 0; r < splits; ++r)
          sum += cluster.map_shared_rank(&red[0][0], r)[i];
      const size_t o = (size_t)(m0 + m) * N + n0 + c;
      if (SCALED)
        static_cast<float*>(out)[o] = __int2float_rn(sum) * row_scale[m0 + m];
      else
        static_cast<int*>(out)[o] = sum;
    }
    // no CTA leaves, or clears `red` for its next tile, while its part
    // is read
    if (splits > 1)
      cluster.sync();
    else if (WALK)
      __syncthreads();
    if constexpr (!WALK) break;
  }
}

template <int MT, int STAGES, bool SCALED, bool WALK>
int launch(const int8_t* x, const int8_t* planes, const float* scale,
           void* out, int M, int K, int N, int ldx, int S, int bps,
           int splits, int grid_rows, int smem, cudaStream_t st) {
  if (smem < STAGES * stage_bytes(S, MT)) return (int)cudaErrorInvalidValue;
  auto kern = bitslice_mvm_kernel<MT, STAGES, SCALED, WALK>;
  // the shared-memory attribute, set once per device and size
  static int attr_set[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (smem > attr_set[dev]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = smem;
  }
  // one tile a CTA, or (WALK) fewer CTAs than tiles
  if (WALK != (grid_rows < (M + MT - 1) / MT) ||
      grid_rows > (M + MT - 1) / MT)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(splits, (N + BN - 1) / BN, grid_rows);
  if (splits == 1) {
    kern<<<grid, THREADS, smem, st>>>(x, planes, scale, out, M, K, N, ldx,
                                      S, bps);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, x, planes, scale, out, M, K, N, ldx,
                           S, bps);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the instantiation of row tile mt (one of MTS), or an error
template <int STAGES, bool SCALED, int... MTS>
int launch_rows(int mt, const int8_t* x, const int8_t* planes,
                const float* scale, void* out, int M, int K, int N, int ldx,
                int S, int bps, int splits, int grid_rows, int smem,
                cudaStream_t st) {
  constexpr int WALK_MT = ROW_TILE3;        // past 65535 tiles M > 16
  if (mt == WALK_MT && grid_rows < (M + mt - 1) / mt)
    return launch<WALK_MT, STAGES, SCALED, true>(x, planes, scale, out, M, K,
                                                 N, ldx, S, bps, splits,
                                                 grid_rows, smem, st);
  int r = (int)cudaErrorInvalidValue;
  ((mt == MTS && (r = launch<MTS, STAGES, SCALED, false>(
                      x, planes, scale, out, M, K, N, ldx, S, bps, splits,
                      grid_rows, smem, st), true)) ||
   ...);
  return r;
}

// the instantiation of ring depth stages (one of DEPTHS), or an error
template <bool SCALED, int... DEPTHS>
int launch_stages(int stages, int mt, const int8_t* x, const int8_t* planes,
                  const float* scale, void* out, int M, int K, int N,
                  int ldx, int S, int bps, int splits, int grid_rows,
                  int smem, cudaStream_t st) {
  int r = (int)cudaErrorInvalidValue;
  ((stages == DEPTHS && (r = launch_rows<DEPTHS, SCALED, ROW_TILES>(
                             mt, x, planes, scale, out, M, K, N, ldx, S,
                             bps, splits, grid_rows, smem, st), true)) ||
   ...);
  return r;
}

}  // namespace

// The plan, from ops.mvm_plan: mt rows of x per CTA (one of ROW_TILES),
// stages the ring's depth (SHALLOW or DEEP), splits the K parts =
// the cluster's size, grid_rows the CTAs on grid z (each walking row
// tiles grid_rows apart), smem the dynamic shared bytes of the ring.
extern "C" int bitslice_mvm_launch(const void* x, const void* planes,
                                   const void* row_scale, void* out, int M,
                                   int K, int N, int ldx, int S, int bps,
                                   int mt, int stages, int splits,
                                   int grid_rows, int smem, int scaled,
                                   void* stream) {
  const int ktiles = (K + BK - 1) / BK;
  if (M <= 0 || K <= 0 || N <= 0 || S < 1 ||
      S > MAX_S || N % VEC != 0 || ldx < K || ldx % VEC != 0 || splits < 1 ||
      splits > ktiles || grid_rows < 1 || grid_rows > MAX_GRID_Z ||
      (scaled && row_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* pp = static_cast<const int8_t*>(planes);
  const float* sp = static_cast<const float*>(row_scale);
  if (scaled)
    return launch_stages<true, STAGE_DEPTHS>(stages, mt, xp, pp, sp, out, M,
                                             K, N, ldx, S, bps, splits,
                                             grid_rows, smem, st);
  return launch_stages<false, STAGE_DEPTHS>(stages, mt, xp, pp, sp, out, M, K,
                                            N, ldx, S, bps, splits, grid_rows,
                                            smem, st);
}
