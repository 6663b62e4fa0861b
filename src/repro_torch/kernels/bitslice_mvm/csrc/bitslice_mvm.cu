// Bit-sliced integer MVM with the shift-and-add fused into the
// accumulation, for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/bitslice_mvm/kernel.py:
//   SCALED=true  -> bitslice_mvm_scaled_pallas (_bitslice_mvm_scaled_kernel):
//                   out[M,N] f32 = (sum_s (x @ P_s) << (bps*s)).to(f32) * row_scale
//   SCALED=false -> bitslice_mvm_pallas (_bitslice_mvm_kernel):
//                   out[M,N] i32 =  sum_s (x @ P_s) << (bps*s)
// with x [M,K] int8, P [S,K,N] int8 (S <= 4), row_scale [M] f32.
//
// What bounds it: at decode M is 1..32, so each plane byte is used by at
// most M multiply-adds; the kernel reads S*K*N plane bytes and is bound
// by device-memory bytes (Qwen2.5-3B: 4 planes x 2048 x 11008 = 90 MB
// per up-projection, 27 us at 3.35 TB/s), not by integer operations.
//
// What the design does about it: one CTA per 32 output columns and per
// 16 rows of x, so every plane byte is read from device memory once for
// up to 16 rows.  Each K step stages a [S, 256, 32] plane tile (32 KB)
// and the [16, 256] x tile in shared memory with 16-byte vector loads;
// the 8 warps split the tile's K range, each lane owns one column and
// packs four K-consecutive plane bytes into one word for __dp4a (the
// [S,K,N] layout keeps N contiguous, so the transpose to K-major happens
// in shared memory).  Each plane's partial product over the tile is
// shifted by its bit position and added to the int32 accumulator as it
// is formed -- the shift-during-transfer step of the paper -- and the
// accumulator never leaves the chip: the 8 warps' sums meet in shared
// memory and the epilogue writes int32, or int32 -> f32 times the row's
// scale.  Integer sums are exact in any order, so the result equals the
// plain version bit for bit.  Bounds: per plane |partial| <=
// 127*3*11008 < 2^23 and shifted by at most 6 bits it stays < 2^31.
//
// Not yet done (later work): tensor-core mma for the prefill shapes, a
// split over K for the narrow projections (N=256 gives only 8 CTAs), and
// asynchronous copies that overlap the next tile's loads with this one's
// dot products.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 16;           // rows of x per CTA
constexpr int BN = 32;           // output columns per CTA (one per lane)
constexpr int BK = 256;          // K depth staged per step
constexpr int MAX_S = 4;         // planes
constexpr int THREADS = 256;
constexpr int KGROUPS = THREADS / BN;     // 8 warps split K
constexpr int KPER = BK / KGROUPS;        // 32 K values per lane per step
constexpr int WORDS = KPER / 4;           // 8 dp4a words
constexpr int VEC = 16;                   // bytes per vector load
constexpr int VEC_PER_ROW = BN / VEC;     // 2

__device__ __forceinline__ int pack4(int8_t a, int8_t b, int8_t c, int8_t d) {
  return (int)(uint8_t)a | ((int)(uint8_t)b << 8) | ((int)(uint8_t)c << 16) |
         ((int)(uint8_t)d << 24);
}

template <bool SCALED>
__global__ void __launch_bounds__(THREADS)
bitslice_mvm_kernel(const int8_t* __restrict__ x,
                    const int8_t* __restrict__ planes,
                    const float* __restrict__ row_scale,
                    void* __restrict__ out, int M, int K, int N, int S,
                    int bps) {
  __shared__ __align__(16) int8_t w_sh[MAX_S][BK][BN];
  __shared__ __align__(16) int8_t x_sh[BM][BK];

  const int tid = threadIdx.x;
  const int col = tid % BN;
  const int kg = tid / BN;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int mrows = min(BM, M - m0);

  int acc[BM];
#pragma unroll
  for (int m = 0; m < BM; ++m) acc[m] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // stage the plane tile [S, BK, BN]; rows past K and columns past N
    // are zero (N is a multiple of VEC, so a vector is all in or all out)
    const int total = S * BK * VEC_PER_ROW;
    for (int i = tid; i < total; i += THREADS) {
      const int v = i % VEC_PER_ROW;
      const int r = i / VEC_PER_ROW;
      const int s = r / BK;
      const int kk = r % BK;
      const int k = k0 + kk;
      const int n = n0 + v * VEC;
      int4 val = make_int4(0, 0, 0, 0);
      if (k < K && n < N)
        val = *reinterpret_cast<const int4*>(
            planes + ((size_t)s * K + k) * N + n);
      *reinterpret_cast<int4*>(&w_sh[s][kk][v * VEC]) = val;
    }
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int m = i / BK;
      const int kk = i % BK;
      int8_t v = 0;
      if (m < mrows && k0 + kk < K) v = x[(size_t)(m0 + m) * K + k0 + kk];
      x_sh[m][kk] = v;
    }
    __syncthreads();

    const int kb = kg * KPER;
    int w[MAX_S][WORDS];
#pragma unroll
    for (int s = 0; s < MAX_S; ++s) {
      if (s < S) {
#pragma unroll
        for (int j = 0; j < WORDS; ++j) {
          const int kk = kb + 4 * j;
          w[s][j] = pack4(w_sh[s][kk][col], w_sh[s][kk + 1][col],
                          w_sh[s][kk + 2][col], w_sh[s][kk + 3][col]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      if (m < mrows) {
        const int* xw = reinterpret_cast<const int*>(&x_sh[m][kb]);
        int xv[WORDS];
#pragma unroll
        for (int j = 0; j < WORDS; ++j) xv[j] = xw[j];
#pragma unroll
        for (int s = 0; s < MAX_S; ++s) {
          if (s < S) {
            int part = 0;
#pragma unroll
            for (int j = 0; j < WORDS; ++j) part = __dp4a(xv[j], w[s][j], part);
            // shift-and-add as the plane's partial product is formed
            acc[m] += part << (bps * s);
          }
        }
      }
    }
    __syncthreads();
  }

  // the 8 warps' partial sums meet in shared memory (reusing the plane
  // tile: KGROUPS * BM * BN ints = 16 KB)
  int* red = reinterpret_cast<int*>(&w_sh[0][0][0]);
#pragma unroll
  for (int m = 0; m < BM; ++m) red[(kg * BM + m) * BN + col] = acc[m];
  __syncthreads();
  for (int i = tid; i < BM * BN; i += THREADS) {
    const int m = i / BN;
    const int c = i % BN;
    if (m < mrows && n0 + c < N) {
      int sum = 0;
#pragma unroll
      for (int g = 0; g < KGROUPS; ++g) sum += red[(g * BM + m) * BN + c];
      const size_t o = (size_t)(m0 + m) * N + n0 + c;
      if (SCALED) {
        static_cast<float*>(out)[o] = __int2float_rn(sum) * row_scale[m0 + m];
      } else {
        static_cast<int*>(out)[o] = sum;
      }
    }
  }
}

}  // namespace

extern "C" int bitslice_mvm_launch(const void* x, const void* planes,
                                   const void* row_scale, void* out, int M,
                                   int K, int N, int S, int bps, int scaled,
                                   void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || S < 1 || S > MAX_S || N % VEC != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* pp = static_cast<const int8_t*>(planes);
  const float* sp = static_cast<const float*>(row_scale);
  if (scaled)
    bitslice_mvm_kernel<true><<<grid, THREADS, 0, st>>>(xp, pp, sp, out, M,
                                                        K, N, S, bps);
  else
    bitslice_mvm_kernel<false><<<grid, THREADS, 0, st>>>(xp, pp, sp, out, M,
                                                         K, N, S, bps);
  return (int)cudaGetLastError();
}
