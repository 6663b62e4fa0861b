// GF(2) matrix product (the parity MVM of the AES linear layer) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel gf2_mvm_pallas (body _gf2_mvm_kernel) of
// src/repro/kernels/gf2_mvm/kernel.py:
//   out[M,N] int8 {0,1} = (x[M,K] @ a[K,N]) & 1,  x and a int8.
// The TPU kernel runs the product on the matrix unit in int32 and keeps
// only bit 0 in its epilogue.  Here the low bit of sum_k x_k * a_k is
// the XOR over k of (x_k & 1) & (a_k & 1), so the kernel packs bit 0 of
// 32 consecutive K bytes into one 32-bit word and computes each output
// as popc(XOR_w (x_word & a_word)) & 1.  That is exact for any int8
// input, not only for {0, 1}.
//
// What bounds it: at the AES shape (M = blocks, K = N = 128) every x
// byte is read once and every output byte written once, 256 bytes a
// row against 128 x 128 one-bit operations, so the card's memory rate
// bounds it (2^24 rows: 4.3 GB, 1.28 ms at 3.35 TB/s).
//
// What the design does about it: a CTA packs the low bits of a's
// [K, 128] column tile into shared memory once (2 KiB at K = 128) and
// then walks row tiles of 256 rows in a grid-stride loop.  A row tile of
// x is rows * K contiguous bytes, so it is read with coalesced 16-byte
// loads and packed to 16 bits per load into shared memory; each thread
// then takes one row, holds its packed words in registers, reads each
// column's words as a broadcast (every lane of a warp reads the same
// column), and writes its row's parity bytes 16 at a time.  Per column
// and row that is K/32 AND-XORs and one popc.  Shapes that are not
// multiples of 16 bytes take byte loads and stores instead.
//
// A row held in registers bounds that kernel to K <= 512.  Longer K
// takes a second kernel that walks K in chunks of 512: it packs each
// chunk's rows of a as 128 column bits, and each thread XORs the rows of
// a whose x byte is odd into its row's 128 parity bits.  It re-packs a
// for every row tile and reads x a byte at a time: correct for any K,
// not tuned.  Any M, K and N work without padding.
//
// Not yet done (later work): stores staged through shared memory so that
// a warp writes contiguous lines, and asynchronous copies of the next row
// tile during this one's products.

#include <cuda_runtime.h>
#include <stdint.h>

// THREADS, which the launch plan in ops.py shares with this file, is
// ops.NVCC_DEFINES, given to nvcc as a -D macro by kernels/_build.py
#ifndef THREADS
#error "build with the -D macros of gf2_mvm/ops.py (kernels/_build.py)"
#endif

namespace {

constexpr int ROWS = THREADS;     // rows of x per tile, one per thread
constexpr int COLS = 128;         // output columns per CTA
constexpr int MAX_KW4 = 4;        // K <= 4 * 4 * 32 = 512
constexpr int SHORT_K = 4 * 32 * MAX_KW4;
constexpr int KC = 512;           // rows of a per chunk, long-K kernel

// bit 0 of each of the 4 bytes of v -> bits 0..3 (the multiply moves
// byte i's bit 0 to bit 28 + i; the other partial products land on
// distinct lower bits, so nothing carries into the top nibble)
__device__ __forceinline__ uint32_t low_bits4(uint32_t v) {
  return ((v & 0x01010101u) * 0x10204080u) >> 28;
}

template <int KW4>
__global__ void __launch_bounds__(THREADS)
gf2_mvm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ a,
               int8_t* __restrict__ out, int M, int K, int N, bool vec) {
  constexpr int KWP = 4 * KW4;    // packed words per row, padded to uint4
  __shared__ __align__(16) uint32_t a_sh[COLS * KWP];
  __shared__ __align__(16) uint32_t x_sh[ROWS * KWP];

  const int tid = threadIdx.x;
  const int kw = (K + 31) / 32;
  const int n0 = blockIdx.y * COLS;
  const int ncols = min(COLS, N - n0);

  // a's column tile, packed: a_sh[c][w] bit j = a[32w + j][n0 + c] & 1;
  // consecutive threads read consecutive columns of one row of a
  for (int i = tid; i < COLS * KWP; i += THREADS) {
    const int c = i % COLS;
    const int w = i / COLS;
    uint32_t word = 0;
    if (c < ncols && w < kw) {
      const int kend = min(32, K - 32 * w);
      const int8_t* p = a + (size_t)(32 * w) * N + n0 + c;
      for (int j = 0; j < kend; ++j)
        word |= (uint32_t)(p[(size_t)j * N] & 1) << j;
    }
    a_sh[c * KWP + w] = word;
  }
  // the padding words past K stay zero for every tile (staging below
  // writes only the bits of real K positions)
  for (int i = tid; i < ROWS * KWP; i += THREADS) x_sh[i] = 0;
  __syncthreads();

  const long long row_tiles = ((long long)M + ROWS - 1) / ROWS;
  for (long long t = blockIdx.x; t < row_tiles; t += gridDim.x) {
    const long long m0 = t * ROWS;
    const int rows = (int)min((long long)ROWS, (long long)M - m0);
    const int8_t* xt = x + m0 * K;
    if (vec) {
      // K % 16 == 0: the tile is rows * K contiguous bytes, read as
      // 16-byte vectors; each vector is 16 bits of one packed row
      uint16_t* x16 = reinterpret_cast<uint16_t*>(x_sh);
      const int per_row = K / 16;
      const int chunks = rows * per_row;
      const uint4* src = reinterpret_cast<const uint4*>(xt);
      for (int i = tid; i < chunks; i += THREADS) {
        const uint4 v = src[i];
        const int r = i / per_row;
        const int h = i % per_row;
        x16[r * 2 * KWP + h] =
            (uint16_t)(low_bits4(v.x) | (low_bits4(v.y) << 4) |
                       (low_bits4(v.z) << 8) | (low_bits4(v.w) << 12));
      }
    } else {
      for (int i = tid; i < rows * kw; i += THREADS) {
        const int r = i / kw;
        const int w = i % kw;
        const int kend = min(32, K - 32 * w);
        const int8_t* p = xt + (size_t)r * K + 32 * w;
        uint32_t word = 0;
        for (int j = 0; j < kend; ++j) word |= (uint32_t)(p[j] & 1) << j;
        x_sh[r * KWP + w] = word;
      }
    }
    __syncthreads();

    if (tid < rows) {
      uint4 xr[KW4];
      const uint4* xrow = reinterpret_cast<const uint4*>(x_sh + tid * KWP);
#pragma unroll
      for (int q = 0; q < KW4; ++q) xr[q] = xrow[q];
      int8_t* orow = out + (m0 + tid) * N + n0;
      for (int c0 = 0; c0 < ncols; c0 += 16) {
        uint32_t packed[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          // columns past ncols read the tile's zero words
          const uint4* ac =
              reinterpret_cast<const uint4*>(a_sh + (c0 + j) * KWP);
          uint32_t v = 0;
#pragma unroll
          for (int q = 0; q < KW4; ++q) {
            const uint4 av = ac[q];
            v ^= (xr[q].x & av.x) ^ (xr[q].y & av.y) ^ (xr[q].z & av.z) ^
                 (xr[q].w & av.w);
          }
          packed[j / 4] |= (uint32_t)(__popc(v) & 1) << (8 * (j % 4));
        }
        if (vec && c0 + 16 <= ncols) {
          *reinterpret_cast<uint4*>(orow + c0) =
              make_uint4(packed[0], packed[1], packed[2], packed[3]);
        } else {
          const int nj = min(16, ncols - c0);
          for (int j = 0; j < nj; ++j)
            orow[c0 + j] = (int8_t)((packed[j / 4] >> (8 * (j % 4))) & 1u);
        }
      }
    }
    __syncthreads();
  }
}

// K > SHORT_K: y_m = XOR over k of (x[m][k] & 1) * a[k][n0 .. n0 + 127],
// with a's rows packed as 128 column bits, one chunk of KC rows at a time.
__global__ void __launch_bounds__(THREADS)
gf2_mvm_long_k_kernel(const int8_t* __restrict__ x,
                      const int8_t* __restrict__ a, int8_t* __restrict__ out,
                      int M, int K, int N) {
  // a_sh[k][q] bit j = a[k0 + k][n0 + 32q + j] & 1
  __shared__ uint4 a_sh[KC];
  uint32_t* a_w = reinterpret_cast<uint32_t*>(a_sh);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * COLS;
  const int ncols = min(COLS, N - n0);
  const long long row_tiles = ((long long)M + ROWS - 1) / ROWS;
  for (long long t = blockIdx.x; t < row_tiles; t += gridDim.x) {
    const long long m = t * ROWS + tid;
    uint32_t acc[4] = {0u, 0u, 0u, 0u};
    for (int k0 = 0; k0 < K; k0 += KC) {
      const int kc = min(KC, K - k0);
      __syncthreads();              // the last chunk's readers are done
      for (int i = tid; i < kc * 4; i += THREADS) {
        const int k = i / 4;
        const int q = i % 4;
        const int cend = min(32, ncols - 32 * q);
        const int8_t* p = a + (size_t)(k0 + k) * N + n0 + 32 * q;
        uint32_t word = 0;
        for (int j = 0; j < cend; ++j)
          word |= (uint32_t)(p[j] & 1) << j;
        a_w[i] = word;
      }
      __syncthreads();
      if (m < M) {
        const int8_t* xr = x + m * K + k0;
        for (int k = 0; k < kc; ++k) {
          const uint32_t odd = 0u - (uint32_t)(xr[k] & 1);
          const uint4 av = a_sh[k];
          acc[0] ^= av.x & odd;
          acc[1] ^= av.y & odd;
          acc[2] ^= av.z & odd;
          acc[3] ^= av.w & odd;
        }
      }
    }
    if (m < M) {
      int8_t* orow = out + m * N + n0;
      for (int c = 0; c < ncols; ++c)
        orow[c] = (int8_t)((acc[c / 32] >> (c % 32)) & 1u);
    }
  }
}

}  // namespace

// max_ctas, from ops.py: the CTAs the card holds at once (its SMs times
// the CTAs of THREADS threads an SM holds), the grid's most
extern "C" int gf2_mvm_launch(const void* x, const void* a, void* out, int M,
                              int K, int N, int max_ctas, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || max_ctas < 1)
    return (int)cudaErrorInvalidValue;
  const int kw4 = ((K + 31) / 32 + 3) / 4;
  const bool vec = K % 16 == 0 && N % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long row_tiles = ((long long)M + ROWS - 1) / ROWS;
  const int col_tiles = (N + COLS - 1) / COLS;
  const long long cap = col_tiles >= max_ctas ? 1 : max_ctas / col_tiles;
  const dim3 grid((unsigned)(row_tiles < cap ? row_tiles : cap),
                  (unsigned)col_tiles);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* ap = static_cast<const int8_t*>(a);
  int8_t* op = static_cast<int8_t*>(out);
  if (K > SHORT_K) {
    gf2_mvm_long_k_kernel<<<grid, THREADS, 0, st>>>(xp, ap, op, M, K, N);
    return (int)cudaGetLastError();
  }
  switch (kw4) {
    case 1:
      gf2_mvm_kernel<1><<<grid, THREADS, 0, st>>>(xp, ap, op, M, K, N, vec);
      break;
    case 2:
      gf2_mvm_kernel<2><<<grid, THREADS, 0, st>>>(xp, ap, op, M, K, N, vec);
      break;
    case 3:
      gf2_mvm_kernel<3><<<grid, THREADS, 0, st>>>(xp, ap, op, M, K, N, vec);
      break;
    default:
      gf2_mvm_kernel<4><<<grid, THREADS, 0, st>>>(xp, ap, op, M, K, N, vec);
      break;
  }
  return (int)cudaGetLastError();
}
