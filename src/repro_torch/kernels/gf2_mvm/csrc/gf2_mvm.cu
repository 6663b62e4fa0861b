// GF(2) matrix products (the parity MVM of the AES linear layer) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel gf2_mvm_pallas (body _gf2_mvm_kernel) of
// src/repro/kernels/gf2_mvm/kernel.py:
//   out[M,N] int8 {0,1} = (x[M,K] @ a[K,N]) & 1,  x and a int8.
// The TPU kernel runs the product on the matrix unit in int32 and keeps
// only bit 0 in its epilogue.  So does this file's int8 entry, on the
// tensor cores; its state-byte entry is the same product composed with
// the AES app's bit unpack and pack.
//
// 1. gf2_mma_kernel, K <= MAX_MMA_K.  What bounds it: at the AES shape
//    (M = blocks, K = N = 128) every x byte is read once and every output
//    byte written once, 256 bytes a row against 2 x 128 x 128 int8
//    operations, so the memory rate bounds it (2^24 rows: 4.3 GB, 1.28 ms
//    at 3.35 TB/s; the products take ~0.3 ms at the int8 tensor rate).
//    The design: int8 mma.sync m16n8k32 with s32 sums.  Bit 0 of the
//    int32 sum is the parity for any int8 inputs (a product's low bit is
//    the AND of its operands' low bits; no sum of K <= 512 products
//    overflows, and a wrapped one would keep bit 0 all the same).
//    - A persistent grid of one wave (the SM count from the caller, the
//      CTAs an SM holds from the occupancy API) walks tiles of TILE_M
//      rows; a's TILE_N-column tile is staged once per CTA, transposed so
//      that each column's K bytes are contiguous (the mma's B operand),
//      read from a with coalesced row loads.
//    - x tiles arrive with 16-byte cp.async copies in a ring of 2 to
//      MAX_STAGES tiles, so the next tiles load during this one's work.
//    - Staged rows are padded by ROW_PAD bytes: the 8 rows one fragment
//      load touches fall in 8 distinct groups of 4 banks.
//    - Each warp takes 64 rows x 32 columns (4 x 4 mma tiles); the low
//      bits go to a staged output tile, which the CTA writes with 16-byte
//      stores: whole 128-byte lines per 8 lanes.
//    Shapes whose rows are not 16-byte vectors (K or N not a multiple of
//    16, or an unaligned pointer) take byte copies through the same ring.
//
// 2. gf2_long_k_kernel, K > MAX_MMA_K: walks K in chunks of 512 rows of
//    a, packed as 128 column bits; each thread XORs the rows of a whose x
//    byte is odd into its row's 128 parity bits.  Correct for any K, not
//    tuned.  Neither kernel pads anything in device memory.
//
// 3. gf2_packed_kernel, the state-byte entry of the AES rounds:
//    out[R,16] uint8 = pack(unpack(s[R,16]) @ a[128,128] & 1), bits
//    byte-major and LSB-first.  What bounds it: 32 bytes a row (2^24 rows:
//    0.54 GB, 0.160 ms at 3.35 TB/s).  The design ("Method of Four
//    Russians"): each CTA builds in shared memory T[j][v], the 16-byte
//    XOR of the rows 8j + i of a (packed as 128 column bits) for the set
//    bits i of v, 16 x 256 x 16 B = 64 KiB; a row's output is then the
//    XOR of T[j][s_j] over its 16 bytes j.  Rows are read and written as
//    16-byte vectors, PACKED_UNROLL a thread per pass (loads first, so
//    that several are in flight).  The lookups land on random entries v,
//    which would make the 8 lanes of a quarter warp meet in groups of 4
//    banks; instead the tables are interleaved so that table j lies in
//    bank group j % 8, and the 8 lanes take the bytes j in 8 different
//    orders (table_slot, below): each 16-byte lookup is conflict-free.

#include <cuda_runtime.h>
#include <stdint.h>

// the constants the launch plan in ops.py shares with this file are
// ops.NVCC_DEFINES, given to nvcc as -D macros by kernels/_build.py
#if !defined(TILE_M) || !defined(TILE_N) || !defined(MAX_STAGES) || \
    !defined(ROW_PAD) || !defined(MAX_MMA_K)
#error "build with the -D macros of gf2_mvm/ops.py (kernels/_build.py)"
#endif

namespace {

constexpr int MAX_DEVICES = 64;
constexpr int THREADS = 256;               // int8 entry: threads a CTA
constexpr int MMA_MIN_CTAS = 2;            // registers: two CTAs an SM
constexpr int PACKED_THREADS = 512;        // state-byte entry
constexpr int PACKED_UNROLL = 2;           // its rows a thread per pass
constexpr int WARPS = THREADS / 32;
constexpr int WARPS_N = 4;                 // warps across the column tile
constexpr int WARPS_M = WARPS / WARPS_N;
constexpr int WM = TILE_M / WARPS_M;       // rows per warp
constexpr int WN = TILE_N / WARPS_N;       // columns per warp
constexpr int MT = WM / 16;                // mma tiles of 16 rows
constexpr int NT = WN / 8;                 // mma tiles of 8 columns
constexpr int OUT_ROW = TILE_N + ROW_PAD;  // bytes per staged output row
static_assert(WARPS % WARPS_N == 0 && WM % 16 == 0 && WN % 8 == 0,
              "warp tiles must be whole mma tiles");
static_assert(ROW_PAD % 16 == 0 && (ROW_PAD / 4) % 8 == 4,
              "a padded row must keep 16-byte alignment and shift banks");
constexpr int KC = 512;                    // rows of a per chunk, long K
constexpr int SBYTES = 16;                 // state bytes a row (AES)
constexpr int TABLE = SBYTES * 256;        // 16-byte table entries

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Dynamic shared memory, laid out by ops.gf2_plan: STAGES x tiles of
// TILE_M rows of `row` bytes at 0, a's transposed tile (TILE_N rows of
// `row` bytes) at a_off, the output tile (TILE_M rows of OUT_ROW bytes)
// at out_off.
template <int STAGES>
__global__ void __launch_bounds__(THREADS, MMA_MIN_CTAS)
gf2_mma_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ a,
               int8_t* __restrict__ out, int M, int K, int N, int row,
               int a_off, int out_off, bool vec_in, bool vec_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* xs = smem;
  unsigned char* as = smem + a_off;
  unsigned char* os = smem + out_off;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;                 // the mma's row / column group
  const int t4 = lane & 3;                 // its 4-byte K slot
  const int n0 = blockIdx.y * TILE_N;
  const int ncols = min(TILE_N, N - n0);
  const int ksteps = (K + 31) / 32;

  // zeros past K (both operands) and past N (a's tile) add nothing; the
  // copies below write only real K positions and columns
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = tid * 16; i < a_off + TILE_N * row; i += THREADS * 16)
    *reinterpret_cast<uint4*>(smem + i) = zero;
  __syncthreads();
  for (int i = tid; i < K * ncols; i += THREADS) {
    const int k = i / ncols;
    const int c = i - k * ncols;
    as[c * row + k] = static_cast<unsigned char>(a[(size_t)k * N + n0 + c]);
  }

  const long long tiles = ((long long)M + TILE_M - 1) / TILE_M;
  const long long step = gridDim.x;
  // one commit group per tile (empty past the last): once no more than
  // STAGES - 1 groups are pending, this pass's tile has landed
  auto load = [&](long long t, int stage) {
    if (t < tiles) {
      const long long m0 = t * TILE_M;
      const int rows = (int)min((long long)TILE_M, (long long)M - m0);
      unsigned char* dst = xs + stage * TILE_M * row;
      const int8_t* src = x + m0 * K;
      if (vec_in) {
        const int per_row = K / 16;
        for (int i = tid; i < rows * per_row; i += THREADS) {
          const int r = i / per_row;
          cp_async16(dst + r * row + (i - r * per_row) * 16,
                     src + (size_t)i * 16);
        }
      } else {
        for (int i = tid; i < rows * K; i += THREADS) {
          const int r = i / K;
          dst[r * row + (i - r * K)] = static_cast<unsigned char>(src[i]);
        }
      }
    }
    cp_async_commit();
  };

  const int wm0 = (warp / WARPS_N) * WM;
  const int wn0 = (warp % WARPS_N) * WN;
  long long t = blockIdx.x;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(t + s * step, s);
  for (int stage = 0; t < tiles; t += step, stage = (stage + 1) % STAGES) {
    // the slot computed in the last pass, which every thread has left
    load(t + (STAGES - 1) * step, (stage + STAGES - 1) % STAGES);
    cp_async_wait<STAGES - 1>();
    __syncthreads();

    const unsigned char* xt = xs + stage * TILE_M * row;
    int acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;
    for (int ks = 0; ks < ksteps; ++ks) {
      const int k0 = ks * 32 + t4 * 4;
      uint32_t af[MT][4];
      uint32_t bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const unsigned char* p = xt + (wm0 + i * 16 + g) * row + k0;
        af[i][0] = lds32(p);
        af[i][1] = lds32(p + 8 * row);
        af[i][2] = lds32(p + 16);
        af[i][3] = lds32(p + 8 * row + 16);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const unsigned char* p = as + (wn0 + j * 8 + g) * row + k0;
        bf[j][0] = lds32(p);
        bf[j][1] = lds32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
    }
    // the low bits: rows g and g + 8, columns 2 t4 and 2 t4 + 1 of each
    // mma tile, two bytes a store
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int r = wm0 + i * 16 + g;
        const int c = wn0 + j * 8 + t4 * 2;
        *reinterpret_cast<uint16_t*>(os + r * OUT_ROW + c) =
            (uint16_t)((acc[i][j][0] & 1) | ((acc[i][j][1] & 1) << 8));
        *reinterpret_cast<uint16_t*>(os + (r + 8) * OUT_ROW + c) =
            (uint16_t)((acc[i][j][2] & 1) | ((acc[i][j][3] & 1) << 8));
      }
    __syncthreads();

    const long long m0 = t * TILE_M;
    const int rows = (int)min((long long)TILE_M, (long long)M - m0);
    int8_t* ot = out + m0 * N + n0;
    if (vec_out) {
      const int per_row = ncols / 16;
      for (int i = tid; i < rows * per_row; i += THREADS) {
        const int r = i / per_row;
        const int h = i - r * per_row;
        *reinterpret_cast<uint4*>(ot + (size_t)r * N + h * 16) =
            *reinterpret_cast<const uint4*>(os + r * OUT_ROW + h * 16);
      }
    } else {
      for (int i = tid; i < rows * ncols; i += THREADS) {
        const int r = i / ncols;
        const int c = i - r * ncols;
        ot[(size_t)r * N + c] = static_cast<int8_t>(os[r * OUT_ROW + c]);
      }
    }
  }
  cp_async_wait<0>();                      // nothing in flight at exit
}

// K > MAX_MMA_K: y_m = XOR over k of (x[m][k] & 1) * a[k][n0 .. n0 + 127],
// with a's rows packed as 128 column bits, one chunk of KC rows at a time.
__global__ void __launch_bounds__(THREADS)
gf2_long_k_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ a,
                  int8_t* __restrict__ out, int M, int K, int N) {
  // a_sh[k][q] bit j = a[k0 + k][n0 + 32q + j] & 1
  __shared__ uint4 a_sh[KC];
  uint32_t* a_w = reinterpret_cast<uint32_t*>(a_sh);
  static_assert(TILE_N == 128, "a row of a_sh holds 128 column bits");

  const int tid = threadIdx.x;
  const int n0 = blockIdx.y * TILE_N;
  const int ncols = min(TILE_N, N - n0);
  const long long row_tiles = ((long long)M + THREADS - 1) / THREADS;
  for (long long t = blockIdx.x; t < row_tiles; t += gridDim.x) {
    const long long m = t * THREADS + tid;
    uint32_t acc[4] = {0u, 0u, 0u, 0u};
    for (int k0 = 0; k0 < K; k0 += KC) {
      const int kc = min(KC, K - k0);
      __syncthreads();                     // the last chunk's readers are done
      for (int i = tid; i < kc * 4; i += THREADS) {
        const int k = i / 4;
        const int q = i % 4;
        const int cend = min(32, ncols - 32 * q);
        const int8_t* p = a + (size_t)(k0 + k) * N + n0 + 32 * q;
        uint32_t word = 0;
        for (int j = 0; j < cend; ++j) word |= (uint32_t)(p[j] & 1) << j;
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

__device__ __forceinline__ void xor_into(uint4& acc, const uint4& v) {
  acc.x ^= v.x;
  acc.y ^= v.y;
  acc.z ^= v.z;
  acc.w ^= v.w;
}

// Where T[j][v] sits, in 16-byte entries: the 8 tables j of one half of
// the state interleaved, so that entry (j, v) falls in the group of 4
// banks j % 8 whatever v is.
__device__ __forceinline__ int table_slot(int j, int v) {
  return (j >> 3) * (256 * 8) + v * 8 + (j & 7);
}

// out[m] = XOR over j of T[j][byte j of s[m]]; T in 64 KiB of dynamic
// shared memory, built from a's rows as 128 column bits each.  Lane
// c = lane % 8 of each quarter warp takes the bytes in the order t ^ c
// (t = 0..15), so the 8 lanes a 16-byte load serves at once read 8
// different tables mod 8, that is 8 different bank groups: no conflict.
__global__ void __launch_bounds__(PACKED_THREADS)
gf2_packed_kernel(const uint4* __restrict__ s, const int8_t* __restrict__ a,
                  uint4* __restrict__ out, long long R) {
  extern __shared__ uint4 table[];
  // a's row 8j + b, byte q bit i = a[8j + b][8q + i] & 1 (LSB-first, as
  // unpacked), at arow[9j + b]: the 8 tables j that neighbouring threads
  // build read 8 different bank groups
  __shared__ uint4 arow[9 * SBYTES];
  const int tid = threadIdx.x;
  unsigned char* ab = reinterpret_cast<unsigned char*>(arow);
  for (int i = tid; i < 8 * SBYTES * SBYTES; i += PACKED_THREADS) {
    const int8_t* p = a + 8 * i;           // row k = i / 16, bytes 8 (i % 16)..
    const int k = i / SBYTES;
    unsigned v = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) v |= (unsigned)(p[b] & 1) << b;
    ab[(9 * (k >> 3) + (k & 7)) * SBYTES + i % SBYTES] = (unsigned char)v;
  }
  __syncthreads();
  for (int i = tid; i < TABLE; i += PACKED_THREADS) {   // i = table_slot
    const int j = ((i >> 11) << 3) | (i & 7);
    const int v = (i >> 3) & 255;
    uint4 acc = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int b = 0; b < 8; ++b)
      if ((v >> b) & 1) xor_into(acc, arow[9 * j + b]);
    table[i] = acc;
  }
  __syncthreads();

  // byte t of a row as this lane reads it is byte t ^ c: swap the word
  // pairs when c & 4, permute each word's bytes by c & 3
  const int c = tid & 7;
  const unsigned c3 = c & 3;
  const unsigned sel = c3 | ((1 ^ c3) << 4) | ((2 ^ c3) << 8) |
                       ((3 ^ c3) << 12);
  const long long stride = (long long)gridDim.x * PACKED_THREADS;
  for (long long m0 = (long long)blockIdx.x * PACKED_THREADS + tid; m0 < R;
       m0 += stride * PACKED_UNROLL) {
    uint4 in[PACKED_UNROLL];
#pragma unroll
    for (int u = 0; u < PACKED_UNROLL; ++u) {
      const long long m = m0 + u * stride;
      in[u] = m < R ? s[m] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < PACKED_UNROLL; ++u) {
      const bool swap = c & 4;
      uint32_t w[4] = {swap ? in[u].y : in[u].x, swap ? in[u].x : in[u].y,
                       swap ? in[u].w : in[u].z, swap ? in[u].z : in[u].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) w[q] = __byte_perm(w[q], 0u, sel);
      uint4 acc = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int t = 0; t < SBYTES; ++t) {
        const int v = (w[t / 4] >> (8 * (t % 4))) & 255;
        xor_into(acc, table[table_slot(t ^ c, v)]);
      }
      const long long m = m0 + u * stride;
      if (m < R) out[m] = acc;
    }
  }
}

// Sets a kernel's dynamic shared-memory limit once per device and size
// (the attribute is the function's, not a launch's) and returns how many
// of its CTAs an SM holds with `smem` bytes.
template <typename Kern>
int prepare(Kern kern, int threads, int smem, int* attr_set, int* per_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (smem > attr_set[dev]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr_set[dev] = smem;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, threads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  return *per_sm < 1 ? (int)cudaErrorInvalidConfiguration : 0;
}

// One wave: at most the CTAs the card holds at once, shared out over the
// column tiles, and no more row CTAs than row tiles.
dim3 wave_grid(long long row_tiles, int col_tiles, int sms, int per_sm) {
  const long long cap = (long long)sms * per_sm / col_tiles;
  const long long ctas = row_tiles < cap ? row_tiles : cap;
  return dim3((unsigned)(ctas < 1 ? 1 : ctas), (unsigned)col_tiles);
}

template <int STAGES>
int launch_mma(const int8_t* x, const int8_t* a, int8_t* out, int M, int K,
               int N, int sms, int row, int a_off, int out_off, int smem,
               cudaStream_t st) {
  static int attr_set[MAX_DEVICES] = {};
  auto kern = gf2_mma_kernel<STAGES>;
  int per_sm = 0;
  const int err = prepare(kern, THREADS, smem, attr_set, &per_sm);
  if (err) return err;
  const bool vec_in = K % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_out =
      N % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const dim3 grid = wave_grid(((long long)M + TILE_M - 1) / TILE_M,
                              (N + TILE_N - 1) / TILE_N, sms, per_sm);
  kern<<<grid, THREADS, smem, st>>>(x, a, out, M, K, N, row, a_off, out_off,
                                    vec_in, vec_out);
  return (int)cudaGetLastError();
}

}  // namespace

// The int8 entry.  sms: the card's SM count; stages, row, a_off, out_off
// and smem: ops.gf2_plan's launch plan (stages 2 or MAX_STAGES; 0 for
// K > MAX_MMA_K),
// which this only range-checks.
extern "C" int gf2_mvm_launch(const void* x, const void* a, void* out, int M,
                              int K, int N, int sms, int stages, int row,
                              int a_off, int out_off, int smem,
                              void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || sms < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* ap = static_cast<const int8_t*>(a);
  int8_t* op = static_cast<int8_t*>(out);
  if (K > MAX_MMA_K) {
    if (stages != 0) return (int)cudaErrorInvalidValue;
    static int attr_set[MAX_DEVICES] = {};
    int per_sm = 0;
    const int err = prepare(gf2_long_k_kernel, THREADS, 0, attr_set, &per_sm);
    if (err) return err;
    const dim3 grid = wave_grid(((long long)M + THREADS - 1) / THREADS,
                                (N + TILE_N - 1) / TILE_N, sms, per_sm);
    gf2_long_k_kernel<<<grid, THREADS, 0, st>>>(xp, ap, op, M, K, N);
    return (int)cudaGetLastError();
  }
  const int kp = (K + 31) / 32 * 32;
  if ((stages != 2 && stages != MAX_STAGES) || row < kp + ROW_PAD ||
      row % 16 != 0 || (row / 4) % 8 != 4 || a_off % 16 != 0 ||
      out_off % 16 != 0 || a_off < stages * TILE_M * row ||
      out_off < a_off + TILE_N * row || smem < out_off + TILE_M * OUT_ROW)
    return (int)cudaErrorInvalidValue;
  if (stages == 2)
    return launch_mma<2>(xp, ap, op, M, K, N, sms, row, a_off, out_off, smem,
                         st);
  return launch_mma<MAX_STAGES>(xp, ap, op, M, K, N, sms, row, a_off,
                                out_off, smem, st);
}

// The state-byte entry: s and out [R, 16] uint8, 16-byte aligned; a
// [128, 128] int8.  sms: the card's SM count.
extern "C" int gf2_mvm_packed_launch(const void* s, const void* a, void* out,
                                     long long R, int sms, void* stream) {
  if (R <= 0 || sms < 1 || reinterpret_cast<uintptr_t>(s) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  static int attr_set[MAX_DEVICES] = {};
  const int smem = TABLE * (int)sizeof(uint4);
  int per_sm = 0;
  const int err =
      prepare(gf2_packed_kernel, PACKED_THREADS, smem, attr_set, &per_sm);
  if (err) return err;
  const long long per_pass = (long long)PACKED_THREADS * PACKED_UNROLL;
  const dim3 grid = wave_grid((R + per_pass - 1) / per_pass, 1, sms, per_sm);
  gf2_packed_kernel<<<grid, PACKED_THREADS, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(s), static_cast<const int8_t*>(a),
      static_cast<uint4*>(out), R);
  return (int)cudaGetLastError();
}
