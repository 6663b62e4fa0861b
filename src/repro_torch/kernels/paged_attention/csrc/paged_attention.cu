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
//     reaches);
//   * reads the row's keys through the *read* table, cropped to T;
//   * scores in f32 times 1/sqrt(hd), masks kpos <= qpos with -1e30,
//     applies the optional tanh softcap, takes a plain softmax (max, exp,
//     sum, divide), casts the probabilities to bf16 and sums p * V in
//     f32, written in bf16.
// q, k_new, v_new: [B,S,KV,G,hd] / [B,S,KV,hd] of type QT (bf16 or f32);
// pools [NB,bs,KV,hd] bf16; out [B,S,KV,G,hd] bf16.
//
// What bounds it: at decode each row reads ~2 * qpos * hd pool elements
// per KV head and does ~4 * qpos * hd flops per query, about 4 flops per
// byte for G = 8: device-memory bytes bound it, and at the serving
// depths here (a few hundred cached tokens) launch latency dominates.
//
// What the design does about it: two launches from one entry point, in
// one stream.  The first stores every row's new cells (the pools are
// updated in place: the TPU kernel's input_output_aliases); the second
// attends, and stream order makes every store visible to it.  Stores
// and reads in one launch would be unordered between its CTAs, and the
// attention is spread over many CTAs per row: CTAs per (batch row, KV
// head), so the G query heads that share a KV head read its keys and
// values while they are hot in L1/L2, and a chunk of S queries x G heads
// over ceil(S*G / 8) CTAs of 8 warps (a prefill chunk of 16 tokens would
// otherwise leave 130 of the 132 SMs idle).  One warp per (query, group
// head), its T f32 scores kept in shared memory.  Lanes split the keys
// for the scores (16-byte vector loads of a key row) and split head_dim
// for the PV sum (neighbouring lanes on neighbouring addresses).  With
// no softcap the loops stop at qpos: masked keys contribute exactly 0
// after exp, so that changes no result; with a softcap a masked score is
// tanh(-1e30/c)*c = -c, not -inf, so all T keys are visited as the
// composition does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_DPL = 8;       // head_dim <= 256: 8 dims per lane

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 to_bf16(float v) {
  return __float2bfloat16_rn(v);
}

// eight consecutive bf16 elements as f32, with one 16-byte load
__device__ __forceinline__ void load8(const bf16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
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

// the new cells: one thread per element of k_new / v_new
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
    const int pos = cache_index[b] + s;
    const int col = pos / bs;
    const int phys = col < W ? write_table[b * W + col] : 0;
    const size_t dst = (((size_t)phys * bs + pos % bs) * KV + h) * hd + d;
    k_pool[dst] = to_bf16(to_f(k_new[i]));
    v_pool[dst] = to_bf16(to_f(v_new[i]));
  }
}

template <typename QT>
__global__ void paged_attention_kernel(
    const QT* __restrict__ q, const bf16* __restrict__ k_pool,
    const bf16* __restrict__ v_pool, const int* __restrict__ block_table,
    const int* __restrict__ cache_index, bf16* __restrict__ out, int S,
    int KV, int G, int hd, int bs, int W, int T, float softcap,
    float scale) {
  extern __shared__ float smem[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int nwarps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ci = cache_index[b];

  float* sc = smem + (size_t)warp * T;
  float* qs = smem + (size_t)nwarps * T + (size_t)warp * hd;
  const int* table = block_table + (size_t)b * W;
  const int dpl = hd / 32;

  for (int qi = blockIdx.z * nwarps + warp; qi < S * G;
       qi += nwarps * gridDim.z) {
    const int s = qi / G;
    const int g = qi % G;
    const int qpos = ci + s;
    const int tend = softcap > 0.f ? T : min(qpos + 1, T);
    const QT* qp = q + ((((size_t)b * S + s) * KV + h) * G + g) * hd;
    for (int d = lane; d < hd; d += 32) qs[d] = to_f(qp[d]);
    __syncwarp();

    // -- scores: lanes split the keys
    float mx = -INFINITY;
    for (int t = lane; t < tend; t += 32) {
      const int blk = table[t / bs];
      const bf16* kp = k_pool + (((size_t)blk * bs + t % bs) * KV + h) * hd;
      float dot = 0.f;
      for (int d = 0; d < hd; d += 8) {
        float kv[8];
        load8(kp + d, kv);
#pragma unroll
        for (int j = 0; j < 8; ++j) dot += qs[d + j] * kv[j];
      }
      float v = dot * scale;
      if (t > qpos) v = NEG_INF;
      if (softcap > 0.f) v = tanhf(v / softcap) * softcap;
      sc[t] = v;
      mx = fmaxf(mx, v);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < tend; t += 32) {
      const float e = expf(sc[t] - mx);
      sc[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    __syncwarp();

    // -- p * V: lanes split head_dim
    float acc[MAX_DPL];
#pragma unroll
    for (int i = 0; i < MAX_DPL; ++i) acc[i] = 0.f;
    for (int t = 0; t < tend; ++t) {
      const float p = to_f(to_bf16(sc[t] / sum));
      const int blk = table[t / bs];
      const bf16* vp = v_pool + (((size_t)blk * bs + t % bs) * KV + h) * hd;
#pragma unroll
      for (int i = 0; i < MAX_DPL; ++i)
        if (i < dpl) acc[i] += p * to_f(vp[lane + 32 * i]);
    }
    bf16* op = out + ((((size_t)b * S + s) * KV + h) * G + g) * hd;
#pragma unroll
    for (int i = 0; i < MAX_DPL; ++i)
      if (i < dpl) op[lane + 32 * i] = to_bf16(acc[i]);
    __syncwarp();
  }
}

template <typename QT>
int launch(const void* q, const void* k_new, const void* v_new, void* k_pool,
           void* v_pool, const void* block_table, const void* write_table,
           const void* cache_index, void* out, int B, int S, int KV, int G,
           int hd, int bs, int W, int T, float softcap, float scale,
           int warps, cudaStream_t st) {
  const int* ci = static_cast<const int*>(cache_index);
  const size_t cells = (size_t)B * S * KV * hd;
  const int sblocks = (int)((cells + 255) / 256);
  store_kernel<QT><<<sblocks, 256, 0, st>>>(
      static_cast<const QT*>(k_new), static_cast<const QT*>(v_new),
      static_cast<bf16*>(k_pool), static_cast<bf16*>(v_pool),
      static_cast<const int*>(write_table), ci, B, S, KV, hd, bs, W);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem = (size_t)warps * (T + hd) * sizeof(float);
  auto kern = paged_attention_kernel<QT>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int qsplit = (S * G + warps - 1) / warps;
  kern<<<dim3(KV, B, qsplit), warps * 32, smem, st>>>(
      static_cast<const QT*>(q), static_cast<const bf16*>(k_pool),
      static_cast<const bf16*>(v_pool), static_cast<const int*>(block_table),
      ci, static_cast<bf16*>(out), S, KV, G, hd, bs, W, T, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int paged_attention_launch(
    const void* q, const void* k_new, const void* v_new, void* k_pool,
    void* v_pool, const void* block_table, const void* write_table,
    const void* cache_index, void* out, int B, int S, int KV, int G, int hd,
    int bs, int W, int T, float softcap, float scale, int q_bf16, int warps,
    void* stream) {
  if (B <= 0 || S <= 0 || hd % 32 != 0 || hd > 32 * MAX_DPL || T <= 0 ||
      T > W * bs || warps <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PA_ARGS q, k_new, v_new, k_pool, v_pool, block_table, write_table, \
    cache_index, out, B, S, KV, G, hd, bs, W, T, softcap, scale, warps, st
  if (q_bf16) return launch<bf16>(PA_ARGS);
  return launch<float>(PA_ARGS);
#undef PA_ARGS
}
