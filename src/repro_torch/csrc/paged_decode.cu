// Ragged paged flash-decode over float (bf16) fused KV pages, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_flash_decode`
// (src/repro/kernels/paged_attention/kernel.py, `_decode_kernel` with
// `_online_update(mx=False)`): one new query token per lane attends over
// slots [0, len) of its pool row's page. Pages are head-interleaved,
// kv [P, W, 2Hkv, Dh] bf16 with K_h = kv[:, :, 2h] and V_h = kv[:, :, 2h+1].
//
// What bounds it on the H100: memory. Each live slot's K and V rows are
// read once (4 * Dh bytes per slot and KV head) for ~4 flops per value. At
// decode sizes it is launch-latency bound: lanes x KV heads blocks of a few
// microseconds each.
//
// Design (the structure of paged_decode_mx.cu without dequant and without
// P quantization):
// - One block per (lane, KV head); the G query heads of the group share it.
// - The block walks its lane's length in bk-slot chunks, bk = pick_bk(W).
//   The tail chunk is fetched at the clamped offset min(c*bk, W-bk), as the
//   Pallas kernel does, and the overlap is masked by `live`.
// - Per chunk: the K rows go to shared memory (padded row stride), scores
//   q.k in f32 times scale, dead slots at NEG_INF; then the V rows into the
//   same buffer; online softmax per query head, one warp per head, with an
//   f32 running max and sum of the unrounded P; PV over bf16(P) in f32,
//   one head_dim column per thread. The Pallas source writes the PV einsum
//   with a bf16 result, but XLA compiles it to an f32 dot and folds the
//   bf16 round trip away, so the reference adds the unrounded PV to its
//   f32 accumulator; so does this kernel.
// - Epilogue divides by l (l == 0 -> 1); a lane of length 0 runs no chunk
//   and writes zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int GMAX = 16;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

// Copy bk page rows of one operand (Dh bf16 each, `slot_stride` elements
// apart) into `tile` (row stride `ts` halves), two halves per load.
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile, int ts,
                                          const __nv_bfloat16* src,
                                          size_t slot_stride, int bk, int Dh) {
  const int pairs = Dh / 2;
  for (int i = threadIdx.x; i < bk * pairs; i += THREADS) {
    const int j = i / pairs, d2 = i % pairs;
    *reinterpret_cast<__nv_bfloat162*>(tile + j * ts + 2 * d2) =
        *reinterpret_cast<const __nv_bfloat162*>(src + (size_t)j * slot_stride + 2 * d2);
  }
}

__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ kv,
                    const int* __restrict__ rows,
                    const int* __restrict__ lengths,
                    __nv_bfloat16* __restrict__ out, int W, int Hkv, int G,
                    int Dh, int bk, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);  // [G][Dh]
  float* ss = qs + G * Dh;                     // [G][bk]
  float* m_s = ss + G * bk;                    // [G]
  float* l_s = m_s + G;
  float* corr_s = l_s + G;
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(corr_s + G);
  const int ts = Dh + 2;  // halves per tile row (odd word stride)

  const int li = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row = rows[li];
  const int len = min(max(lengths[li], 0), W);

  const __nv_bfloat16* qh = q + (size_t)(li * Hkv + h) * G * Dh;
  for (int i = tid; i < G * Dh; i += THREADS) qs[i] = __bfloat162float(qh[i]);
  if (tid < G) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.0f;
  }
  float acc[GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) acc[g] = 0.0f;
  __syncthreads();

  const size_t slot_stride = (size_t)2 * Hkv * Dh;  // elements per slot
  const int nchunks = (len + bk - 1) / bk;
  for (int c = 0; c < nchunks; ++c) {
    const int offs = min(c * bk, W - bk);
    const __nv_bfloat16* kbase = kv + ((size_t)row * W + offs) * slot_stride + (size_t)2 * h * Dh;
    load_tile(tile, ts, kbase, slot_stride, bk, Dh);
    __syncthreads();
    if (tid < bk) {  // scores of key tid for every query head of the group
      float sacc[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) sacc[g] = 0.0f;
      const __nv_bfloat162* krow = reinterpret_cast<const __nv_bfloat162*>(tile + tid * ts);
      for (int d2 = 0; d2 < Dh / 2; ++d2) {
        float2 k2 = __bfloat1622float2(krow[d2]);
#pragma unroll
        for (int g = 0; g < GMAX; ++g) {
          if (g < G) {
            sacc[g] += qs[g * Dh + 2 * d2] * k2.x;
            sacc[g] += qs[g * Dh + 2 * d2 + 1] * k2.y;
          }
        }
      }
      const int pos = offs + tid;
      const bool live = pos >= c * bk && pos < len;
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < G) ss[g * bk + tid] = live ? sacc[g] * scale : NEG_INF;
    }
    __syncthreads();
    load_tile(tile, ts, kbase + Dh, slot_stride, bk, Dh);  // V rows
    // online softmax: f32 running max and sum of the unrounded P; the
    // bf16-rounded P is what enters PV
    for (int g = warp; g < G; g += THREADS / 32) {
      float mx = NEG_INF;
      for (int j = lane; j < bk; j += 32) mx = fmaxf(mx, ss[g * bk + j]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float corr = expf(m_prev - m_new);
      float rsum = 0.0f;
      for (int j = lane; j < bk; j += 32) {
        const int pos = offs + j;
        float p = 0.0f;
        if (pos >= c * bk && pos < len) p = expf(ss[g * bk + j] - m_new);
        ss[g * bk + j] = bf16_round(p);
        rsum += p;
      }
      rsum = warp_sum(rsum);
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = l_s[g] * corr + rsum;
        corr_s[g] = corr;
      }
    }
    __syncthreads();
    if (tid < Dh) {  // PV: head_dim column tid
      float pv[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) pv[g] = 0.0f;
      for (int j = 0; j < bk; ++j) {
        const float v = __bfloat162float(tile[j * ts + tid]);
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          if (g < G) pv[g] += ss[g * bk + j] * v;
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
        if (g < G) acc[g] = acc[g] * corr_s[g] + pv[g];
    }
    __syncthreads();
  }

  if (tid < Dh) {
    __nv_bfloat16* oh = out + (size_t)(li * Hkv + h) * G * Dh;
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g < G) {
        const float l = l_s[g];
        oh[g * Dh + tid] = __float2bfloat16_rn(acc[g] / (l == 0.0f ? 1.0f : l));
      }
    }
  }
}

}  // namespace

extern "C" int paged_decode_smem_bytes(int G, int Dh, int bk) {
  return (G * Dh + G * bk + 3 * G) * 4 + bk * (Dh + 2) * 2;
}

// q bf16 [L, Hkv, G, Dh]; kv bf16 [P, W, 2Hkv, Dh]; rows / lengths i32
// [L]; out bf16 [L, Hkv, G, Dh]. G <= 16, Dh <= 128 and even,
// bk <= min(128, W). Returns the launch's cudaError_t.
extern "C" int paged_decode_launch(const void* q, const void* kv,
                                   const int* rows, const int* lengths,
                                   void* out, int L, int W, int Hkv, int G,
                                   int Dh, int bk, float scale, void* stream) {
  const int smem = paged_decode_smem_bytes(G, Dh, bk);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(L, Hkv);
  paged_decode_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(q),
      reinterpret_cast<const __nv_bfloat16*>(kv), rows, lengths,
      reinterpret_cast<__nv_bfloat16*>(out), W, Hkv, G, Dh, bk, scale);
  return (int)cudaGetLastError();
}
