// Ragged paged flash-decode over quantized-resident MXFP4 KV pages, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_flash_decode_mx`
// (src/repro/kernels/paged_attention/kernel.py, `_decode_kernel_mx`): one
// new query token per lane attends over its pool row's page. The page
// stays in the MXFP4 code domain in device memory (nibble-packed codes
// [P, W, 2Hkv, Dpad/2], K row exponents [P, W, Hkv, Dpad/32], V 32-slot
// block exponents [P, ceil(W/32), Hkv, Dh]) and is decoded to bf16 inside
// shared memory through the 256-entry pair table.
//
// What bounds it on the H100: memory. It reads each live slot's codes and
// exponents once, about 4.25 bits per K or V value, and does ~4 flops per
// value read, far below the card's ridge point. At decode sizes it is
// launch-latency bound: lanes x KV heads blocks of a few microseconds.
//
// Design:
// - One block per (lane, KV head); the G query heads of the group share
//   it (G = 9 at starcoder2-7b width: masked, not a power of two).
// - The block walks its lane's valid length in bk-slot chunks,
//   bk = pick_bk(W). The tail chunk is fetched at the clamped offset
//   min(c*bk, W-bk), exactly as the Pallas kernel does, and the overlap is
//   masked; P's 32-key quantization blocks are aligned to that fetched
//   offset, so they group the same keys as the reference kernel.
// - Per chunk: decode K into shared (bf16 pairs, padded row stride so the
//   per-key dot products are bank-conflict free), scores q.k in f32 times
//   scale rounded to bf16, dead slots at NEG_INF; decode V into the same
//   buffer; online softmax per query head, with P fake-quantized to MXFP4
//   per 32-key block of the chunk (one warp = one block: amax by shuffle)
//   and the normaliser l summing the quantized P; PV in f32 over bf16-exact
//   operands, one head_dim column per thread held in registers.
// - Epilogue divides by l (l == 0 -> 1); a lane of length 0 runs no chunk
//   and writes zeros.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int GMAX = 16;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float f32_from_field(int f) {
  return __int_as_float(f << 23);
}

__device__ __forceinline__ float pow2_wide(int e) {
  int h1 = min(max(e >> 1, -126), 127);
  int h2 = min(max(e - h1, -126), 127);
  return __int_as_float((h1 + 127) << 23) * __int_as_float((h2 + 127) << 23);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float bits_bf16(uint32_t b) {
  return __uint_as_float(b << 16);
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

// MXFP4 quantize-dequantize of one 32-key block of non-negative P held
// one value per lane (the reference's f32 fake_quant chain).
__device__ __forceinline__ float fake_quant_lane(float p) {
  float amax = warp_max(p);
  int ebf = min(max((__float_as_int(amax) >> 23) & 0xFF, 2), 254);
  float y = p * f32_from_field(256 - ebf);
  int e = min(max((__float_as_int(y) >> 23) - 127, 0), 2);
  float q = rintf(y * f32_from_field(128 - e)) * f32_from_field(126 + e);
  q = fminf(q, 6.0f);
  return q * pow2_wide(ebf - 129);
}

// Decode one operand's bk x Dh chunk into `tile` (bf16, row stride `ts`
// halves). `v_exps` null: K (row exponents along head_dim); else V
// (per-element exponents of the slot's 32-slot block).
__device__ __forceinline__ void decode_tile(
    __nv_bfloat16* tile, int ts, const uint8_t* codes, size_t slot_stride,
    const int8_t* k_exps, size_t kexp_slot_stride, const int8_t* v_exps,
    size_t vexp_block_stride, int offs, const uint32_t* tab, int bk, int Dh,
    int hb) {
  const int words = hb / 4;
  for (int i = threadIdx.x; i < bk * words; i += THREADS) {
    const int j = i / words, d0 = 8 * (i % words);
    if (d0 >= Dh) continue;  // head_dim padding: dropped
    uint32_t word = *reinterpret_cast<const uint32_t*>(
        codes + (size_t)j * slot_stride + 4 * (i % words));
    float ksc = 0.0f;
    if (v_exps == nullptr)
      ksc = bf16_round(pow2_wide((int)k_exps[(size_t)j * kexp_slot_stride + d0 / 32] - 1));
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      uint32_t pair = tab[(word >> (8 * b)) & 0xFF];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = d0 + 2 * b + h;
        if (d >= Dh) continue;
        float sc = ksc;
        if (v_exps != nullptr)
          sc = bf16_round(pow2_wide(
              (int)v_exps[(size_t)((offs + j) / 32) * vexp_block_stride + d] - 1));
        float code = bits_bf16(h ? (pair >> 16) : (pair & 0xFFFF));
        tile[j * ts + d] = __float2bfloat16_rn(code * sc);  // exact
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
paged_decode_mx_kernel(const __nv_bfloat16* __restrict__ q,
                       const uint8_t* __restrict__ kv_codes,
                       const int8_t* __restrict__ k_exps,
                       const int8_t* __restrict__ v_exps,
                       const int* __restrict__ rows,
                       const int* __restrict__ lengths,
                       const uint32_t* __restrict__ table,
                       __nv_bfloat16* __restrict__ out, int W, int Hkv, int G,
                       int Dh, int dpad, int nwb, int bk, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  float* qs = reinterpret_cast<float*>(tab + 256);          // [G][Dh]
  float* ss = qs + G * Dh;                                   // [G][bk]
  float* m_s = ss + G * bk;                                  // [G]
  float* l_s = m_s + G;
  float* corr_s = l_s + G;
  __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(corr_s + G);
  const int ts = Dh + 2;  // halves per tile row (odd word stride)

  const int li = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row = rows[li];
  const int len = min(max(lengths[li], 0), W);
  const int hb = dpad / 2, nbd = dpad / 32;

  for (int i = tid; i < 256; i += THREADS) tab[i] = table[i];
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

  const size_t slot_stride = (size_t)2 * Hkv * hb;  // bytes per slot
  const int nchunks = (len + bk - 1) / bk;
  for (int c = 0; c < nchunks; ++c) {
    const int offs = min(c * bk, W - bk);
    const uint8_t* kbase = kv_codes + ((size_t)row * W + offs) * slot_stride + (size_t)2 * h * hb;
    decode_tile(tile, ts, kbase, slot_stride,
                k_exps + (((size_t)row * W + offs) * Hkv + h) * nbd,
                (size_t)Hkv * nbd, nullptr, 0, offs, tab, bk, Dh, hb);
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
        if (g < G) ss[g * bk + tid] = live ? bf16_round(sacc[g] * scale) : NEG_INF;
    }
    __syncthreads();
    decode_tile(tile, ts, kbase + hb, slot_stride, nullptr, 0,
                v_exps + ((size_t)row * nwb * Hkv + h) * Dh, (size_t)Hkv * Dh,
                offs, tab, bk, Dh, hb);
    // online softmax; P quantized per 32-key block of the fetched chunk
    for (int g = warp; g < G; g += THREADS / 32) {
      float mx = NEG_INF;
      for (int j = lane; j < bk; j += 32) mx = fmaxf(mx, ss[g * bk + j]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float corr = expf(m_prev - m_new);
      float rsum = 0.0f;
      for (int j0 = 0; j0 < bk; j0 += 32) {
        const int j = j0 + lane;
        float p = 0.0f;
        if (j < bk) {
          const int pos = offs + j;
          if (pos >= c * bk && pos < len) p = expf(ss[g * bk + j] - m_new);
        }
        const float pq = fake_quant_lane(p);
        if (j < bk) ss[g * bk + j] = pq;
        rsum += pq;
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

extern "C" int paged_decode_mx_smem_bytes(int G, int Dh, int bk) {
  return (256 + G * Dh + G * bk + 3 * G) * 4 + bk * (Dh + 2) * 2;
}

// q bf16 [L, Hkv, G, Dh]; kv_codes u8 [P, W, 2Hkv, dpad/2]; k_exps i8
// [P, W, Hkv, dpad/32]; v_exps i8 [P, nwb, Hkv, Dh]; rows / lengths i32
// [L]; table u32 [256]; out bf16 [L, Hkv, G, Dh]. G <= 16, Dh <= 128,
// bk <= min(128, W). Returns the launch's cudaError_t.
extern "C" int paged_decode_mx_launch(
    const void* q, const uint8_t* kv_codes, const int8_t* k_exps,
    const int8_t* v_exps, const int* rows, const int* lengths,
    const uint32_t* table, void* out, int L, int W, int Hkv, int G, int Dh,
    int dpad, int nwb, int bk, float scale, void* stream) {
  const int smem = paged_decode_mx_smem_bytes(G, Dh, bk);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_mx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(L, Hkv);
  paged_decode_mx_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(q), kv_codes, k_exps, v_exps,
      rows, lengths, table, reinterpret_cast<__nv_bfloat16*>(out), W, Hkv, G,
      Dh, dpad, nwb, bk, scale);
  return (int)cudaGetLastError();
}
