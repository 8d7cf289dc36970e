// Ragged paged flash-decode over float (bf16) fused KV pages, for Hopper
// (sm_90a), split over the keys (flash-decoding).
//
// Replaces the Pallas TPU kernel `paged_flash_decode`
// (src/repro/kernels/paged_attention/kernel.py, `_decode_kernel` with
// `_online_update(mx=False)`): one new query token per lane attends over
// slots [0, len) of its pool row's page. Pages are head-interleaved,
// kv [P, W, 2Hkv, Dh] bf16 with K_h = kv[:, :, 2h] and V_h = kv[:, :, 2h+1].
//
// What bounds it on the H100: memory, and at decode sizes launch latency.
// Each live slot's K and V rows are read once (4 * Dh bytes per slot and KV
// head) for ~4 flops per value: 0.85 MB at 4 lanes x 4 KV heads x 256
// slots, 0.3 us at 3.35 TB/s. The TPU kernel walks a lane's chunks in one
// grid step; on the card that gives lanes x KV heads blocks (16 of 132
// SMs) with a serial chunk loop. Here the keys are split instead.
//
// Design:
// - Grid (split, KV head, lane). Split s owns slots [s*SW, (s+1)*SW) of the
//   lane's page, SW = pick_splits(...) in ops.py (16..64). Its rows are
//   fetched at the clamped offset min(s*SW, W-SW), so the tail split of a
//   page whose width is not a multiple of SW re-reads an overlap that the
//   `live` mask drops. A split at or past the lane's length exits at once.
// - The split's K and V rows and the group's q rows go to shared memory
//   with 16-byte cp.async (at most (2 x 64 + 16) x Dh x 2 B: 36 KB at Dh
//   128, 72 KB at Dh 256, which opts into more than the 48 KB a launch
//   gets by default); q is in flight while the lane's length and page row
//   are read. 8 warps a block, so a 16-key split is one pass of the score
//   loop at Dh <= 128 (two at Dh 256).
// - Scores: a key's row is Dh/8 chunks of 8 bf16 (16 B); LPK lanes share
//   a key, LPK = Dh/8 rounded up to a power of two (16 at Dh 80, whose
//   lanes 10..15 hold zeros), each holding one chunk of its K row; the G
//   query heads' partial dots (G rounded up to 4, 8, 12 or 16, so they
//   are independent chains) finish with xor shuffles inside the group.
//   f32 times scale, dead slots at NEG_INF.
// - Softmax per query head (one warp per head): the split's own max, P =
//   exp(s - max), its sum l over the unrounded P, and bf16-rounded P for
//   PV, which is summed in f32 and added unrounded (the reference as XLA
//   compiles it; see paged_attention/ref.py).
// - Each split writes f32 (m, l) [G] and acc [G, Dh] to a scratch buffer
//   the wrapper allocates. A second kernel, one block per query head,
//   combines a lane's live splits in a fixed order (deterministic, no
//   atomics): with M = max m_s, out = sum_s e^(m_s-M) acc_s /
//   sum_s e^(m_s-M) l_s (l == 0 -> 1); a lane of length 0 writes zeros.
// - Partial mode (a rank's block of a cache sequence cut over ranks; the
//   ranks combine the blocks' partials as these splits are combined): the
//   combine writes that quotient in f32, before its bf16 rounding, and
//   the lane's lse = M + log(sum_s e^(m_s-M) l_s), -inf where no split is
//   live. The bf16 mode is that f32 value rounded, bitwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GMAX = 16;
constexpr float NEG_INF = -1e30f;
constexpr int MAX_SPLITS = 32 * 8;  // the combine's warp holds 8 a lane

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

// One block per (split, KV head, lane); GB >= G query heads are computed
// side by side (rows past G are computed and dropped). Scratch: ml
// [L, Hkv, NS, G, 2] (m, l) and acc [L, Hkv, NS, G, Dh], both f32.
template <int DH, int GB>
__global__ void __launch_bounds__(THREADS)
paged_decode_split_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ kv,
                          const int* __restrict__ rows,
                          const int* __restrict__ lengths,
                          float* __restrict__ ml, float* __restrict__ acc,
                          int W, int Hkv, int G, int SW, float scale) {
  constexpr int CH = DH / 8;  // 16-byte chunks of a row (8 bf16 each)
  static_assert(DH % 8 == 0 && CH <= 32, "head_dim: a multiple of 8, <= 256");
  // lanes per key: CH rounded up to a power of two (the shuffle tree)
  constexpr int LPK = CH <= 1 ? 1 : CH <= 2 ? 2 : CH <= 4 ? 4 : CH <= 8 ? 8
                    : CH <= 16 ? 16 : 32;
  constexpr int KPW = 32 / LPK;  // keys per warp pass
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [SW][DH]
  __nv_bfloat16* vs = ks + SW * DH;                             // [SW][DH]
  __nv_bfloat16* qs = vs + SW * DH;                             // [G][DH]
  float* ss = reinterpret_cast<float*>(qs + G * DH);            // [G][SW]

  const int s = blockIdx.x, h = blockIdx.y, li = blockIdx.z;
  const int NS = gridDim.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the group's q rows are in flight while the lane's length is read
  const __nv_bfloat16* qh = q + (size_t)(li * Hkv + h) * G * DH;
  for (int i = tid; i < G * CH; i += THREADS)
    hopper::cp_async16(qs + 8 * i, qh + 8 * i);
  hopper::cp_async_commit();
  const int len = min(max(lengths[li], 0), W);
  const int s0 = s * SW;
  if (s0 >= len) {  // empty split: the combine does not read it
    hopper::cp_async_wait<0>();
    return;
  }
  const int offs = min(s0, W - SW);
  const size_t slot_stride = (size_t)2 * Hkv * DH;  // elements per slot
  const __nv_bfloat16* kbase =
      kv + ((size_t)rows[li] * W + offs) * slot_stride + (size_t)2 * h * DH;
  for (int i = tid; i < SW * CH; i += THREADS) {  // K and V rows, 16 B each
    const int j = i / CH, c = i % CH;
    const __nv_bfloat16* src = kbase + (size_t)j * slot_stride + 8 * c;
    hopper::cp_async16(ks + j * DH + 8 * c, src);
    hopper::cp_async16(vs + j * DH + 8 * c, src + DH);
  }
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();

  // scores: lane group of LPK lanes per key, 8 dims a lane (lanes past
  // the row's CH chunks hold zeros)
  const int part = lane % LPK;
  const bool has = part < CH;
  for (int j0 = warp * KPW; j0 < SW; j0 += WARPS * KPW) {
    const int j = j0 + lane / LPK;
    float kf[8];
    if (j < SW && has) {
      const uint4 raw = *reinterpret_cast<const uint4*>(ks + j * DH + 8 * part);
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(k2[e]);
        kf[2 * e] = f.x;
        kf[2 * e + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) kf[e] = 0.0f;
    }
    const int pos = offs + j;
    const bool live = j < SW && pos >= s0 && pos < len;
    float dots[GB];  // the heads' partial dots, independent chains
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const int gq = g < G ? g : G - 1;
      float d = 0.0f;
      if (has) {
        const uint4 qraw =
            *reinterpret_cast<const uint4*>(qs + gq * DH + 8 * part);
        const __nv_bfloat162* q2 =
            reinterpret_cast<const __nv_bfloat162*>(&qraw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(q2[e]);
          d = fmaf(f.x, kf[2 * e], d);
          d = fmaf(f.y, kf[2 * e + 1], d);
        }
      }
      dots[g] = d;
    }
#pragma unroll
    for (int o = LPK / 2; o > 0; o >>= 1)
#pragma unroll
      for (int g = 0; g < GB; ++g)
        dots[g] += __shfl_xor_sync(0xffffffffu, dots[g], o);
    if (part == 0 && j < SW) {
#pragma unroll
      for (int g = 0; g < GB; ++g)
        if (g < G) ss[g * SW + j] = live ? dots[g] * scale : NEG_INF;
    }
  }
  __syncthreads();

  // softmax of the split, one warp per query head
  const size_t base = ((size_t)(li * Hkv + h) * NS + s) * G;
  for (int g = warp; g < G; g += WARPS) {
    float mx = NEG_INF;
    for (int j = lane; j < SW; j += 32) mx = fmaxf(mx, ss[g * SW + j]);
    mx = warp_max(mx);
    float rsum = 0.0f;
    for (int j = lane; j < SW; j += 32) {
      const int pos = offs + j;
      float p = 0.0f;
      if (pos >= s0 && pos < len) p = expf(ss[g * SW + j] - mx);
      ss[g * SW + j] = __bfloat162float(__float2bfloat16_rn(p));
      rsum += p;
    }
    rsum = warp_sum(rsum);
    if (lane == 0) {
      ml[2 * (base + g)] = mx;
      ml[2 * (base + g) + 1] = rsum;
    }
  }
  __syncthreads();

  // PV over bf16(P), f32 sums: a thread owns column d of the query heads
  // g0, g0 + GPT, ... and reads each V value once (at Dh 80 the last 16
  // threads have no column)
  constexpr int GPT = THREADS / DH;  // query heads side by side in a pass
  constexpr int GREG = (GB + GPT - 1) / GPT;
  if (tid >= GPT * DH) return;
  const int d = tid % DH, g0 = tid / DH;
  float pv[GREG];
#pragma unroll
  for (int r = 0; r < GREG; ++r) pv[r] = 0.0f;
  for (int j = 0; j < SW; ++j) {
    const float v = __bfloat162float(vs[j * DH + d]);
#pragma unroll
    for (int r = 0; r < GREG; ++r) {
      const int g = g0 + r * GPT;
      if (g < G) pv[r] = fmaf(ss[g * SW + j], v, pv[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < GREG; ++r) {
    const int g = g0 + r * GPT;
    if (g < G) acc[(base + g) * DH + d] = pv[r];
  }
}

// One block per (query head, KV head, lane), a thread per head_dim column:
// combine the lane's live splits in split order. Every load is issued at
// once (one round trip): the length, warp 0's (m, l) of every split, each
// column's acc of the first 16 splits; the splits past the length are
// dropped after. Warp 0 turns (m, l) into weights e^(m_s - M) and the
// denominator; then each column takes its weighted sum.
__global__ void paged_decode_combine_kernel(const float* __restrict__ ml,
                                            const float* __restrict__ acc,
                                            const int* __restrict__ lengths,
                                            void* __restrict__ out,
                                            float* __restrict__ lse,
                                            int W, int Hkv, int G, int Dh,
                                            int SW, int NS) {
  extern __shared__ float wts[];  // [NS] weights, then the denominator
  const int g = blockIdx.x, h = blockIdx.y, li = blockIdx.z;
  const size_t base = (size_t)(li * Hkv + h) * NS;  // split 0 of the lane
  const int tid = threadIdx.x;
  float a[16];
  if (tid < Dh) {
#pragma unroll
    for (int r = 0; r < 16; ++r)
      a[r] = r < NS ? acc[((base + r) * G + g) * Dh + tid] : 0.0f;
  }
  float m[8], l[8];
  if (tid < 32) {  // lane t holds splits t, t + 32, ... (NS <= MAX_SPLITS)
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int s = tid + 32 * r;
      const size_t i = 2 * ((base + s) * G + g);
      m[r] = s < NS ? ml[i] : NEG_INF;
      l[r] = s < NS ? ml[i + 1] : 0.0f;
    }
  }
  const int len = min(max(lengths[li], 0), W);
  const int nlive = (len + SW - 1) / SW;
  if (tid < 32) {
    float mmax = NEG_INF;
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (tid + 32 * r < nlive) mmax = fmaxf(mmax, m[r]);
    mmax = warp_max(mmax);
    float den = 0.0f;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int s = tid + 32 * r;
      if (s < nlive) {
        const float w = expf(m[r] - mmax);
        wts[s] = w;
        den = fmaf(w, l[r], den);
      }
    }
    den = warp_sum(den);
    if (tid == 0) {
      wts[NS] = den == 0.0f ? 1.0f : den;
      if (lse != nullptr)
        lse[(size_t)(li * Hkv + h) * G + g] =
            den == 0.0f ? -INFINITY : mmax + logf(den);
    }
  }
  __syncthreads();
  if (tid < Dh) {
    float num = 0.0f;
#pragma unroll
    for (int r = 0; r < 16; ++r)
      if (r < nlive) num = fmaf(wts[r], a[r], num);
    for (int s0 = 16; s0 < nlive; s0 += 16) {  // pages past 16 splits
#pragma unroll
      for (int r = 0; r < 16; ++r)
        a[r] = s0 + r < nlive ? acc[((base + s0 + r) * G + g) * Dh + tid] : 0.0f;
#pragma unroll
      for (int r = 0; r < 16; ++r)
        if (s0 + r < nlive) num = fmaf(wts[s0 + r], a[r], num);
    }
    const size_t o = ((size_t)(li * Hkv + h) * G + g) * Dh + tid;
    if (lse != nullptr)
      static_cast<float*>(out)[o] = num / wts[NS];
    else
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(num / wts[NS]);
  }
}

// shared memory of a split block: K and V rows, q rows, scores
constexpr int split_smem(int dh, int sw, int g) {
  return (2 * sw + g) * dh * 2 + g * sw * 4;
}

template <int DH, int GB>
int launch_split(const void* q, const void* kv, const int* rows,
                 const int* lengths, float* ml, float* acc, int L, int W,
                 int Hkv, int G, int SW, int NS, float scale,
                 cudaStream_t st) {
  const int smem = split_smem(DH, SW, G);
  if (smem > 48 * 1024) {  // Dh 256 with wide splits: opt in, once
    static hopper::DeviceSet opted;
    if (!opted.has_current()) {
      const cudaError_t e = cudaFuncSetAttribute(
          paged_decode_split_kernel<DH, GB>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          split_smem(DH, 64, GMAX));
      if (e != cudaSuccess) return (int)e;
      opted.add_current();
    }
  }
  dim3 grid(NS, Hkv, L);
  paged_decode_split_kernel<DH, GB><<<grid, THREADS, smem, st>>>(
      reinterpret_cast<const __nv_bfloat16*>(q),
      reinterpret_cast<const __nv_bfloat16*>(kv), rows, lengths, ml, acc, W,
      Hkv, G, SW, scale);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_split_g(const void* q, const void* kv, const int* rows,
                   const int* lengths, float* ml, float* acc, int L, int W,
                   int Hkv, int G, int SW, int NS, float scale,
                   cudaStream_t st) {
  if (G <= 4)
    return launch_split<DH, 4>(q, kv, rows, lengths, ml, acc, L, W, Hkv, G, SW, NS, scale, st);
  if (G <= 8)
    return launch_split<DH, 8>(q, kv, rows, lengths, ml, acc, L, W, Hkv, G, SW, NS, scale, st);
  if (G <= 12)
    return launch_split<DH, 12>(q, kv, rows, lengths, ml, acc, L, W, Hkv, G, SW, NS, scale, st);
  return launch_split<DH, GMAX>(q, kv, rows, lengths, ml, acc, L, W, Hkv, G, SW, NS, scale, st);
}

}  // namespace

// q bf16 [L, Hkv, G, Dh]; kv bf16 [P, W, 2Hkv, Dh]; rows / lengths i32
// [L]; ml f32 [L, Hkv, NS, G, 2] and acc f32 [L, Hkv, NS, G, Dh] scratch;
// out bf16 [L, Hkv, G, Dh], or with lse (f32 [L, Hkv, G], else null: the
// partial mode) out f32 [L, Hkv, G, Dh]. G <= 16, Dh in {8, 16, 32, 64, 80, 128, 256},
// SW <= 64 and SW <= W, NS = ceil(W / SW) <= 256; 16-byte aligned q and
// kv. Shared memory: at most (2*64 + 16)*Dh*2 + 16*64*4 bytes, 40 KB at
// Dh 128 and 76 KB at Dh 256 (18.3 KB at the 16-key splits of pages up to
// 4096 slots with G = 4). Returns the launches' cudaError_t.
extern "C" int paged_decode_launch(const void* q, const void* kv,
                                   const int* rows, const int* lengths,
                                   float* ml, float* acc, void* out,
                                   float* lse, int L, int W, int Hkv, int G,
                                   int Dh, int SW, int NS, float scale,
                                   void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (NS > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  int err;
  switch (Dh) {
    case 8: err = launch_split_g<8>(q, kv, rows, lengths, ml, acc, L, W, Hkv, G, SW, NS, scale, st); break;
    case 16: err = launch_split_g<16>(q, kv, rows, lengths, ml, acc, L, W, Hkv, G, SW, NS, scale, st); break;
    case 32: err = launch_split_g<32>(q, kv, rows, lengths, ml, acc, L, W, Hkv, G, SW, NS, scale, st); break;
    case 64: err = launch_split_g<64>(q, kv, rows, lengths, ml, acc, L, W, Hkv, G, SW, NS, scale, st); break;
    case 80: err = launch_split_g<80>(q, kv, rows, lengths, ml, acc, L, W, Hkv, G, SW, NS, scale, st); break;
    case 128: err = launch_split_g<128>(q, kv, rows, lengths, ml, acc, L, W, Hkv, G, SW, NS, scale, st); break;
    case 256: err = launch_split_g<256>(q, kv, rows, lengths, ml, acc, L, W, Hkv, G, SW, NS, scale, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  dim3 grid(G, Hkv, L);
  paged_decode_combine_kernel<<<grid, Dh < 32 ? 32 : Dh, (NS + 1) * 4, st>>>(
      ml, acc, lengths, out, lse, W, Hkv, G, Dh, SW, NS);
  return (int)cudaGetLastError();
}
