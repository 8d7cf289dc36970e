// Tiled online-softmax attention (FlashAttention-style) for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_kernel`
// (src/repro/kernels/flash_attention/kernel.py, `_kernel`): per query row,
// softmax(q k^T * D^-0.5) v over the keys its masks allow, with a running
// max and sum and the division deferred to the end. All arithmetic is f32
// (q, k and v are read as f32, whatever their type); the output has q's
// type. GQA maps query head h to KV head h / (H / Hkv), causal and
// sliding-window masks are relative to q_offset (the absolute position of
// q[0]), and a row with no key left divides by 1 and yields zeros.
//
// What bounds it on the H100: operations. It does 4 * Sq * Sk * D flops
// per head (about half with a causal mask) against 2 * (Sq + 2 Sk) * D
// bytes; in f32 on the CUDA cores (67 TFLOP/s, no tensor cores in this
// version) that is far above the memory time.
//
// Design:
// - Layout [B, S, H, D] is read in place (no transpose): a block owns 64
//   query rows of one (batch, head) and walks the keys in tiles of 64.
//   Tiles that the causal or window mask hides from every row of the block
//   are skipped (`kernel.py:69-75`); skipping such a tile changes nothing.
//   Ragged tails of Sq and Sk are masked in the kernel, where the Pallas
//   wrapper shrinks its tiles to divisors: the same result.
// - Q, K and V tiles sit in shared memory in their input type (bf16 at
//   the prefill shape: 67 KB a block, so three blocks share an SM) with a row stride
//   of D + 2 elements, which keeps the per-key and per-row reads
//   bank-conflict free; they are widened to f32 as they are read.
// - Scores: each thread computes a 4-row x 8-key register tile. Softmax:
//   one warp per 16 rows, max and sum by shuffle. PV: each thread keeps an
//   8-row x 8-column f32 accumulator in registers, rescaled per tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 128;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
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

struct Masks {
  int Sq, Sk, q_offset, window;
  bool causal;
  // query row `qrow` of q (0-based) against key position `kp`
  __device__ __forceinline__ bool ok(int qrow, int kp) const {
    if (qrow >= Sq || kp >= Sk) return false;
    const int qp = q_offset + qrow;
    if (causal && kp > qp) return false;
    if (window > 0 && kp <= qp - window) return false;
    return true;
  }
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int Hkv, int D, float scale, Masks mk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ds = D + 2;  // row stride (elements)
  T* qs = reinterpret_cast<T*>(smem);  // [BQ][ds]
  T* ks = qs + BQ * ds;                // [BK][ds]
  T* vs = ks + BK * ds;                // [BK][ds]
  float* ps = reinterpret_cast<float*>(vs + BK * ds);  // [BQ][BK + 1]
  float* m_s = ps + BQ * (BK + 1);
  float* l_s = m_s + BQ;
  float* corr_s = l_s + BQ;
  const int pstr = BK + 1;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = blockIdx.y * BQ;  // first query row of the block
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t qrow_stride = (size_t)H * D, krow_stride = (size_t)Hkv * D;
  const T* qb = q + ((size_t)b * mk.Sq * H + h) * D;
  const T* kb = k + ((size_t)b * mk.Sk * Hkv + hk) * D;
  const T* vb = v + ((size_t)b * mk.Sk * Hkv + hk) * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D;
    if (q0 + r < mk.Sq)
      qs[r * ds + d] = qb[(size_t)(q0 + r) * qrow_stride + d];
    else
      store(qs + r * ds + d, 0.0f);
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.0f;
  }
  float acc[8][8];
#pragma unroll
  for (int rr = 0; rr < 8; ++rr)
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) acc[rr][cc] = 0.0f;

  // absolute positions of the block's first and last real query rows
  const int first_q = mk.q_offset + q0;
  const int last_q = mk.q_offset + min(q0 + BQ, mk.Sq) - 1;
  const int nkt = (mk.Sk + BK - 1) / BK;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    if (mk.causal && k0 > last_q) break;
    if (mk.window > 0 && k0 + BK - 1 <= first_q - mk.window) continue;
    __syncthreads();  // the previous tile's reads are done (and qs is set)
    for (int i = tid; i < BK * D; i += THREADS) {
      const int j = i / D, d = i % D;
      if (k0 + j < mk.Sk) {
        ks[j * ds + d] = kb[(size_t)(k0 + j) * krow_stride + d];
        vs[j * ds + d] = vb[(size_t)(k0 + j) * krow_stride + d];
      } else {
        store(ks + j * ds + d, 0.0f);
        store(vs + j * ds + d, 0.0f);
      }
    }
    __syncthreads();
    {  // scores: rows 4*ty .. 4*ty+3, keys tx + 8*jj
      const int ty = tid >> 3, tx = tid & 7;
      float s[4][8];
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) s[ii][jj] = 0.0f;
      for (int d = 0; d < D; ++d) {
        float qv[4], kv[8];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) qv[ii] = to_f32(qs[(4 * ty + ii) * ds + d]);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) kv[jj] = to_f32(ks[(tx + 8 * jj) * ds + d]);
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) s[ii][jj] = fmaf(qv[ii], kv[jj], s[ii][jj]);
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii) {
        const int r = 4 * ty + ii;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = tx + 8 * jj;
          ps[r * pstr + j] = mk.ok(q0 + r, k0 + j) ? s[ii][jj] * scale : NEG_INF;
        }
      }
    }
    __syncthreads();
    for (int r = warp; r < BQ; r += THREADS / 32) {  // online softmax per row
      const float s0 = ps[r * pstr + lane], s1 = ps[r * pstr + lane + 32];
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = mk.ok(q0 + r, k0 + lane) ? expf(s0 - m_new) : 0.0f;
      const float p1 = mk.ok(q0 + r, k0 + lane + 32) ? expf(s1 - m_new) : 0.0f;
      ps[r * pstr + lane] = p0;
      ps[r * pstr + lane + 32] = p1;
      const float rsum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + rsum;
        corr_s[r] = corr;
      }
    }
    __syncthreads();
    {  // PV: rows 8*ty .. 8*ty+7, columns tx + 16*cc
      const int ty = tid >> 4, tx = tid & 15;
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        const float corr = corr_s[8 * ty + rr];
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) acc[rr][cc] *= corr;
      }
      for (int j = 0; j < BK; ++j) {
        float pv[8], vv[8];
#pragma unroll
        for (int rr = 0; rr < 8; ++rr) pv[rr] = ps[(8 * ty + rr) * pstr + j];
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) {
          const int c = tx + 16 * cc;
          vv[cc] = c < D ? to_f32(vs[j * ds + c]) : 0.0f;
        }
#pragma unroll
        for (int rr = 0; rr < 8; ++rr)
#pragma unroll
          for (int cc = 0; cc < 8; ++cc) acc[rr][cc] = fmaf(pv[rr], vv[cc], acc[rr][cc]);
      }
    }
  }
  __syncthreads();

  const int ty = tid >> 4, tx = tid & 15;
  T* ob = out + ((size_t)b * mk.Sq * H + h) * D;
#pragma unroll
  for (int rr = 0; rr < 8; ++rr) {
    const int r = 8 * ty + rr;
    if (q0 + r >= mk.Sq) continue;
    const float l = l_s[r];
    const float den = l == 0.0f ? 1.0f : l;
#pragma unroll
    for (int cc = 0; cc < 8; ++cc) {
      const int c = tx + 16 * cc;
      if (c < D) store(ob + (size_t)(q0 + r) * qrow_stride + c, acc[rr][cc] / den);
    }
  }
}

template <typename T>
int smem_bytes(int D) {
  return (BQ + 2 * BK) * (D + 2) * (int)sizeof(T) + (BQ * (BK + 1) + 3 * BQ) * 4;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int Hkv, int D, float scale, int causal,
           int window, int q_offset, cudaStream_t stream) {
  const int smem = smem_bytes<T>(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  Masks mk{Sq, Sk, q_offset, window, causal != 0};
  dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_attention_kernel<T><<<grid, THREADS, smem, stream>>>(
      reinterpret_cast<const T*>(q), reinterpret_cast<const T*>(k),
      reinterpret_cast<const T*>(v), reinterpret_cast<T*>(out), H, Hkv, D,
      scale, mk);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, Sq, H, D], k / v [B, Sk, Hkv, D], out [B, Sq, H, D], all f32
// (is_bf16 = 0) or all bf16 (is_bf16 = 1); H % Hkv == 0, D <= 128; scale
// is D^-0.5 as the caller rounds it. Returns the launch's cudaError_t.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int Sq,
                                      int Sk, int H, int Hkv, int D,
                                      float scale, int causal, int window,
                                      int q_offset, int is_bf16,
                                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H, Hkv, D, scale,
                                 causal, window, q_offset, st);
  return launch<float>(q, k, v, out, B, Sq, Sk, H, Hkv, D, scale, causal,
                       window, q_offset, st);
}
