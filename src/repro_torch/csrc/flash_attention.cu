// Tiled online-softmax attention (FlashAttention-style) for Hopper
// (sm_90a), two routes.
//
// Replaces the Pallas TPU kernel `flash_attention_kernel`
// (src/repro/kernels/flash_attention/kernel.py, `_kernel`): per query row,
// softmax(q k^T * D^-0.5) v over the keys its masks allow, with a running
// max and sum and the division deferred to the end. GQA maps query head h
// to KV head h / (H / Hkv), causal and sliding-window masks are relative
// to q_offset (the absolute position of q[0]), and a row with no key left
// divides by 1 and yields zeros. Layout [B, S, H, D] is read in place (no
// transpose). Tiles that the causal or window mask hides from every row of
// a block are skipped (`kernel.py:69-75`); skipping such a tile changes
// nothing. Ragged tails of Sq and Sk are masked in the kernel, where the
// Pallas wrapper shrinks its tiles to divisors: the same result. The
// wrapper picks the route from dtype and D alone
// (kernels/flash_attention/ops.py::pick_route).
//
// What bounds it on the H100: operations. It does 4 * Sq * Sk * D flops
// per head (about half with a causal mask) against 2 * (Sq + 2 Sk) * D
// bytes. At the prefill shape (B=1, S=2048, H=36, Hkv=4, D=128, causal,
// bf16) that is 38.7 GFLOP: 0.039 ms at 989 TFLOP/s bf16, 0.58 ms at the
// 67 TFLOP/s of f32 FMAs; the bytes take 0.009 ms.
//
// Route "fma" (`flash_attention_launch`): f32 q/k/v (rounding them would
// change the function), bf16 with another D; all arithmetic f32 on the
// CUDA cores.
// - A block owns 64 query rows of one (batch, head) and walks the keys in
//   tiles of 64. Q, K and V tiles sit in shared memory in their input type
//   with a row stride of D + 2 elements (bank-conflict free per-key and
//   per-row reads) and are widened to f32 as they are read.
// - Scores: each thread computes a 4-row x 8-key register tile. Softmax:
//   one warp per 16 rows, max and sum by shuffle. PV: each thread keeps an
//   8-row x 8-column f32 accumulator in registers, rescaled per tile.
//
// Route "wgmma" (`flash_attention_tc_launch`): bf16 q/k/v with D in
// {64, 128}; both products on the bf16 tensor cores, f32 accumulators.
// The fma route takes 3.0-3.4 ms at the prefill shape, 77-86x its bound:
// f32 FMAs, element-wise synchronous loads, four barriers a tile and the
// softmax through shared memory. This route takes 0.126-0.128 ms there,
// 3.3x its bound; SDPA with is_causal takes 0.087 ms (chip_smoke.py on an
// NVIDIA H100 80GB HBM3 at 700 W; PERF.md has every shape). What holds it
// back is the softmax path: alone it takes 0.100 ms, and leaving out both
// wgmma products saves 2% (scripts/torch_flash_ablation.py).
// - A block owns 128 query rows of one (batch, head): two warpgroups of
//   64 rows, wgmma's M. Blocks are numbered so that the q tiles with the
//   most causal keys start first. Q is loaded once into shared memory;
//   K and V tiles of BK = 128 keys go through a 2-stage ring of 16-byte
//   cp.async copies, the next tile in flight while this one computes, one
//   block barrier a tile. Keys past Sk are
//   zero-filled and masked. Every tile is stored as D/64 tiles of 128-byte
//   swizzled rows (hopper::swz128): row = query or key, 64 values of D.
// - S = Q K^T: wgmma m64n128k16, A = Q and B = K from shared memory, both
//   K-major (D, the reduction, is contiguous). bf16 x bf16 products are
//   exact in f32, so S is the reference's f32 dot up to sum order.
// - Online softmax in registers, on the accumulator fragment: a thread
//   holds two rows of its warp's 16; row max and sum over the 4 threads
//   of a quad by shuffle. S is scaled in f32 by D^-0.5 * log2(e) and
//   exponentiated with ex2, the reference's exp(s - m) with the scale
//   folded in; masked scores are -inf and give p = 0 exactly. The running
//   sum l adds the unrounded f32 p, as the reference does.
// - O += P V: wgmma m64nDk16 with A = P from registers: each k16 slice of
//   the S fragment, rounded pairwise to bf16, is exactly the A fragment,
//   with no shuffles. B = V from shared memory, MN-major (keys, the
//   reduction, run down the rows), read with imm-trans-b = 1 from the same
//   swizzled layout as K: the stride between its 64-column tiles is the
//   descriptor's leading byte offset. O is rescaled by exp(m_prev - m_new)
//   before each PV. Rounding P to bf16 for the product is the one change
//   of numbers against the reference (relative 2^-9 a weight); the
//   output stays at 52-54 dB SQNR against the plain version, the level
//   of the bf16 output rounding, so one PV on bf16 P is kept.
// - Tried on the card and dropped: 64-key tiles (96 KB of shared memory),
//   0.133-0.134 ms at the prefill shape against 0.127-0.128 ms at 128
//   keys in the same call (chip_smoke.py's "flash_attention tile" line at
//   the time). Issuing P V of the previous tile with this tile's S and
//   running the softmax under it (a third V stage): 0.125 ms, within
//   noise (chip_smoke.py on that variant). No faster either: a 3-stage K
//   and V ring with a shorter softmax, and three warpgroups of 192 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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


// ---- route "wgmma": bf16 tensor cores --------------------------------------

namespace tc {

constexpr int BQ = 128;  // query rows a block: two warpgroups of 64
constexpr int THREADS = 256;
constexpr int BK = 128;  // keys a K / V tile
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int Q_BYTES = BQ * D * 2;  // D/64 swizzled tiles
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int K_OFF = Q_BYTES;          // 2 stages
  static constexpr int V_OFF = K_OFF + 2 * KV_BYTES;  // 2 stages
  static constexpr int BYTES = V_OFF + 2 * KV_BYTES + 1024;  // + alignment
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ROWS rows of D bf16 (row r at src + r * stride, rows >= nvalid
// zero-filled) -> D/64 swizzled tiles of ROWS x 128 bytes at dst.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(unsigned char* dst,
                                          const __nv_bfloat16* src,
                                          size_t stride, int nvalid,
                                          int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks a row
  static_assert(ROWS * CH % THREADS == 0, "whole chunks a thread");
#pragma unroll
  for (int t = 0; t < ROWS * CH / THREADS; ++t) {
    const int i = tid + t * THREADS, r = i / CH, c = i % CH;
    const bool ok = r < nvalid;
    hopper::cp_async16(dst + (c >> 3) * (ROWS * 128) + hopper::swz128(r, c & 7),
                       ok ? src + (size_t)r * stride + 8 * c : src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ out, int BH, int H,
                          int Hkv, float scale_log2, Masks mk) {
  using S = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned base: the swizzle pattern is taken on address bits
  const uint32_t raw_addr = hopper::smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t base = hopper::smem_addr(smem);

  const int nqt = (mk.Sq + BQ - 1) / BQ;
  const int qt = nqt - 1 - (int)blockIdx.x / BH;  // longest causal rows first
  const int bh = (int)blockIdx.x % BH, b = bh / H, h = bh % H;
  const int hk = h / (H / Hkv);
  const int q0 = qt * BQ;
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const size_t qrs = (size_t)H * D, krs = (size_t)Hkv * D;
  const __nv_bfloat16* qb = q + (((size_t)b * mk.Sq + q0) * H + h) * D;
  const __nv_bfloat16* kb = k + ((size_t)b * mk.Sk * Hkv + hk) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * mk.Sk * Hkv + hk) * D;

  // absolute positions of the block's first and last real query rows, and
  // the key tiles its masks leave visible to some row
  const int first_q = mk.q_offset + q0;
  const int last_q = mk.q_offset + min(q0 + BQ, mk.Sq) - 1;
  int kt_end = (mk.Sk + BK - 1) / BK, kt_begin = 0;
  if (mk.causal) kt_end = last_q < 0 ? 0 : min(kt_end, last_q / BK + 1);
  if (mk.window > 0 && first_q - mk.window + 1 > 0)
    kt_begin = (first_q - mk.window + 1) / BK;
  const int n = max(0, kt_end - kt_begin);

  // this thread's rows (r and r + 8 of its warp's 16) and first column
  // pair in every 8-column group of a fragment
  const int row = wg * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
  const int col = 2 * (lane & 3);
  float o[D / 2], s[BK / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.0f, 0.0f};

  auto load_kv = [&](int st, int kt) {
    const int k0 = kt * BK;
    load_rows<D, BK>(smem + S::K_OFF + st * S::KV_BYTES,
                     kb + (size_t)k0 * krs, krs, mk.Sk - k0, tid);
    load_rows<D, BK>(smem + S::V_OFF + st * S::KV_BYTES,
                     vb + (size_t)k0 * krs, krs, mk.Sk - k0, tid);
  };
  if (n > 0) {
    load_rows<D, BQ>(smem, qb, qrs, mk.Sq - q0, tid);
    load_kv(0, kt_begin);
  }
  hopper::cp_async_commit();

  for (int it = 0; it < n; ++it) {
    const int st = it & 1, k0 = (kt_begin + it) * BK;
    hopper::cp_async_wait<0>();
    hopper::fence_proxy_async();
    __syncthreads();  // tile it has landed; every read of tile it - 1 done
    if (it + 1 < n) load_kv(st ^ 1, kt_begin + it + 1);
    hopper::cp_async_commit();

    // S = Q K^T over D in k16 slices (32 bytes of a 128-byte row)
    const uint32_t qa = base + wg * 64 * 128;
    const uint32_t ka = base + S::K_OFF + st * S::KV_BYTES;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint64_t da =
          hopper::desc128(qa + (kk >> 2) * (BQ * 128) + 32 * (kk & 3));
      const uint64_t db =
          hopper::desc128(ka + (kk >> 2) * (BK * 128) + 32 * (kk & 3));
      hopper::wgmma_ss_m64n128k16(s, da, db, kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait0();

    // online softmax on the fragment: s[4j + 2hh + e] is row row + 8hh,
    // key k0 + 8j + col + e
    const bool need_mask =
        k0 + BK > mk.Sk || (mk.causal && k0 + BK - 1 > first_q) ||
        (mk.window > 0 && k0 <= last_q - mk.window);
    if (need_mask) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int qp = first_q + row + 8 * hh;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kp = k0 + 8 * j + col + e;
            const bool ok = kp < mk.Sk && (!mk.causal || kp <= qp) &&
                            (mk.window <= 0 || kp > qp - mk.window);
            float& x = s[4 * j + 2 * hh + e];
            x = ok ? x * scale_log2 : -INFINITY;
          }
      }
    } else {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] *= scale_log2;
    }
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = m_run[hh];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
      mx = quad_max(mx);
      // a row with no visible key yet keeps m = -inf; subtract 0 then, so
      // every p and the correction are exactly 0
      const float mu = mx == -INFINITY ? 0.0f : mx;
      corr[hh] = ex2(m_run[hh] - mu);
      m_run[hh] = mx;
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * hh + e];
          x = ex2(x - mu);
          rs += x;
        }
      l_run[hh] = l_run[hh] * corr[hh] + rs;  // this thread's columns
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        o[4 * j + 2 * hh] *= corr[hh];
        o[4 * j + 2 * hh + 1] *= corr[hh];
      }
    // P as the A fragment of k16 slice kk: rows r / r + 8, keys
    // 16kk + col (+1) and 16kk + 8 + col (+1)
    uint32_t pa[BK / 4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[4 * kk + i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);

    // O += P V over the tile's keys in k16 slices (16 rows of V)
    const uint32_t va = base + S::V_OFF + st * S::KV_BYTES;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = hopper::desc128(va + kk * 16 * 128, BK * 128);
      if constexpr (D == 64)
        hopper::wgmma_rs_m64n64k16_tb(o, pa + 4 * kk, db);
      else
        hopper::wgmma_rs_m64n128k16_tb(o, pa + 4 * kk, db);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait0();
  }

  __nv_bfloat16* ob = out + (((size_t)b * mk.Sq + q0) * H + h) * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = row + 8 * hh;
    const float l = quad_sum(l_run[hh]);
    const float den = l == 0.0f ? 1.0f : l;
    if (q0 + r < mk.Sq) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)r * qrs + 8 * j + col) =
            __floats2bfloat162_rn(o[4 * j + 2 * hh] / den,
                                  o[4 * j + 2 * hh + 1] / den);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int Hkv, float scale, int causal, int window,
           int q_offset, cudaStream_t stream) {
  static bool attr_set = false;
  const int smem = Smem<D>::BYTES;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_tc_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  Masks mk{Sq, Sk, q_offset, window, causal != 0};
  const int grid = (Sq + BQ - 1) / BQ * B * H;
  if (grid == 0) return (int)cudaSuccess;
  flash_attention_tc_kernel<D><<<grid, THREADS, smem, stream>>>(
      reinterpret_cast<const __nv_bfloat16*>(q),
      reinterpret_cast<const __nv_bfloat16*>(k),
      reinterpret_cast<const __nv_bfloat16*>(v),
      reinterpret_cast<__nv_bfloat16*>(out), B * H, H, Hkv, scale * LOG2E, mk);
  return (int)cudaGetLastError();
}

}  // namespace tc

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

// The same in bf16 only, D in {64, 128}; q / k / v 16-byte aligned.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for another D).
extern "C" int flash_attention_tc_launch(const void* q, const void* k,
                                         const void* v, void* out, int B,
                                         int Sq, int Sk, int H, int Hkv, int D,
                                         float scale, int causal, int window,
                                         int q_offset, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (D == 128)
    return tc::launch<128>(q, k, v, out, B, Sq, Sk, H, Hkv, scale, causal,
                           window, q_offset, st);
  if (D == 64)
    return tc::launch<64>(q, k, v, out, B, Sq, Sk, H, Hkv, scale, causal,
                          window, q_offset, st);
  return (int)cudaErrorInvalidValue;
}
