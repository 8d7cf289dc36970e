// Ragged paged flash-decode over quantized-resident MXFP4 KV pages, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `paged_flash_decode_mx`
// (src/repro/kernels/paged_attention/kernel.py, `_decode_kernel_mx`): one
// new query token per lane attends over its pool row's page. The page
// stays in the MXFP4 code domain in device memory (nibble-packed codes
// [P, W, 2Hkv, Dpad/2], K row exponents [P, W, Hkv, Dpad/32], V 32-slot
// block exponents [P, ceil(W/32), Hkv, Dh]) and is widened to bf16 only in
// registers, through the 256-entry pair table.
//
// What bounds it on the H100: at decode sizes, latency. It reads each
// live slot's codes and exponents about once (4.25 bits per K or V value),
// far below the card's ridge point, so the time is the chain of a chunk's
// loads, products and softmax, twice at W = 256.
//
// Design:
// - One block (4 warps) per (lane, KV head, group of `hg` query heads,
//   128-column half of head_dim): each query head has its own softmax
//   state and its own P quantization blocks, so splitting the heads over
//   blocks computes the same function (the wrapper picks hg; a block's
//   cost hardly depends on it, since its heads are the 16 rows of one mma
//   tile). A block's P V covers at most 128 columns of V (a 16 x 128 f32
//   accumulator a warp, 64 registers a lane); past Dh 128 (gemma3-1b's
//   256) the columns are split over CB = ceil(Dh / 128) blocks, each of
//   which computes the whole S and softmax (the same values, so the same
//   function) and its own half of P V.
// - The block walks its lane's valid length in bk-slot chunks,
//   bk = pick_bk(W). The tail chunk is fetched at the clamped offset
//   min(c*bk, W-bk), exactly as the Pallas kernel does, and the overlap is
//   masked. Warp w owns keys 32w..32w+31 of the chunk, which is exactly
//   one of P's 32-key quantization blocks (aligned to the fetched offset).
// - Products on the tensor cores, mma.sync m16n8k16 bf16 with f32 sums:
//   S = Q K^T with the group's heads as the 16 rows (zero past hg) and K as
//   B: lane t takes head_dim blocks t + 4 kb, kb < KB (32 values and one K
//   exponent each; KB = 1 up to dpad 128, 2 up to dpad 256; blocks past
//   dpad / 32, as the fourth at dpad 96, are zeros), so its K bytes of a
//   key are KB 16-byte loads and each byte is one bf16x2 B register (table
//   value times the block scale, exact in bf16). S's f32
//   accumulator fragment is P's A fragment for P V, as in FlashAttention-2;
//   V is B again, each register two keys at one head_dim column, from two
//   table values and a byte permute, times the two keys' 32-slot block
//   scales. The operands are exact in bf16 (q is MXFP4 fake-quant, K and V
//   decode exactly, P after fake-quant is rounded to bf16 as the plain
//   version does), so only the f32 sum order changes.
// - Per chunk, per head: scores times scale rounded to bf16, dead slots at
//   NEG_INF; the chunk max across the 4 warps (the one block barrier a
//   chunk); P = exp(s - m), fake-quantized to MXFP4 per warp (its 32-key
//   block: amax by quad shuffles); l and acc rescaled by exp(m_old - m) a
//   warp and a lane at a time, summed over the warps and lanes at the end.
// - Loads: each lane copies its own K code rows, V code runs and V block
//   exponents (each read once per 32-slot block) with cp.async into a
//   private 2-stage buffer, chunk c+1's issued before chunk c's products;
//   its K row exponents are plain loads issued as early. No barrier guards
//   the buffers: a lane reads only what it copied.
// - Epilogue divides by l (l == 0 -> 1); a lane of length 0 runs no chunk
//   and writes zeros.
// - Partial mode (a rank's block of a cache sequence cut over ranks,
//   combined over the ranks by flash-decoding): the epilogue writes a / l
//   in f32, before its bf16 rounding (the bf16 mode is that value
//   rounded, bitwise), and each head's lse = m + log(l) from its running
//   max and sum, -inf for a lane with no live slot.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int HMAX = 16;   // query heads a block: one mma tile's rows
constexpr int DCOLS = 128;  // V columns a block: 16 tiles of 8 columns
constexpr int DMAX = 256;   // head_dim (and dpad): KB = 2, two column halves
constexpr float NEG_INF = -1e30f;
constexpr int RED_BYTES = WARPS * HMAX * DCOLS * 4;  // the warps' acc, 32 KB

// a lane's cp.async items of one chunk, item-major so lanes are adjacent;
// KB = K blocks of 32 head_dim values a lane takes (1: dpad <= 128, 2:
// dpad <= 256)
template <int KB>
struct Smem {
  static constexpr int K_OFF = 0;                          // 4KB x 16 B K
  static constexpr int VE_OFF = K_OFF + 4 * KB * 16 * THREADS;  // 2 x 16 B
  static constexpr int V_OFF = VE_OFF + 2 * 16 * THREADS;  // 8 x 8 B V codes
  static constexpr int STAGE = V_OFF + 8 * 8 * THREADS;    // 20 / 28 KB
  static constexpr int MAIN = 2 * STAGE > RED_BYTES ? 2 * STAGE : RED_BYTES;
  // 42,816 bytes at KB 1; 59,200 at KB 2 (opted in past 48 KB)
  static constexpr int BYTES =
      MAIN + 256 * 4 + (2 * WARPS * HMAX + WARPS * HMAX + HMAX) * 4;
};

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

// bf16 bits of 2^(e-1), the scale of an int8 exponent e in [-127, 127]
// (subnormal for e <= -126, as the plain version's exp2i gives it)
__device__ __forceinline__ uint32_t scale_bits(int e) {
  const int f = e + 126;
  return f > 0 ? (uint32_t)f << 7 : 0x40u >> -f;
}

__device__ __forceinline__ uint32_t byte_of(uint32_t w, int k) {
  return __byte_perm(w, 0u, 0x4440u | (uint32_t)k);
}

__device__ __forceinline__ uint32_t bmul2(uint32_t a, uint32_t b) {
  const __nv_bfloat162 r =
      __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
              *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<const uint32_t*>(&r);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// max / sum over the 4 lanes of a quad (the lanes t = 0..3 of a row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// MXFP4 quantize-dequantize of a non-negative P value in a 32-key block
// whose largest value is amax (the reference's f32 fake_quant chain).
__device__ __forceinline__ float fake_quant(float p, float amax) {
  const int ebf = min(max((__float_as_int(amax) >> 23) & 0xFF, 2), 254);
  const float y = p * f32_from_field(256 - ebf);
  const int e = min(max((__float_as_int(y) >> 23) - 127, 0), 2);
  float qv = rintf(y * f32_from_field(128 - e)) * f32_from_field(126 + e);
  qv = fminf(qv, 6.0f);
  return qv * pow2_wide(ebf - 129);
}

template <int KB>
__global__ void __launch_bounds__(THREADS)
paged_decode_mx_kernel(const __nv_bfloat16* __restrict__ q,
                       const uint8_t* __restrict__ kv_codes,
                       const int8_t* __restrict__ k_exps,
                       const int8_t* __restrict__ v_exps,
                       const int* __restrict__ rows,
                       const int* __restrict__ lengths,
                       const uint32_t* __restrict__ table,
                       void* __restrict__ out, float* __restrict__ lse,
                       int W, int Hkv, int G, int Dh, int dpad, int nwb,
                       int bk, int hg, float scale) {
  using SM = Smem<KB>;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* stage = smem;  // 2 chunk stages, then the warps' acc
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem + SM::MAIN);
  float* red_max = reinterpret_cast<float*>(tab + 256);  // [2][WARPS][HMAX]
  float* red_l = red_max + 2 * WARPS * HMAX;             // [WARPS][HMAX]
  float* red_m = red_l + WARPS * HMAX;                   // [HMAX]

  const int CB = (Dh + DCOLS - 1) / DCOLS;  // column halves of head_dim
  const int li = blockIdx.x, h = blockIdx.y;
  const int h0 = (blockIdx.z / CB) * hg, cb = blockIdx.z % CB;
  const int c0 = DCOLS * cb;  // this block's first V column
  const int hcount = min(hg, G - h0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = rows[li];
  const int len = min(max(lengths[li], 0), W);
  const int hb = dpad / 2, nbd = dpad / 32;
  const size_t slot_stride = (size_t)2 * Hkv * hb;  // bytes per slot
  const int nchunks = (len + bk - 1) / bk;
  const bool d_ok = c0 + 16 * g < Dh;  // this lane's 16 V columns

  for (int i = tid; i < 256; i += THREADS) tab[i] = table[i];

  // q as the A operand: rows g, g + 8 are heads h0 + g, h0 + g + 8; lane
  // t's k slots of step s (block kb = s / 8, s8 = s % 8) are
  // d = 32(t + 4kb) + 4s8 + {0, 1} (a0, a1) and + {2, 3} (a2, a3)
  uint32_t qa[8 * KB][4];
  {
    const __nv_bfloat16* qb = q + ((size_t)(li * Hkv + h) * G + h0) * Dh;
#pragma unroll
    for (int s = 0; s < 8 * KB; ++s)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int head = g + 8 * (r & 1);
        const int d = 32 * (t + 4 * (s >> 3)) + 4 * (s & 7) + 2 * (r >> 1);
        qa[s][r] = head < hcount && d < Dh
                       ? *reinterpret_cast<const uint32_t*>(qb + head * Dh + d)
                       : 0u;
      }
  }

  // chunk c's copies into stage c % 2: K codes of keys 32w + 8i + g (head_dim
  // blocks t + 4kb), the V block exponents of the warp's first and last key
  // (d = c0 + 16g..16g+15), V codes of keys 32w + 16u + {2t, 2t+1, 2t+8,
  // 2t+9} (the same columns)
  auto issue = [&](int c) {
    const int offs = min(c * bk, W - bk);
    unsigned char* st = stage + (c & 1) * SM::STAGE;
    const uint8_t* base = kv_codes + ((size_t)row * W + offs) * slot_stride;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        const int j = 32 * warp + 8 * i + g, bt = t + 4 * kb;
        const bool ok = j < bk && bt < nbd;
        hopper::cp_async16(
            st + SM::K_OFF + ((i * KB + kb) * THREADS + tid) * 16,
            ok ? base + j * slot_stride + 2 * h * hb + 16 * bt : kv_codes, ok);
      }
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const int vb = min((offs + 32 * warp + 31 * b) / 32, nwb - 1);
      hopper::cp_async16(
          st + SM::VE_OFF + (b * THREADS + tid) * 16,
          d_ok ? v_exps + (((size_t)row * nwb + vb) * Hkv + h) * Dh + c0 +
                     16 * g
               : v_exps,
          d_ok);
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int j = 32 * warp + 16 * (e >> 2) + 8 * ((e >> 1) & 1) + 2 * t +
                    (e & 1);
      const bool ok = j < bk && d_ok;
      hopper::cp_async8(
          st + SM::V_OFF + (e * THREADS + tid) * 8,
          ok ? base + j * slot_stride + (2 * h + 1) * hb + c0 / 2 + 8 * g
             : kv_codes,
          ok);
    }
  };
  auto k_exp = [&](int c, int* ke) {
    const int offs = min(c * bk, W - bk);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        const int j = 32 * warp + 8 * i + g, bt = t + 4 * kb;
        ke[i * KB + kb] =
            j < bk && bt < nbd
                ? (int)k_exps[(((size_t)row * W + offs + j) * Hkv + h) * nbd +
                              bt]
                : 0;
      }
  };

  float acc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = 0.0f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;  // heads g, g + 8
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int ke[4 * KB], ke_next[4 * KB];
#pragma unroll
  for (int i = 0; i < 4 * KB; ++i) ke[i] = ke_next[i] = 0;
  if (nchunks > 0) {
    issue(0);
    k_exp(0, ke_next);
  }
  hopper::cp_async_commit();
  __syncthreads();  // tab

  for (int c = 0; c < nchunks; ++c) {
    const int offs = min(c * bk, W - bk);
    hopper::cp_async_wait<0>();
    const unsigned char* st = stage + (c & 1) * SM::STAGE;
    uint4 kc[4 * KB], ve[2];
    uint2 vc[8];
#pragma unroll
    for (int i = 0; i < 4 * KB; ++i)
      kc[i] = *reinterpret_cast<const uint4*>(st + SM::K_OFF + (i * THREADS + tid) * 16);
#pragma unroll
    for (int b = 0; b < 2; ++b)
      ve[b] = *reinterpret_cast<const uint4*>(st + SM::VE_OFF + (b * THREADS + tid) * 16);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      vc[e] = *reinterpret_cast<const uint2*>(st + SM::V_OFF + (e * THREADS + tid) * 8);
#pragma unroll
    for (int i = 0; i < 4 * KB; ++i) ke[i] = ke_next[i];
    if (c + 1 < nchunks) {  // in flight while this chunk computes
      issue(c + 1);
      k_exp(c + 1, ke_next);
    }
    hopper::cp_async_commit();

    // S = Q K^T: tile i holds keys 32w + 8i + (0..7); B register pair of
    // step s of block kb is bytes 2s, 2s + 1 of the lane's 16 K bytes of
    // that block times its scale
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int kb = 0; kb < KB; ++kb) {
        const uint4 k4 = kc[i * KB + kb];
        const uint32_t ks = scale_bits(ke[i * KB + kb]) * 0x10001u;
        const uint32_t words[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
        for (int s = 0; s < 8; ++s) {
          const uint32_t b0 =
              bmul2(tab[byte_of(words[s >> 1], (2 * s) & 3)], ks);
          const uint32_t b1 =
              bmul2(tab[byte_of(words[s >> 1], (2 * s + 1) & 3)], ks);
          hopper::mma_m16n8k16_bf16(sc[i], qa[8 * kb + s][0],
                                    qa[8 * kb + s][1], qa[8 * kb + s][2],
                                    qa[8 * kb + s][3], b0, b1,
                                    kb || s ? sc[i] : zero);
        }
      }
    // scores: times scale, rounded to bf16; dead slots NEG_INF. sc[i][e]
    // is head g, sc[i][2 + e] head g + 8, key 32w + 8i + 2t + e
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 32 * warp + 8 * i + 2 * t + e, pos = offs + j;
        const bool live = j < bk && pos >= c * bk && pos < len;
        sc[i][e] = live ? bf16_round(sc[i][e] * scale) : NEG_INF;
        sc[i][2 + e] = live ? bf16_round(sc[i][2 + e] * scale) : NEG_INF;
        mx0 = fmaxf(mx0, sc[i][e]);
        mx1 = fmaxf(mx1, sc[i][2 + e]);
      }
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    float* rm = red_max + (c & 1) * WARPS * HMAX;
    if (t == 0) {
      rm[warp * HMAX + g] = mx0;
      rm[warp * HMAX + g + 8] = mx1;
    }
    __syncthreads();
    float mn0 = m0, mn1 = m1;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      mn0 = fmaxf(mn0, rm[w * HMAX + g]);
      mn1 = fmaxf(mn1, rm[w * HMAX + g + 8]);
    }
    const float corr0 = expf(m0 - mn0), corr1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    // P = exp(s - m), fake-quantized per 32-key block (this warp's keys)
    float am0 = 0.0f, am1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = 32 * warp + 8 * i + 2 * t + e, pos = offs + j;
        const bool live = j < bk && pos >= c * bk && pos < len;
        sc[i][e] = live ? expf(sc[i][e] - mn0) : 0.0f;
        sc[i][2 + e] = live ? expf(sc[i][2 + e] - mn1) : 0.0f;
        am0 = fmaxf(am0, sc[i][e]);
        am1 = fmaxf(am1, sc[i][2 + e]);
      }
    am0 = quad_max(am0);
    am1 = quad_max(am1);
    float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[i][e] = fake_quant(sc[i][e], am0);
        sc[i][2 + e] = fake_quant(sc[i][2 + e], am1);
        rs0 += sc[i][e];
        rs1 += sc[i][2 + e];
      }
    l0 = l0 * corr0 + rs0;
    l1 = l1 * corr1 + rs1;

    // P V: acc rescaled, then += P (A, from the score fragment) x V (B).
    // vs[n] holds the V scales of column 16g + n in the warp's first
    // (low half) and second (high half) 32-slot block
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      acc[n][0] *= corr0;
      acc[n][1] *= corr0;
      acc[n][2] *= corr1;
      acc[n][3] *= corr1;
    }
    uint32_t vs[16];
    {
      const uint32_t e0[4] = {ve[0].x, ve[0].y, ve[0].z, ve[0].w};
      const uint32_t e1[4] = {ve[1].x, ve[1].y, ve[1].z, ve[1].w};
#pragma unroll
      for (int n = 0; n < 16; ++n)
        vs[n] = scale_bits((int8_t)byte_of(e0[n >> 2], n & 3)) |
                (scale_bits((int8_t)byte_of(e1[n >> 2], n & 3)) << 16);
    }
    const int blk0 = (offs + 32 * warp) / 32;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const uint32_t a0 = pack_bf16(sc[2 * u][0], sc[2 * u][1]);
      const uint32_t a1 = pack_bf16(sc[2 * u][2], sc[2 * u][3]);
      const uint32_t a2 = pack_bf16(sc[2 * u + 1][0], sc[2 * u + 1][1]);
      const uint32_t a3 = pack_bf16(sc[2 * u + 1][2], sc[2 * u + 1][3]);
      // keys 32w + 16u + 2t (+1) and + 8: the halves of vs[n] they take
      uint32_t sel[2];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int ka = offs + 32 * warp + 16 * u + 8 * p + 2 * t;
        const bool hia = ka / 32 != blk0, hib = (ka + 1) / 32 != blk0;
        sel[p] = (hia ? 0x32u : 0x10u) | ((hib ? 0x32u : 0x10u) << 8);
      }
      const uint2 va = vc[4 * u], vb = vc[4 * u + 1];
      const uint2 vcc = vc[4 * u + 2], vd = vc[4 * u + 3];
#pragma unroll
      for (int bi = 0; bi < 8; ++bi) {
        const uint32_t pa = tab[byte_of(bi < 4 ? va.x : va.y, bi & 3)];
        const uint32_t pb = tab[byte_of(bi < 4 ? vb.x : vb.y, bi & 3)];
        const uint32_t pc = tab[byte_of(bi < 4 ? vcc.x : vcc.y, bi & 3)];
        const uint32_t pd = tab[byte_of(bi < 4 ? vd.x : vd.y, bi & 3)];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int n = 2 * bi + hh;
          const uint32_t take = hh ? 0x7632u : 0x5410u;
          const uint32_t b0 = bmul2(__byte_perm(pa, pb, take),
                                    __byte_perm(vs[n], vs[n], sel[0]));
          const uint32_t b1 = bmul2(__byte_perm(pc, pd, take),
                                    __byte_perm(vs[n], vs[n], sel[1]));
          hopper::mma_m16n8k16_bf16(acc[n], a0, a1, a2, a3, b0, b1, acc[n]);
        }
      }
    }
  }
  hopper::cp_async_wait<0>();
  __syncthreads();  // the stages are free: they take the warps' acc

  // acc[n][0..1]: head g, d = c0 + 32t + n and c0 + 32t + 16 + n; [2..3]
  // head g + 8
  float* red = reinterpret_cast<float*>(stage);  // [WARPS][HMAX][DCOLS]
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    float* r0 = red + (warp * HMAX + g) * DCOLS + 32 * t + n;
    r0[0] = acc[n][0];
    r0[16] = acc[n][1];
    r0[8 * DCOLS] = acc[n][2];
    r0[8 * DCOLS + 16] = acc[n][3];
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (t == 0) {
    red_l[warp * HMAX + g] = l0;
    red_l[warp * HMAX + g + 8] = l1;
    if (warp == 0) {  // every warp holds the same running max
      red_m[g] = m0;
      red_m[g + 8] = m1;
    }
  }
  __syncthreads();
  const size_t o0 = ((size_t)(li * Hkv + h) * G + h0) * Dh + c0;
  const int ncol = min(DCOLS, Dh - c0);
  for (int i = tid; i < hcount * ncol; i += THREADS) {
    const int r = i / ncol, d = i % ncol;
    float a = 0.0f, l = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      a += red[(w * HMAX + r) * DCOLS + d];
      l += red_l[w * HMAX + r];
    }
    const float v = a / (l == 0.0f ? 1.0f : l);
    if (lse != nullptr)
      static_cast<float*>(out)[o0 + r * Dh + d] = v;
    else
      static_cast<__nv_bfloat16*>(out)[o0 + r * Dh + d] =
          __float2bfloat16_rn(v);
  }
  if (lse != nullptr && cb == 0 && tid < hcount) {  // one column half
    float l = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) l += red_l[w * HMAX + tid];
    lse[(size_t)(li * Hkv + h) * G + h0 + tid] =
        l == 0.0f ? -INFINITY : red_m[tid] + logf(l);
  }
}

template <int KB>
int launch(const void* q, const uint8_t* kv_codes, const int8_t* k_exps,
           const int8_t* v_exps, const int* rows, const int* lengths,
           const uint32_t* table, void* out, float* lse, int L, int W,
           int Hkv, int G, int Dh, int dpad, int nwb, int bk, int hg,
           float scale, cudaStream_t st) {
  constexpr int smem = Smem<KB>::BYTES;
  if (smem > 48 * 1024) {
    static hopper::DeviceSet opted;
    if (!opted.has_current()) {
      const cudaError_t e = cudaFuncSetAttribute(
          paged_decode_mx_kernel<KB>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      opted.add_current();
    }
  }
  dim3 grid(L, Hkv, (G + hg - 1) / hg * ((Dh + DCOLS - 1) / DCOLS));
  paged_decode_mx_kernel<KB><<<grid, THREADS, smem, st>>>(
      reinterpret_cast<const __nv_bfloat16*>(q), kv_codes, k_exps, v_exps,
      rows, lengths, table, out, lse, W, Hkv, G, Dh, dpad, nwb, bk, hg,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q bf16 [L, Hkv, G, Dh]; kv_codes u8 [P, W, 2Hkv, dpad/2]; k_exps i8
// [P, W, Hkv, dpad/32]; v_exps i8 [P, nwb, Hkv, Dh]; rows / lengths i32
// [L]; table u32 [256]; out bf16 [L, Hkv, G, Dh], or with lse (f32
// [L, Hkv, G], else null: the partial mode) out f32 [L, Hkv, G, Dh].
// Dh % 16 == 0,
// Dh <= dpad <= 256 (dpad a multiple of 32), 1 <= hg <= 16 query heads a
// block, bk <= min(128, W), kv_codes / v_exps 16-byte aligned. Grid: L x
// Hkv x ceil(G / hg) * ceil(Dh / 128). Returns the launch's cudaError_t.
extern "C" int paged_decode_mx_launch(
    const void* q, const uint8_t* kv_codes, const int8_t* k_exps,
    const int8_t* v_exps, const int* rows, const int* lengths,
    const uint32_t* table, void* out, float* lse, int L, int W, int Hkv,
    int G, int Dh, int dpad, int nwb, int bk, int hg, float scale,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (Dh > dpad || dpad > DMAX || dpad % 32 || Dh % 16)
    return (int)cudaErrorInvalidValue;
  if (dpad <= 128)
    return launch<1>(q, kv_codes, k_exps, v_exps, rows, lengths, table, out,
                     lse, L, W, Hkv, G, Dh, dpad, nwb, bk, hg, scale, st);
  return launch<2>(q, kv_codes, k_exps, v_exps, rows, lengths, table, out,
                   lse, L, W, Hkv, G, Dh, dpad, nwb, bk, hg, scale, st);
}
