// Analog CTT-CIM linear for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `cim_linear_kernel`
// (src/repro/kernels/cim_linear/kernel.py, `_kernel` / `_quantize_block`):
// per 32-block MXFP4 activation quantize fused in, exact integer block
// dots against resident int8 weight codes, linear-domain alignment of each
// block to the calibrated target exponent E_N under the CM-bit mirror
// window, the Row-Hist second pass, and the ADC (round half to even, clip)
// in the epilogue, times 2^E_N / 4. Bitwise its plain version
// (kernels/cim_linear/ref.py), which sums the aligned blocks in ascending
// order in f32.
//
// Layout. Weight codes and exponents are K-major: column n's K codes are
// contiguous at wc + n*K and its K/32 exponents at we + n*(K/32), the
// [K, N] views that core/mx.py::quantize_w returns (strides (1, K)). So a
// lane reads a block's 32 codes as two 16-byte loads and __dp4a takes 4
// consecutive K codes with no byte transpose.
//
// Why the sums can be split. A block's dot s is an exact integer
// (|s| <= 32*144). Its pass-1 term is s * min(2^t, 1) for t >= -CM, its
// pass-2 term s * 2^(t + CM) for -2CM <= t < -CM, t = E_X + E_W - E_N: in
// units of 2^-CM both are integers, s << shift with shift in [0, CM]. Summed
// in int32 they are exact in any order. The ordered f32 sum of the plain
// version never rounds while sum |term| < 2^24 units (every partial sum is
// then a representable multiple of 2^-CM), and then equals the integer sum
// times 2^-CM bit for bit, so the ADC sees the same c1 / c2.
// The float factors are matched exactly, extremes included: 2^(E_X - E_N)
// is 0 for E_X - E_N <= -150 and inf for >= 128 (pow2_wide), so those
// rows are mapped to a shift past every window (DEAD) before E_W is added.
//
// The guard (chosen: per row, from the activation codes). sum |term| <=
// 12 * 2^CM * sum_i |code_x,i| over the row (weight codes are at most 12).
// The wrapper passes guard = 1 only when K * 144 * 2^CM >= 2^24 (below that
// no row can reach 2^24; at CM = 3 only K >= 14564, starcoder2's w2). Then
// each block adds its rows' sum |code_x| into the workspace beside the
// sums, and the block that finishes a column tile gives every row whose
// bound reaches 2^24 the ordered f32 walk over all of K (today's
// arithmetic, on the card), in the same launch. The bound is a row
// property, known after the quantize with no extra pass; a per-pair bound
// would double the alignment work. Rows it flags are counted in
// guard_rows[0] (by the first column tile), never read by the wrapper.
//
// Route "splitk" (`cim_linear_splitk_launch`): M below ops.py::TC_MIN_M
// (decode: M = lanes) and narrow N. Bound by memory at decode: one byte a
// weight (w1 at starcoder2-7b width, 4608 x 18432 plus exponents, is
// 87.6 MB: 26 us at 3.35 TB/s).
// - A block of 8 warps owns BM rows (4, 8 or 16; M is masked, not padded)
//   x 256/WK columns and a range of K (blockIdx.z of `splits`); a lane owns
//   one column, and WK warps (4 for narrow N, else 1) share it over
//   interleaved 32-blocks of the range. ops.py::pick_splits splits K until
//   the grid holds about one wave of 3 blocks an SM.
// - K goes in chunks of up to CH 32-blocks: the warps quantize the chunk's
//   activations for the tile's rows into shared memory (amax by one redux,
//   shared exponent from the IEEE field, rintf ties-to-even), with each
//   (row, block)'s shift base; then each lane loads G blocks of its column
//   (2 x 16 B each) before it computes them, takes the block dots with
//   __dp4a and adds s << shift into int32 registers per (row, pass): no
//   shared-memory partials and no ordered phase.
// - Split K: the block's sums go to an int32 workspace with atomicAdd; the
//   last block of a column tile to arrive (an arrival counter) reads them
//   back with atomicExch (which zeroes them), so the workspace is zero
//   again at rest and the wrapper keeps one per device, never clears it and
//   never syncs. One launch per linear.
// - What holds it back (PERF.md): the loads. Each warp reads 32 columns
//   128 bytes at a time, so a column's run of K is fetched in pieces; a
//   warp reading one column's whole run at once loaded faster, but its
//   per-column warp reduction cost more than it saved.
//
// Route "wgmma" (`cim_linear_tc_launch`): M >= TC_MIN_M (prefill) with
// K % 64 == 0 and N > 1024. Bound by the alignment, which is ALU work: one
// (row, column, 32-block) triple per block dot, m*n*K/32 of them (0.51 G
// for w1 at M = 192); the block dots themselves are 41.7 G MACs a layer,
// far below the tensor cores' rate.
// - A pre-pass quantizes the activations once (f16 codes, exact, and
//   2^(E_X - E_N) a (row, block)), so the column tiles do not each redo it;
//   the wrapper counts the pair as one launch.
// - f16 wgmma with f32 accumulators instead of s8 with s32: the codes are
//   exact f16 values and every block dot is an integer below 2^24, so the
//   f32 fragment is the exact dot and is aligned in f32 as it stands. An
//   s32 fragment would need a conversion per element, on a quarter-rate
//   pipe, in the loop that sets the pace. The tensor cores run at half the
//   int8 rate, still far from the limit.
// - Each block walks all of K in order, so the aligned blocks are added
//   in f32 in ascending order exactly as the plain version adds them: no
//   integer sums, no guard, bitwise by construction.
// - E_N and adc_fs are read from the calibration's device scalars: no host
//   sync and no launch to gather them.
// - Built without fast-math / ftz: the two-factor 2^e construction
//   relies on exact subnormal powers of two.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int CH = 64;       // 32-blocks of K quantized at a time
constexpr int G = 4;         // blocks a lane loads before it computes them
constexpr int DEAD = 1024;   // a shift past both windows
constexpr float EXACT = 16777216.0f;  // 2^24: f32 sums of units stay exact

__device__ __forceinline__ float pow2_narrow(int e) {
  e = min(max(e, -126), 127);
  return __int_as_float((e + 127) << 23);
}

// 2^e for e in [-254, 252] as two exact factors (may be subnormal).
__device__ __forceinline__ float pow2_wide(int e) {
  int h1 = min(max(e >> 1, -126), 127);  // arithmetic shift: floor(e / 2)
  int h2 = min(max(e - h1, -126), 127);
  return __int_as_float((h1 + 127) << 23) * __int_as_float((h2 + 127) << 23);
}

// s << sh with PTX semantics: a shift of 32 or more (a negative sh read as
// unsigned) gives 0, which is how a term outside its window drops out.
__device__ __forceinline__ int shl_clamp(int s, int sh) {
  int r;
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(s), "r"(sh));
  return r;
}

__device__ __forceinline__ float adc(float c, float fs, int bits) {
  if (bits < 0) return c;
  float half = (float)(1 << (bits - 1));
  float delta = fs / half;
  float r = rintf(c / delta);
  r = r < -half ? -half : r;  // comparisons keep a NaN, like jnp.clip
  r = r > half - 1.0f ? half - 1.0f : r;
  return r * delta;
}

// The read-out of one (row, column): ADC of each pass times 2^E_N / 4 and
// 2^(E_N - CM) / 4, in the plain version's order (no contraction).
__device__ __forceinline__ float read_out(float c1, float c2, float fs,
                                          int bits, float sc1, float sc2,
                                          bool two) {
  float y = __fmul_rn(__fmul_rn(adc(c1, fs, bits), sc1), 0.25f);
  if (two) y = __fadd_rn(y, __fmul_rn(__fmul_rn(adc(c2, fs, bits), sc2), 0.25f));
  return y;
}

// MXFP4 code (2 * E2M1 value, in [-12, 12]) of this lane's element of a
// 32-block held one element a lane; `ex` gets the block's shared
// exponent. Bitwise core/mx.py::quantize.
__device__ __forceinline__ int quant_code(float xv, int& ex) {
  const unsigned amax =
      __reduce_max_sync(0xffffffffu, __float_as_uint(fabsf(xv)));
  ex = min(max((int)((amax >> 23) & 0xFF), 2), 254) - 129;
  const float y = xv * pow2_narrow(-ex);
  const float ay = fabsf(y);
  const int e = min(max((int)((__float_as_uint(ay) >> 23) & 0xFF) - 127, 0), 2);
  float q = rintf(ay * pow2_narrow(1 - e)) * pow2_narrow(e - 1);
  q = fminf(q, 6.0f);
  const int code = (int)(2.0f * q);
  return y < 0.0f ? -code : code;
}

// The row part of a block's pass-1 shift: t + CM = (E_X - E_N) + CM + E_W,
// with the float extremes of 2^(E_X - E_N) (0 and inf) mapped past the
// windows so that adding any int8 E_W keeps them there.
__device__ __forceinline__ int row_shift(int ex, int e_n, int cm) {
  const int a = ex - e_n;
  return a <= -150 ? -DEAD : (a >= 128 ? DEAD : a + cm);
}

__device__ __forceinline__ float load_x(const void* x, int x_bf16, size_t i) {
  return x_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[i])
                : reinterpret_cast<const float*>(x)[i];
}

struct Args {
  const void* x;          // [M, K] f32 or bf16
  const int8_t* wc;       // codes, K-major: column n at wc + n * K
  const int8_t* we;       // exponents, K-major: column n at we + n * nb
  const int* e_n;         // [] E_N, int32
  const float* fs;        // [] adc_fs, f32
  float* out;             // [M, N] f32
  int* ws;                // split-K workspace (zero at rest)
  int* guard_rows;        // rows that took the ordered walk (a statistic)
  int M, K, N, nb, kb_per_split, cm, adc_bits, x_bf16, guard;
  float lo, lo2, hi2;     // 2^-CM, 2^-2CM, 2^CM
};

// The ordered f32 walk of one row over all of K for this lane's column
// (col_live), the plain version's arithmetic: block dots in ascending
// order, each aligned in the linear domain and added to c1 / c2. Every
// thread of the block calls it (it quantizes with all warps).
template <bool TWO>
__device__ void ordered_row(const Args& a, int row, int n, bool col_live,
                            int e_n, float& c1, float& c2,
                            int8_t (*oc)[32], float* ou) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  c1 = c2 = 0.0f;
  for (int kb0 = 0; kb0 < a.nb; kb0 += WARPS) {
    const int kb = kb0 + warp;
    if (kb < a.nb) {
      int ex;
      const int code = quant_code(
          load_x(a.x, a.x_bf16, (size_t)row * a.K + (size_t)kb * 32 + lane), ex);
      oc[warp][lane] = (int8_t)code;
      if (lane == 0) ou[warp] = pow2_wide(ex - e_n);
    }
    __syncthreads();
    if (col_live) {
      const int nbk = min(WARPS, a.nb - kb0);
      for (int b = 0; b < nbk; ++b) {
        const int4* p = reinterpret_cast<const int4*>(
            a.wc + (size_t)n * a.K + (size_t)(kb0 + b) * 32);
        const int4 w0 = __ldg(p), w1 = __ldg(p + 1);
        const int4 x0 = *reinterpret_cast<const int4*>(&oc[b][0]);
        const int4 x1 = *reinterpret_cast<const int4*>(&oc[b][16]);
        int s = __dp4a(x0.x, w0.x, 0);
        s = __dp4a(x0.y, w0.y, s);
        s = __dp4a(x0.z, w0.z, s);
        s = __dp4a(x0.w, w0.w, s);
        s = __dp4a(x1.x, w1.x, s);
        s = __dp4a(x1.y, w1.y, s);
        s = __dp4a(x1.z, w1.z, s);
        s = __dp4a(x1.w, w1.w, s);
        const float uv =
            ou[b] * pow2_wide((int)a.we[(size_t)n * a.nb + kb0 + b]);
        const bool under1 = uv < a.lo;
        c1 += (float)s * (under1 ? 0.0f : fminf(uv, 1.0f));
        if (TWO) c2 += (float)s * ((under1 && uv >= a.lo2) ? uv * a.hi2 : 0.0f);
      }
    }
    __syncthreads();
  }
}

template <int BM, int WK, bool TWO>
__global__ void __launch_bounds__(THREADS)
cim_splitk_kernel(const Args a) {
  constexpr int WN = WARPS / WK;
  constexpr int COLS = 32 * WN;
  __shared__ __align__(16) int8_t xs[BM][CH * 32];  // activation codes
  __shared__ __align__(16) int sh_s[CH][BM];        // row shifts (t + CM - E_W)
  __shared__ __align__(16) int8_t oc[WARPS][32];    // ordered walk
  __shared__ float ou[WARPS];
  __shared__ int gsum[BM];                          // sum |code_x| a row
  __shared__ int guarded[BM];
  __shared__ int s_last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wn = warp % WN, wk = warp / WN;
  const int n = blockIdx.x * COLS + wn * 32 + lane;
  const bool live = n < a.N;
  const int row0 = blockIdx.y * BM;
  const int kb0 = blockIdx.z * a.kb_per_split;
  const int kb1 = min(a.nb, kb0 + a.kb_per_split);
  const int e_n = *a.e_n;
  const int cm = a.cm;
  if (tid < BM) gsum[tid] = 0;
  __syncthreads();

  int acc1[BM], acc2[BM];
#pragma unroll
  for (int m = 0; m < BM; ++m) acc1[m] = acc2[m] = 0;
  const int8_t* wcol = a.wc + (size_t)(live ? n : 0) * a.K;
  const int8_t* ecol = a.we + (size_t)(live ? n : 0) * a.nb;

  for (int c0 = kb0; c0 < kb1; c0 += CH) {
    const int nc = min(CH, kb1 - c0);
    // quantize: task t = (row t % BM, block t / BM), one warp a task; four
    // tasks' loads are issued before any is reduced
    const int ntask = BM * nc;
    for (int t0 = warp; t0 < ntask; t0 += 4 * WARPS) {
      float xv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = t0 + u * WARPS, row = row0 + t % BM;
        xv[u] = (t < ntask && row < a.M)
                    ? load_x(a.x, a.x_bf16,
                             (size_t)row * a.K + (size_t)(c0 + t / BM) * 32 + lane)
                    : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int t = t0 + u * WARPS;
        if (t < ntask) {
          const int m = t % BM, j = t / BM;
          int ex;
          const int code = quant_code(xv[u], ex);
          xs[m][j * 32 + lane] = (int8_t)code;
          if (lane == 0) sh_s[j][m] = row_shift(ex, e_n, cm);
          if (a.guard) {
            const int sa = __reduce_add_sync(0xffffffffu, abs(code));
            if (lane == 0) atomicAdd(&gsum[m], sa);
          }
        }
      }
    }
    __syncthreads();
    // this warp's blocks of the chunk: j = wk, wk + WK, ...; G at a time
    for (int j0 = wk; j0 < nc; j0 += WK * G) {
      int4 w[G][2];
      int ew[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int j = j0 + g * WK;
        if (live && j < nc) {
          const int4* p = reinterpret_cast<const int4*>(wcol + (size_t)(c0 + j) * 32);
          w[g][0] = __ldg(p);
          w[g][1] = __ldg(p + 1);
          ew[g] = ecol[c0 + j];
        } else {
          w[g][0] = w[g][1] = make_int4(0, 0, 0, 0);
          ew[g] = 0;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int j = j0 + g * WK;
        if (j < nc) {
          int shv[BM];
#pragma unroll
          for (int q = 0; q < BM / 4; ++q) {
            const int4 v = *reinterpret_cast<const int4*>(&sh_s[j][4 * q]);
            shv[4 * q] = v.x;
            shv[4 * q + 1] = v.y;
            shv[4 * q + 2] = v.z;
            shv[4 * q + 3] = v.w;
          }
#pragma unroll
          for (int m = 0; m < BM; ++m) {
            const int4 x0 = *reinterpret_cast<const int4*>(&xs[m][j * 32]);
            const int4 x1 = *reinterpret_cast<const int4*>(&xs[m][j * 32 + 16]);
            int s = __dp4a(x0.x, w[g][0].x, 0);
            s = __dp4a(x0.y, w[g][0].y, s);
            s = __dp4a(x0.z, w[g][0].z, s);
            s = __dp4a(x0.w, w[g][0].w, s);
            s = __dp4a(x1.x, w[g][1].x, s);
            s = __dp4a(x1.y, w[g][1].y, s);
            s = __dp4a(x1.z, w[g][1].z, s);
            s = __dp4a(x1.w, w[g][1].w, s);
            const int tp = shv[m] + ew[g];  // t + CM
            acc1[m] += shl_clamp(s, min(tp, cm));
            // pass 2: t + 2CM in [0, CM) <=> tp in [-CM, 0); tp >= 0 sets the
            // sign bit so the shift drops the term
            if (TWO) acc2[m] += shl_clamp(s, (tp + cm) | (~tp & (int)0x80000000));
          }
        }
      }
    }
    __syncthreads();
  }

  // the WK warps of a column add their sums (integers: any order), through
  // the activation-code buffer, free after the last chunk's barrier
  if (WK > 1) {
    static_assert((WK - 1) * 2 * COLS * 4 <= CH * 32, "reduction buffer");
    int* red = reinterpret_cast<int*>(&xs[0][0]);  // [WK-1][2][BM][COLS]
    const int c = wn * 32 + lane;
    if (wk > 0) {
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        red[(((wk - 1) * 2 + 0) * BM + m) * COLS + c] = acc1[m];
        red[(((wk - 1) * 2 + 1) * BM + m) * COLS + c] = acc2[m];
      }
    }
    __syncthreads();
    if (wk == 0) {
      for (int w2 = 0; w2 < WK - 1; ++w2) {
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          acc1[m] += red[((w2 * 2 + 0) * BM + m) * COLS + c];
          acc2[m] += red[((w2 * 2 + 1) * BM + m) * COLS + c];
        }
      }
    }
  }
  const bool owner = wk == 0 && live;

  if (gridDim.z > 1) {
    int* wacc = a.ws;                                // [2][M][N]
    int* wg = wacc + 2 * (size_t)a.M * a.N;          // [tiles_n][M]
    int* wcnt = wg + (size_t)gridDim.x * a.M;        // [tiles_m][tiles_n]
    if (owner) {
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        if (row0 + m < a.M) {
          const size_t i = (size_t)(row0 + m) * a.N + n;
          if (acc1[m]) atomicAdd(&wacc[i], acc1[m]);
          if (TWO && acc2[m]) atomicAdd(&wacc[(size_t)a.M * a.N + i], acc2[m]);
        }
      }
    }
    if (a.guard && tid < BM && row0 + tid < a.M && gsum[tid])
      atomicAdd(&wg[(size_t)blockIdx.x * a.M + row0 + tid], gsum[tid]);
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int prev =
          atomicAdd(&wcnt[blockIdx.y * gridDim.x + blockIdx.x], 1);
      s_last = prev == (int)gridDim.z - 1;
    }
    __syncthreads();
    if (!s_last) return;
    __threadfence();
    if (owner) {
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        if (row0 + m < a.M) {
          const size_t i = (size_t)(row0 + m) * a.N + n;
          acc1[m] = atomicExch(&wacc[i], 0);
          if (TWO) acc2[m] = atomicExch(&wacc[(size_t)a.M * a.N + i], 0);
        }
      }
    }
    if (tid < BM)
      gsum[tid] = (a.guard && row0 + tid < a.M)
                      ? atomicExch(&wg[(size_t)blockIdx.x * a.M + row0 + tid], 0)
                      : 0;
    if (tid == 0) wcnt[blockIdx.y * gridDim.x + blockIdx.x] = 0;
  }
  if (tid < BM)
    guarded[tid] = a.guard && row0 + tid < a.M &&
                   ldexpf(12.0f * (float)gsum[tid], cm) >= EXACT;
  __syncthreads();

  const float fs = *a.fs;
  const float sc1 = pow2_wide(e_n), sc2 = pow2_wide(e_n - cm);
  const float unit = pow2_narrow(-cm);
#pragma unroll
  for (int m = 0; m < BM; ++m) {
    const int row = row0 + m;
    if (row >= a.M) break;
    float c1, c2;
    if (guarded[m]) {  // uniform over the block
      ordered_row<TWO>(a, row, n, owner, e_n, c1, c2, oc, ou);
      if (tid == 0 && blockIdx.x == 0) atomicAdd(a.guard_rows, 1);
    } else {
      c1 = (float)acc1[m] * unit;  // |sum| < 2^24: exact
      c2 = (float)acc2[m] * unit;
    }
    if (owner)
      a.out[(size_t)row * a.N + n] = read_out(c1, c2, fs, a.adc_bits, sc1, sc2, TWO);
  }
}

template <int BM, int WK>
int launch_splitk(const Args& a, int splits, int two, cudaStream_t st) {
  constexpr int COLS = 32 * (WARPS / WK);
  dim3 grid((a.N + COLS - 1) / COLS, (a.M + BM - 1) / BM, splits);
  if (two)
    cim_splitk_kernel<BM, WK, true><<<grid, THREADS, 0, st>>>(a);
  else
    cim_splitk_kernel<BM, WK, false><<<grid, THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <int BM>
int launch_bm(const Args& a, int wk, int splits, int two, cudaStream_t st) {
  return wk == 4 ? launch_splitk<BM, 4>(a, splits, two, st)
                 : launch_splitk<BM, 1>(a, splits, two, st);
}

// ---- route "wgmma": tensor-core block dots, ordered f32 alignment -------

namespace tc {

constexpr int BN = 64;        // output columns a block
constexpr int BK = 64;        // K a tile: two 32-blocks
constexpr int ROWS = 64;      // rows a block: one warpgroup
constexpr int TTHREADS = 128;
constexpr int STAGES = 4;     // cp.async ring depth
constexpr int A_BYTES = ROWS * BK * 2;  // activation codes, f16, swizzled
constexpr int R_BYTES = BN * BK;        // weight codes as loaded, int8
constexpr int U_BYTES = ROWS * 2 * 4;   // 2^(E_X - E_N) a (row, block)
constexpr int B_BYTES = BN * BK * 2;    // weight codes, f16, swizzled
constexpr int A_OFF = 0;
constexpr int R_OFF = A_OFF + STAGES * A_BYTES;
constexpr int U_OFF = R_OFF + STAGES * R_BYTES;
constexpr int B_OFF = U_OFF + STAGES * U_BYTES;  // 1024-aligned
constexpr int V_OFF = B_OFF + B_BYTES;           // 2^E_W [2][BN]
constexpr int SMEM = V_OFF + 2 * BN * 4 + 1024;  // + base alignment

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   hopper::smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

// The activation pre-pass: one warp a (row, 32-block) task; codes as f16
// (exact: integers up to 12) and 2^(E_X - E_N) a (row, block).
__global__ void __launch_bounds__(THREADS)
cim_quant_kernel(const void* __restrict__ x, int x_bf16,
                 const int* __restrict__ e_n_p,
                 __half* __restrict__ xq, float* __restrict__ xu,
                 int M, int K) {
  const int nb = K / 32, lane = threadIdx.x & 31;
  const int e_n = *e_n_p;
  for (int t = blockIdx.x * WARPS + (threadIdx.x >> 5); t < M * nb;
       t += gridDim.x * WARPS) {
    const int row = t / nb, kb = t % nb;
    const size_t i = (size_t)row * K + (size_t)kb * 32 + lane;
    int ex;
    const int code = quant_code(load_x(x, x_bf16, i), ex);
    xq[i] = __int2half_rn(code);
    if (lane == 0) xu[(size_t)row * nb + kb] = pow2_wide(ex - e_n);
  }
}

// A block is one warpgroup: 64 rows x 64 columns, K in 64-wide tiles
// through a STAGES-deep cp.async ring (activation codes, weight codes,
// 2^(E_X - E_N)). Each tile's weight codes are widened to f16 into the
// K-major swizzled B tile (with 2^E_W a column); each 32-block is two
// wgmma m64n64k16 with scale-d 0 on the first, so its f32 fragment is the
// block's exact dot (codes are exact f16 values, products <= 144, sums <=
// 4608: every partial sum an integer below 2^24). The fragment is then aligned in f32 and added to
// c1 / c2 in ascending block order: the plain version's arithmetic, with
// no guard needed.
template <bool TWO>
__global__ void __launch_bounds__(TTHREADS, 3)
cim_tc_kernel(const __half* __restrict__ xq,
              const float* __restrict__ xu, const int8_t* __restrict__ wc,
              const int8_t* __restrict__ we, const int* __restrict__ e_n_p,
              const float* __restrict__ fs_p, float* __restrict__ out, int M,
              int K, int N, int cm, int adc_bits, float lo, float lo2,
              float hi2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_addr = hopper::smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  float* v_s = reinterpret_cast<float*>(smem + V_OFF);  // [2][BN]

  const int tid = threadIdx.x, nb = K / 32, nkt = K / BK;
  const int m0 = blockIdx.x * ROWS, n0 = blockIdx.y * BN;

  auto load_tile = [&](int st, int kt) {
    unsigned char* a = smem + A_OFF + st * A_BYTES;
    unsigned char* r = smem + R_OFF + st * R_BYTES;
    unsigned char* u = smem + U_OFF + st * U_BYTES;
#pragma unroll
    for (int q = 0; q < ROWS * 8 / TTHREADS; ++q) {  // 8 chunks a row
      const int i = tid + q * TTHREADS, row = i >> 3, ch = i & 7;
      const bool ok = m0 + row < M;
      hopper::cp_async16(a + hopper::swz128(row, ch),
                         ok ? xq + (size_t)(m0 + row) * K + kt * BK + 8 * ch : xq,
                         ok);
    }
#pragma unroll
    for (int q = 0; q < BN * 4 / TTHREADS; ++q) {  // 4 chunks a column
      const int i = tid + q * TTHREADS, c = i >> 2, ch = i & 3;
      const bool ok = n0 + c < N;
      hopper::cp_async16(r + c * BK + 16 * ch,
                         ok ? wc + (size_t)(n0 + c) * K + kt * BK + 16 * ch : wc,
                         ok);
    }
    if (tid < ROWS) {
      const bool ok = m0 + tid < M;
      cp_async8(u + tid * 8, ok ? xu + (size_t)(m0 + tid) * nb + 2 * kt : xu, ok);
    }
  };

  // weight codes of stage st -> f16 B tile; 2^E_W of its two blocks. A code
  // byte v, xor 0x80, under the f16 exponent byte 0x64 is 1024 + 128 + v
  // exactly; one f16x2 subtraction of 1152 leaves v (two codes a word).
  auto widen_tile = [&](int st, int kt) {
    const unsigned char* r = smem + R_OFF + st * R_BYTES;
    unsigned char* bt = smem + B_OFF;
    const int c = tid >> 1, h = tid & 1;  // column, 32-block of the tile
    const int4 v0 = *reinterpret_cast<const int4*>(r + c * BK + 32 * h);
    const int4 v1 = *reinterpret_cast<const int4*>(r + c * BK + 32 * h + 16);
    const int wv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
    const __half2 bias = __half2half2(__ushort_as_half(0x6480));  // 1152
#pragma unroll
    for (int q = 0; q < 4; ++q) {  // 8 codes -> one 16-byte chunk
      uint32_t p[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t word = (uint32_t)wv[2 * q + e] ^ 0x80808080u;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const uint32_t pair =
              __byte_perm(word, 0x64646464u, hh ? 0x7362 : 0x5140);
          const __half2 v = __hsub2(*reinterpret_cast<const __half2*>(&pair), bias);
          p[2 * e + hh] = *reinterpret_cast<const uint32_t*>(&v);
        }
      }
      *reinterpret_cast<uint4*>(bt + hopper::swz128(c, 4 * h + q)) =
          make_uint4(p[0], p[1], p[2], p[3]);
    }
    v_s[h * BN + c] = n0 + c < N
                          ? pow2_wide((int)we[(size_t)(n0 + c) * nb + 2 * kt + h])
                          : 0.0f;
  };

  float c1[32], c2[32], f[2][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) c1[i] = c2[i] = 0.0f;
  const int wl = tid >> 5, lane = tid & 31;
  const int ra = 16 * wl + (lane >> 2);  // fragment rows ra, ra + 8

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nkt) load_tile(st, st);
    hopper::cp_async_commit();
  }
  for (int it = 0; it < nkt; ++it) {
    const int st = it % STAGES;
    hopper::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile it landed; iteration it - 1 is done with its smem
    if (it + STAGES - 1 < nkt) load_tile((it + STAGES - 1) % STAGES, it + STAGES - 1);
    hopper::cp_async_commit();
    widen_tile(st, it);
    hopper::fence_proxy_async();
    __syncthreads();
    const uint32_t a = hopper::smem_addr(smem + A_OFF + st * A_BYTES);
    const uint32_t bb = hopper::smem_addr(smem + B_OFF);
    hopper::wgmma_fence();
#pragma unroll
    for (int b = 0; b < 2; ++b) {
#pragma unroll
      for (int k = 0; k < 2; ++k)
        hopper::wgmma_ss_m64n64k16_f16(f[b], hopper::desc128(a + 32 * (2 * b + k)),
                                       hopper::desc128(bb + 32 * (2 * b + k)), k);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait0();
    // align in ascending block order, each element's own f32 chain
    const float* u = reinterpret_cast<const float*>(smem + U_OFF + st * U_BYTES);
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      const float ur[2] = {u[ra * 2 + b], u[(ra + 8) * 2 + b]};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float2 vv = *reinterpret_cast<const float2*>(
            &v_s[b * BN + 8 * j + 2 * (lane & 3)]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int idx = 4 * j + e;
          const float s = f[b][idx];
          const float uv = ur[e >> 1] * ((e & 1) ? vv.y : vv.x);
          const bool under1 = uv < lo;
          c1[idx] = fmaf(s, under1 ? 0.0f : fminf(uv, 1.0f), c1[idx]);
          if (TWO)
            c2[idx] = fmaf(s, (under1 && uv >= lo2) ? uv * hi2 : 0.0f, c2[idx]);
        }
      }
    }
  }

  const int e_n = *e_n_p;
  const float fs = *fs_p;
  const float sc1 = pow2_wide(e_n), sc2 = pow2_wide(e_n - cm);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = m0 + ra + 8 * (e >> 1);
      const int col = n0 + 8 * j + 2 * (lane & 3) + (e & 1);
      if (row < M && col < N)
        out[(size_t)row * N + col] =
            read_out(c1[4 * j + e], c2[4 * j + e], fs, adc_bits, sc1, sc2, TWO);
    }
  }
}

}  // namespace tc

}  // namespace

// Route "splitk". x [M, K] f32 (x_bf16 = 0) or bf16 (x_bf16 = 1),
// row-major; wc / we K-major codes / exponents (column n at wc + n*K, we +
// n*(K/32)), 16-byte aligned; e_n int32 [] and fs f32 [] (E_N, adc_fs:
// read on the card, no host sync); out f32 [M, N]; ws int32 workspace of
// 2*M*N + tn*M + tm*tn zeros when splits > 1 (tn = ceil(N / (256/wk)),
// tm = ceil(M / bm); zero again when the launch ends); guard_rows int32
// [1]. K % 32 == 0, bm in {4, 8, 16}, wk in {1, 4}, every split owns
// ceil(K/32 / splits) blocks and none is empty; adc_bits < 0 disables the
// ADC; guard = 1 when K * 144 * 2^cm >= 2^24. Returns the launch's
// cudaError_t.
extern "C" int cim_linear_splitk_launch(
    const void* x, int x_bf16, const int8_t* wc, const int8_t* we,
    const int* e_n, const float* fs, float* out, int* ws, int* guard_rows,
    int M, int K, int N, int bm, int wk, int splits, int cm, int adc_bits,
    int two_pass, int guard, void* stream) {
  Args a;
  a.x = x; a.wc = wc; a.we = we; a.e_n = e_n; a.fs = fs; a.out = out;
  a.ws = ws; a.guard_rows = guard_rows;
  a.M = M; a.K = K; a.N = N; a.nb = K / 32;
  a.kb_per_split = (a.nb + splits - 1) / splits;
  a.cm = cm; a.adc_bits = adc_bits; a.x_bf16 = x_bf16; a.guard = guard;
  a.lo = ldexpf(1.0f, -cm); a.lo2 = ldexpf(1.0f, -2 * cm);
  a.hi2 = ldexpf(1.0f, cm);
  cudaStream_t st = (cudaStream_t)stream;
  if (bm == 4) return launch_bm<4>(a, wk, splits, two_pass, st);
  if (bm == 8) return launch_bm<8>(a, wk, splits, two_pass, st);
  return launch_bm<16>(a, wk, splits, two_pass, st);
}

// Route "wgmma". x [M, K] f32 / bf16 as for "splitk"; wc / we K-major;
// e_n / fs device scalars; out f32 [M, N]; xq f16 [M, K] and xu f32
// [M, K/32] scratch. K % 64 == 0. Two launches: the activation pre-pass,
// then the tensor-core kernel. Returns the first failing launch's
// cudaError_t.
extern "C" int cim_linear_tc_launch(
    const void* x, int x_bf16, const int8_t* wc, const int8_t* we,
    const int* e_n, const float* fs, float* out, void* xq, float* xu, int M,
    int K, int N, int cm, int adc_bits, int two_pass, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  static bool attr_set = false;
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        tc::cim_tc_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        tc::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(tc::cim_tc_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 tc::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  __half* q = reinterpret_cast<__half*>(xq);
  const int tasks = M * (K / 32);
  tc::cim_quant_kernel<<<min((tasks + WARPS - 1) / WARPS, 8 * 132), THREADS, 0,
                         st>>>(x, x_bf16, e_n, q, xu, M, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float lo = ldexpf(1.0f, -cm), lo2 = ldexpf(1.0f, -2 * cm),
              hi2 = ldexpf(1.0f, cm);
  dim3 grid((M + tc::ROWS - 1) / tc::ROWS, (N + tc::BN - 1) / tc::BN);
  if (two_pass)
    tc::cim_tc_kernel<true><<<grid, tc::TTHREADS, tc::SMEM, st>>>(
        q, xu, wc, we, e_n, fs, out, M, K, N, cm, adc_bits, lo, lo2, hi2);
  else
    tc::cim_tc_kernel<false><<<grid, tc::TTHREADS, tc::SMEM, st>>>(
        q, xu, wc, we, e_n, fs, out, M, K, N, cm, adc_bits, lo, lo2, hi2);
  return (int)cudaGetLastError();
}
