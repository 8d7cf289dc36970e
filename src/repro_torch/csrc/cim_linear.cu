// Analog CTT-CIM linear for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `cim_linear_kernel`
// (src/repro/kernels/cim_linear/kernel.py, `_kernel` / `_quantize_block`):
// per 32-block MXFP4 activation quantize fused in, exact integer block
// dots against resident int8 weight codes, linear-domain alignment of each
// block to the calibrated target exponent E_N under the CM-bit mirror
// window, the Row-Hist second pass, and the ADC (round half to even, clip)
// in the epilogue, times 2^E_N / 4.
//
// What bounds it on the H100: at decode (M = lanes) the weight codes are
// read once, about one byte per weight, so it is memory bound (w1 at
// starcoder2-7b width, 4608 x 18432 plus exponents, is 87.6 MB: 26 us at
// 3.35 TB/s). At prefill (M = prompt length) it does M int8 MACs per
// weight byte plus a float alignment step per (row, column, block).
//
// Design:
// - One block owns a tile of BM rows x 128 columns and walks K in
//   ascending 32-block order. There is no split-K: every (row, column)
//   keeps one running f32 sum per pass, added in block order, which is the
//   order of the reference's scan, so the result is bitwise the reference.
// - K goes in chunks of 8 blocks. Warp w quantizes block w of the chunk
//   for the tile's rows into shared memory (amax by warp shuffle, shared
//   exponent from the IEEE field, rintf ties-to-even), then computes that
//   block's exact int32 partials for its 128 columns with __dp4a: each
//   lane loads 4 adjacent columns per K row (128 contiguous bytes per warp
//   per row) and transposes 4x4 byte tiles with __byte_perm. The integer
//   part of the work is spread over 8 warps; only the cheap float
//   alignment runs in block order.
// - The partials go through shared memory to the ordered float phase,
//   where each thread owns 4 (row, column) pairs of the tile.
// - (E_N, adc_fs) are read from a 2-float device buffer: no host sync.
// - Built without fast-math / ftz: the two-factor 2^e construction
//   relies on exact subnormal powers of two.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 8;        // rows per tile (the wrapper pads M to it)
constexpr int WARPS = 8;     // = 32-blocks per K chunk
constexpr int THREADS = WARPS * 32;
constexpr int COLS = 128;    // columns per tile: 32 lanes x 4
constexpr int PAIRS = BM * COLS / THREADS;

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
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

__global__ void __launch_bounds__(THREADS)
cim_linear_kernel(const float* __restrict__ x, const int8_t* __restrict__ wc,
                  const int8_t* __restrict__ we, const float* __restrict__ cal,
                  float* __restrict__ out, int M, int K, int N, float lo,
                  float lo2, float hi2, int cm, int adc_bits, int two_pass) {
  __shared__ __align__(16) int8_t xc_s[BM][WARPS * 32];  // activation codes
  __shared__ float u_s[BM][WARPS];                        // 2^(E_X - E_N)
  __shared__ int8_t ew_s[WARPS][COLS];                    // weight exponents
  __shared__ __align__(16) int s_s[WARPS][BM][COLS];      // block partials

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * COLS;
  const int e_n = (int)cal[0];
  const float fs = cal[1];
  const int nb = K / 32;

  float c1[PAIRS], c2[PAIRS];
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) c1[p] = c2[p] = 0.0f;
  const int my_col = tid % COLS;      // ordered phase: column of the tile
  const int my_row = tid / COLS;      // ... rows my_row + p * (THREADS/COLS)

  for (int kb0 = 0; kb0 < nb; kb0 += WARPS) {
    const int kb = kb0 + warp;
    const int nblk = min(WARPS, nb - kb0);
    if (kb < nb) {
      // quantize this warp's 32-block for every row of the tile (the row
      // loads are issued together, then reduced)
      float xr[BM];
#pragma unroll
      for (int m = 0; m < BM; ++m)
        xr[m] = x[(size_t)(row0 + m) * K + (size_t)kb * 32 + lane];
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const float xv = xr[m];
        float amax = warp_max(fabsf(xv));
        int ex = ((__float_as_int(amax) >> 23) & 0xFF) - 127 - 2;
        ex = min(max(ex, -127), 127);
        float y = xv * pow2_narrow(-ex);
        float ay = fabsf(y);
        int e = ((__float_as_int(ay) >> 23) & 0xFF) - 127;
        e = min(max(e, 0), 2);
        float q = rintf(ay * pow2_narrow(1 - e)) * pow2_narrow(e - 1);
        q = fminf(q, 6.0f);
        int code = (int)(2.0f * q);
        xc_s[m][warp * 32 + lane] = (int8_t)(y < 0.0f ? -code : code);
        if (lane == 0) u_s[m][warp] = pow2_wide(ex - e_n);
      }
      const int col = col0 + lane * 4;
      char4 ew = make_char4(0, 0, 0, 0);
      if (col < N) ew = *reinterpret_cast<const char4*>(we + (size_t)kb * N + col);
      ew_s[warp][lane * 4 + 0] = ew.x;
      ew_s[warp][lane * 4 + 1] = ew.y;
      ew_s[warp][lane * 4 + 2] = ew.z;
      ew_s[warp][lane * 4 + 3] = ew.w;
    }
    __syncthreads();
    if (kb < nb) {
      // exact int32 partials of block kb for 4 adjacent columns per lane
      const int col = col0 + lane * 4;
      int r[32];
#pragma unroll
      for (int i = 0; i < 32; ++i)
        r[i] = col < N ? __ldg(reinterpret_cast<const int*>(
                             wc + ((size_t)kb * 32 + i) * N + col))
                       : 0;
      int wv[4][8];  // wv[j][g]: column j, K rows 4g..4g+3 packed
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        int t0 = __byte_perm(r[4 * g], r[4 * g + 1], 0x5140);
        int t1 = __byte_perm(r[4 * g + 2], r[4 * g + 3], 0x5140);
        int t2 = __byte_perm(r[4 * g], r[4 * g + 1], 0x7362);
        int t3 = __byte_perm(r[4 * g + 2], r[4 * g + 3], 0x7362);
        wv[0][g] = __byte_perm(t0, t1, 0x5410);
        wv[1][g] = __byte_perm(t0, t1, 0x7632);
        wv[2][g] = __byte_perm(t2, t3, 0x5410);
        wv[3][g] = __byte_perm(t2, t3, 0x7632);
      }
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const int* xw = reinterpret_cast<const int*>(&xc_s[m][warp * 32]);
        int s[4] = {0, 0, 0, 0};
#pragma unroll
        for (int g = 0; g < 8; ++g) {
          int xg = xw[g];
#pragma unroll
          for (int j = 0; j < 4; ++j) s[j] = __dp4a(xg, wv[j][g], s[j]);
        }
        *reinterpret_cast<int4*>(&s_s[warp][m][lane * 4]) =
            make_int4(s[0], s[1], s[2], s[3]);
      }
    }
    __syncthreads();
    // ordered float phase: blocks kb0 .. kb0 + nblk - 1, ascending
#pragma unroll
    for (int p = 0; p < PAIRS; ++p) {
      const int m = my_row + p * (THREADS / COLS);
      for (int b = 0; b < nblk; ++b) {
        float s = (float)s_s[b][m][my_col];
        float uv = u_s[m][b] * pow2_wide((int)ew_s[b][my_col]);
        bool under1 = uv < lo;
        c1[p] += s * (under1 ? 0.0f : fminf(uv, 1.0f));
        if (two_pass) c2[p] += s * ((under1 && uv >= lo2) ? uv * hi2 : 0.0f);
      }
    }
    __syncthreads();
  }

  const int col = col0 + my_col;
  if (col >= N) return;
  const float sc1 = pow2_wide(e_n), sc2 = pow2_wide(e_n - cm);
#pragma unroll
  for (int p = 0; p < PAIRS; ++p) {
    const int m = my_row + p * (THREADS / COLS);
    float y = adc(c1[p], fs, adc_bits) * sc1 * 0.25f;
    if (two_pass) y = y + adc(c2[p], fs, adc_bits) * sc2 * 0.25f;
    out[(size_t)(row0 + m) * N + col] = y;
  }
}

}  // namespace

// x f32 [M, K] (M % 8 == 0, K % 32 == 0), wc int8 [K, N], we int8
// [K/32, N] (N % 4 == 0), cal f32 [2] = (E_N, adc_fs), out f32 [M, N].
// adc_bits < 0 disables the ADC. Returns the launch's cudaError_t.
extern "C" int cim_linear_launch(const float* x, const int8_t* wc,
                                 const int8_t* we, const float* cal,
                                 float* out, int M, int K, int N, float lo,
                                 float lo2, float hi2, int cm, int adc_bits,
                                 int two_pass, void* stream) {
  dim3 grid(M / BM, (N + COLS - 1) / COLS);
  cim_linear_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, wc, we, cal, out, M, K, N, lo, lo2, hi2, cm, adc_bits, two_pass);
  return (int)cudaGetLastError();
}
