// Packed-MXFP4 dequant-matmul for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `mxfp4_matmul_kernel`
// (src/repro/kernels/mxfp4_matmul/kernel.py, `_kernel` / `_decode_tile`):
// y[M, N] = x[M, K] @ dequant(codes, exps), f32 accumulation, bf16 out.
// The weights stay packed in device memory, 4.25 bits per value: codes
// [K/2, N] u8 with two E2M1 nibbles per byte along K (even row in the low
// nibble), exps [K/32, N] u8 biased E8M0. They are expanded only in
// registers.
//
// What bounds it on the H100: at decode (M = lanes <= 4) memory. The
// packed weight is read once (w1 at starcoder2-7b width, 4608 x 18432, is
// 45.1 MB: 13.5 us at 3.35 TB/s), about 8 flops per weight byte. At
// prefill (M = 192) the f32 FMAs: sm_90 has no FP4 MMA and this kernel
// uses no tensor cores (a bf16 wgmma design is for a later change).
//
// Design:
// - A block of 8 warps owns BM rows x 128 columns; each lane owns 4
//   adjacent columns, so a warp reads 128 contiguous code bytes per packed
//   row and 4 exponent bytes per 32-row block, as 32-bit loads.
// - K goes in steps of 8 blocks of 32 rows; warp w takes block w of the
//   step. The step's activations sit in shared memory as f32 (bf16 or f32
//   in). The next step's activations and code words are loaded into
//   registers while this step computes. Per block a lane has 16 code words
//   and 1 exponent word; it decodes each nibble through a 16-entry table
//   of 2x the FP4 value (the integer arithmetic of `_decode_tile`), sums
//   x * code over the block in f32, and adds the block sum times the block
//   scale. The scale is a power of two, so scaling the block sum equals
//   scaling each product.
// - The scale is 0.5 * 2^(b-127) built in the IEEE exponent field, as
//   `_decode_tile` builds it, and 0 for b <= 1: the reference's platforms
//   flush that subnormal to zero, so this kernel gives what they give.
// - M is masked in the kernel (BM = 4 for M <= 4, else 8), never padded.
//   When the output tiles are too few to fill the card, K is split over
//   blockIdx.z into a f32 partial buffer, summed in split order by a
//   second pass (deterministic, no atomics). The warps of a block are
//   summed in warp order through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int COLS = 128;          // 32 lanes x 4 columns
constexpr int KSTEP = WARPS * 32;  // K rows per block step

__device__ __forceinline__ float half_scale(uint32_t b) {
  return b <= 1u ? 0.0f : 0.5f * __uint_as_float(b << 23);
}

__device__ __forceinline__ float load_x(const float* x, size_t i) {
  return x[i];
}

__device__ __forceinline__ float load_x(const __nv_bfloat16* x, size_t i) {
  return __bfloat162float(x[i]);
}

template <int BM, typename XT>
__global__ void __launch_bounds__(THREADS)
mxfp4_matmul_kernel(const XT* __restrict__ x,
                    const uint8_t* __restrict__ codes,
                    const uint8_t* __restrict__ exps,
                    __nv_bfloat16* __restrict__ out,
                    float* __restrict__ partial, int M, int K, int N,
                    int kb_per_split) {
  __shared__ __align__(16) float xs[BM][KSTEP];
  __shared__ __align__(16) float red[WARPS][BM][COLS];
  __shared__ float lut[16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * COLS;
  const int split = blockIdx.z;
  const int kb_begin = split * kb_per_split;
  const int kb_end = min(K / 32, kb_begin + kb_per_split);
  const int c = col0 + 4 * lane;  // this lane's first column
  const bool col_ok = c < N;      // N % 4 == 0: all four columns or none

  if (tid < 16) {  // 2x the E2M1 value of nibble tid, as `_decode_tile`
    const int s = (tid >> 3) & 1, e = (tid >> 1) & 3, m = tid & 1;
    const int v = e == 0 ? m : (2 + m) << (e - 1);
    lut[tid] = (float)(s ? -v : v);
  }
  float acc[BM][4];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.0f;

  // Registers hold the next step while this one computes: row r of the
  // activations at column tid (KSTEP == THREADS), and this warp's 16 code
  // words and exponent word of its next 32-row block.
  float xr[BM];
  uint32_t w[16], e4 = 0;
  auto fetch = [&](int kb0) {
    const int k0 = kb0 * 32, kn = min(KSTEP, (kb_end - kb0) * 32);
#pragma unroll
    for (int r = 0; r < BM; ++r)
      xr[r] = (m0 + r < M && tid < kn) ? load_x(x, (size_t)(m0 + r) * K + k0 + tid) : 0.0f;
    const int kb = kb0 + warp;
    if (kb < kb_end && col_ok) {
      const uint8_t* cp = codes + (size_t)kb * 16 * N + c;
#pragma unroll
      for (int r = 0; r < 16; ++r)
        w[r] = __ldg(reinterpret_cast<const uint32_t*>(cp + (size_t)r * N));
      e4 = __ldg(reinterpret_cast<const uint32_t*>(exps + (size_t)kb * N + c));
    }
  };
  if (kb_begin < kb_end) fetch(kb_begin);

  for (int kb0 = kb_begin; kb0 < kb_end; kb0 += WARPS) {
    __syncthreads();  // the previous step's reads of xs are done
#pragma unroll
    for (int r = 0; r < BM; ++r) xs[r][tid] = xr[r];
    uint32_t cw[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) cw[r] = w[r];
    const uint32_t ce4 = e4;
    __syncthreads();
    if (kb0 + WARPS < kb_end) fetch(kb0 + WARPS);  // in flight meanwhile
    const int kb = kb0 + warp;
    if (kb < kb_end && col_ok) {
      float part[BM][4];
#pragma unroll
      for (int m = 0; m < BM; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[m][j] = 0.0f;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        float x0[BM], x1[BM];
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const float2 xv =
              *reinterpret_cast<const float2*>(&xs[m][warp * 32 + 2 * r]);
          x0[m] = xv.x;
          x1[m] = xv.y;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t byte = (cw[r] >> (8 * j)) & 0xFFu;
          const float lo = lut[byte & 15u], hi = lut[byte >> 4];
#pragma unroll
          for (int m = 0; m < BM; ++m) {
            part[m][j] = fmaf(x0[m], lo, part[m][j]);
            part[m][j] = fmaf(x1[m], hi, part[m][j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float hs = half_scale((ce4 >> (8 * j)) & 0xFFu);
#pragma unroll
        for (int m = 0; m < BM; ++m) acc[m][j] = fmaf(part[m][j], hs, acc[m][j]);
      }
    }
  }

  // sum the warps' partials in warp order
#pragma unroll
  for (int m = 0; m < BM; ++m)
    *reinterpret_cast<float4*>(&red[warp][m][4 * lane]) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  for (int i = tid; i < BM * COLS; i += THREADS) {
    const int r = i / COLS, cc = i % COLS;
    float s = 0.0f;
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) s += red[wi][r][cc];
    const int row = m0 + r, col = col0 + cc;
    if (row < M && col < N) {
      if (gridDim.z == 1)
        out[(size_t)row * N + col] = __float2bfloat16_rn(s);
      else
        partial[((size_t)split * M + row) * N + col] = s;
    }
  }
}

__global__ void splitk_sum_kernel(const float* __restrict__ partial,
                                  __nv_bfloat16* __restrict__ out, int splits,
                                  size_t mn) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int z = 0; z < splits; ++z) s += partial[(size_t)z * mn + i];
    out[i] = __float2bfloat16_rn(s);
  }
}

template <int BM>
void launch_tile(const void* x, bool x_bf16, const uint8_t* codes,
                 const uint8_t* exps, __nv_bfloat16* out, float* partial,
                 int M, int K, int N, int splits, int kb_per_split,
                 cudaStream_t stream) {
  dim3 grid((M + BM - 1) / BM, (N + COLS - 1) / COLS, splits);
  if (x_bf16)
    mxfp4_matmul_kernel<BM, __nv_bfloat16><<<grid, THREADS, 0, stream>>>(
        reinterpret_cast<const __nv_bfloat16*>(x), codes, exps, out, partial,
        M, K, N, kb_per_split);
  else
    mxfp4_matmul_kernel<BM, float><<<grid, THREADS, 0, stream>>>(
        reinterpret_cast<const float*>(x), codes, exps, out, partial, M, K,
        N, kb_per_split);
}

}  // namespace

// x [M, K] bf16 (x_bf16 = 1) or f32; codes u8 [K/2, N]; exps u8 [K/32, N];
// out bf16 [M, N]; partial f32 [splits, M, N] (unused when splits == 1).
// K % 32 == 0, N % 4 == 0. Returns the launches' cudaError_t.
extern "C" int mxfp4_matmul_launch(const void* x, const uint8_t* codes,
                                   const uint8_t* exps, void* out,
                                   float* partial, int M, int K, int N,
                                   int splits, int x_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(out);
  const int nkb = K / 32;
  const int kb_per_split = (nkb + splits - 1) / splits;
  if (M <= 4)
    launch_tile<4>(x, x_bf16 != 0, codes, exps, o, partial, M, K, N, splits,
                   kb_per_split, st);
  else
    launch_tile<8>(x, x_bf16 != 0, codes, exps, o, partial, M, K, N, splits,
                   kb_per_split, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t mn = (size_t)M * N;
  const int blocks = (int)((mn + 255) / 256 < 1024 ? (mn + 255) / 256 : 1024);
  splitk_sum_kernel<<<blocks, 256, 0, st>>>(partial, o, splits, mn);
  return (int)cudaGetLastError();
}
