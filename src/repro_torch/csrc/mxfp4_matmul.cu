// Packed-MXFP4 dequant-matmul for Hopper (sm_90a), three routes.
//
// Replaces the Pallas TPU kernel `mxfp4_matmul_kernel`
// (src/repro/kernels/mxfp4_matmul/kernel.py, `_kernel` / `_decode_tile`):
// y[M, N] = x[M, K] @ dequant(codes, exps), f32 accumulation, bf16 out.
// The weights stay packed in device memory, 4.25 bits per value: codes
// [K/2, N] u8 with two E2M1 nibbles per byte along K (even row in the low
// nibble), exps [K/32, N] u8 biased E8M0. They are expanded only on chip.
// The wrapper picks the route from the shape and dtype alone
// (kernels/mxfp4_matmul/ops.py::pick_route).
//
// Why the tensor-core routes compute the same function: every dequantized
// weight is code2x * 0.5 * 2^(b-127), at most 2 significant bits and
// normal for b >= 2 (0 for b <= 1, inf or NaN at the top exponents as in
// f32), so it is exactly a bf16 value; bf16 x bf16 products are exact in
// f32, and the result differs from the reference's f32 dot only in sum
// order. f32 x stays on "fma": rounding it to bf16 would change the
// function.
//
// Route "mma" (`mxfp4_matmul_mma_launch`): bf16 x at decode (M <= 16, the
// serving lanes). Bound by memory (w1 at starcoder2-7b width, 4608 x
// 18432, is 45.1 MB: 13.5 us at 3.35 TB/s); it reaches about half that
// rate, its loads a K block ahead only partly hidden behind the widening
// of the codes (PERF.md).
// - Warp-level mma.sync m16n8k16 with the weight as the 16-row A operand
//   (16 output columns) and x as B (8 rows of x, zero past M; two B tiles
//   for M > 8): no wgmma, whose 64 rows would waste 16x at M = 4.
// - The k order inside an mma is free as long as A and B agree. Lane
//   (g, t) takes K rows 8t..8t+7 of each 32-row block, so its x is one
//   16-byte run a row, and its codes are 4 packed rows x 16 columns
//   (16 bytes each): byte j of a packed row is exactly one bf16x2 A
//   register (rows 2i, 2i+1 of column 16g + j). Each byte is widened once,
//   by one shared-memory load from a 256-entry table of its two code
//   values, kept a copy a lane (one byte permute of the code word and the
//   lane makes the address; a warp's 32 lookups hit 32 banks). The
//   tensor core sums a 32-row block, and the f32 block sum takes the
//   block scale 2^(b-128) (a power of two: scaling the sum is scaling each
//   product).
// - Loads: a lane's 16-byte items of the next K block (4 code rows
//   streamed past L1, the exponent row, its x run) are in flight in
//   registers while this block computes. 8 warps a block: wc of them side
//   by side over the block's columns, the rest taking its 32-row K blocks
//   in turn; summed in warp order through shared memory.
// - Split K in one launch: when the tiles cannot fill the card K is split
//   over blockIdx.y; each split writes f32 partials, and the last block to
//   arrive at a column tile (an arrival counter) sums them in split order,
//   writes bf16 and resets the counter. Deterministic: the sum order does
//   not depend on the arrival order.
// - Tried on the H100 and not kept (PERF.md): a cp.async ring in
//   shared memory and a bulk-copy (TMA) ring with mbarriers both streamed
//   slower than register prefetch here, and bulk prefetches into L2 ahead
//   of it slowed it down; scaling each weight by a bf16 multiply cost
//   more than scaling the block sums; 8 columns a lane group (more warps
//   an SM) won on some shapes and lost on others.
//
// Route "fma" (`mxfp4_matmul_launch`): f32 x, and shapes the other routes
// do not take. f32 FMAs on the CUDA cores.
// - A block of 8 warps owns BM rows x 128 columns; each lane owns 4
//   adjacent columns, so a warp reads 128 contiguous code bytes per packed
//   row and 4 exponent bytes per 32-row block, as 32-bit loads.
// - K goes in steps of 8 blocks of 32 rows; warp w takes block w of the
//   step. The step's activations sit in shared memory as f32 (bf16 or f32
//   in). The next step's activations and code words are loaded into
//   registers while this step computes. Per block a lane has 16 code words
//   and 1 exponent word; it decodes each nibble through a 16-entry table
//   of 2x the FP4 value (the integer arithmetic of `_decode_tile`), sums
//   x * code over the block in f32 FMAs, and adds the block sum times the
//   block scale.
// - M is masked in the kernel (BM = 4 for M <= 4, else 8), never padded.
//   When the output tiles are too few to fill the card, K is split over
//   blockIdx.z into a f32 partial buffer, summed in split order by a
//   second pass (deterministic, no atomics). The warps of a block are
//   summed in warp order through shared memory.
//
// Route "wgmma" (`mxfp4_matmul_tc_launch`): bf16 x at prefill sizes
// (M >= 16, K % 64 == 0, N % 128 == 0). Bound by the bf16 tensor cores
// (w1 at M = 192: 32.6 GFLOP, 33 us at 989 TFLOP/s).
// - A block owns 64 * NWG rows (NWG = 1..3 warpgroups, 3 at M >= 129) x
//   128 columns, so at M = 192 each packed weight is decoded once. K goes
//   in 64-row tiles through a 4-stage ring in shared memory: the x tile
//   (128-byte swizzled rows, the layout wgmma reads K-major), the packed
//   codes tile and its 2 exponent rows, all with 16-byte cp.async, 3
//   tiles ahead; rows of x past M are zero-filled.
// - Every warp decodes: 128 columns x 8 groups of 8 K rows, each item
//   4 code bytes and 1 exponent byte -> 8 bf16 (16 B) written to the
//   K-major, 128-byte swizzled B tile, as the bf16x2 product of a
//   256-entry byte table (the `_decode_tile` values of both nibbles) and
//   the block scale. The B tile is double-buffered: tile t+1 is decoded
//   while the warpgroups' wgmma m64n128k16 (4 per tile, f32 accumulators
//   in registers) run asynchronously on tile t.
// - Output tiles that leave a wave of 132 SMs part empty (N = 512 gives
//   4, N = 4608 36, N = 18432 144): K is split over blockIdx.z as in the
//   fma route, into f32 partials summed in split order by the same second
//   pass; ops.py::pick_tc_splits weighs the waves against the partials.
// - Measured on the H100 (PERF.md): about 1.45 us per 64-row K tile of a
//   192 x 128 block, against 0.42 us of tensor-core work; the x tile's
//   re-read from L2 by every column block, the decode and the block-wide
//   barriers add up rather than overlap. A producer warpgroup that loads
//   and decodes for three consumer warpgroups was slower (it became the
//   bottleneck), and so was keeping a second tile's wgmma in flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int COLS = 128;          // 32 lanes x 4 columns
constexpr int KSTEP = WARPS * 32;  // K rows per block step

__device__ __forceinline__ float half_scale(uint32_t b) {
  return b <= 1u ? 0.0f : 0.5f * __uint_as_float(b << 23);
}

// 2x the E2M1 value of nibble c: the integer decode of `_decode_tile`
__device__ __forceinline__ float code2x(int c) {
  const int s = (c >> 3) & 1, e = (c >> 1) & 3, m = c & 1;
  const int v = e == 0 ? m : (2 + m) << (e - 1);
  return (float)(s ? -v : v);
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

  if (tid < 16) lut[tid] = code2x(tid);  // as `_decode_tile`
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

int launch_splitk_sum(const float* partial, __nv_bfloat16* out, int splits,
                      size_t mn, cudaStream_t st) {
  const int blocks = (int)((mn + 255) / 256 < 1024 ? (mn + 255) / 256 : 1024);
  splitk_sum_kernel<<<blocks, 256, 0, st>>>(partial, out, splits, mn);
  return (int)cudaGetLastError();
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

// ---- route "wgmma": bf16 tensor cores --------------------------------------

namespace tc {

constexpr int BN = 128;                 // output columns per block
constexpr int BK = 64;                  // K rows per tile (two scale blocks)
constexpr int STAGES = 4;               // cp.async ring depth
constexpr int B_BYTES = BN * BK * 2;    // decoded bf16 tile, 16 KB
constexpr int C_BYTES = BK / 2 * BN;    // packed codes tile, 4 KB
constexpr int E_BYTES = BK / 32 * BN;   // exponent rows, 256 B

template <int NWG>
struct Smem {
  static constexpr int A_BYTES = NWG * 64 * BK * 2;  // x tile, swizzled
  static constexpr int A_OFF = 0;
  static constexpr int B_OFF = A_OFF + STAGES * A_BYTES;
  static constexpr int C_OFF = B_OFF + 2 * B_BYTES;
  static constexpr int E_OFF = C_OFF + STAGES * C_BYTES;
  static constexpr int LUT_OFF = E_OFF + STAGES * E_BYTES;
  static constexpr int BYTES = LUT_OFF + 256 * 4 + 1024;  // + base alignment
};

template <int NWG>
__global__ void __launch_bounds__(NWG * 128, 1)
mxfp4_matmul_tc_kernel(const __nv_bfloat16* __restrict__ x,
                       const uint8_t* __restrict__ codes,
                       const uint8_t* __restrict__ exps,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ partial, int M, int K, int N,
                       int kt_per_split) {
  using S = Smem<NWG>;
  constexpr int THREADS = NWG * 128;
  constexpr int ROWS = NWG * 64;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte aligned base: the swizzle pattern is taken on address bits
  const uint32_t raw_addr = hopper::smem_addr(smem_raw);
  unsigned char* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  uint32_t* lut2 = reinterpret_cast<uint32_t*>(smem + S::LUT_OFF);

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * ROWS;
  const int split = blockIdx.z, nkt = K / BK;
  const int kt0 = split * kt_per_split;
  const int nk = max(0, min(nkt, kt0 + kt_per_split) - kt0);

  for (int i = tid; i < 256; i += THREADS) {  // byte -> (lo, hi) as bf16x2
    const __nv_bfloat162 v =
        __floats2bfloat162_rn(code2x(i & 15), code2x(i >> 4));
    lut2[i] = *reinterpret_cast<const uint32_t*>(&v);
  }

  auto load_tile = [&](int st, int kt) {
    unsigned char* a = smem + S::A_OFF + st * S::A_BYTES;
    unsigned char* c = smem + S::C_OFF + st * C_BYTES;
    unsigned char* e = smem + S::E_OFF + st * E_BYTES;
    for (int i = tid; i < ROWS * 8; i += THREADS) {  // x: 8 chunks a row
      const int r = i >> 3, ch = i & 7;
      const bool ok = m0 + r < M;
      const __nv_bfloat16* src =
          ok ? x + (size_t)(m0 + r) * K + kt * BK + 8 * ch : x;
      hopper::cp_async16(a + hopper::swz128(r, ch), src, ok);
    }
    for (int i = tid; i < (BK / 2) * 8; i += THREADS) {  // codes rows
      const int r = i >> 3, ch = i & 7;
      hopper::cp_async16(c + r * BN + 16 * ch,
                         codes + (size_t)(kt * (BK / 2) + r) * N + n0 + 16 * ch);
    }
    if (tid < (BK / 32) * 8) {  // exponent rows
      const int r = tid >> 3, ch = tid & 7;
      hopper::cp_async16(e + r * BN + 16 * ch,
                         exps + (size_t)(kt * (BK / 32) + r) * N + n0 + 16 * ch);
    }
  };

  // packed tile of stage st -> bf16 B tile b: item (n, kq) holds K rows
  // 8kq..8kq+7 of column n, one 16-byte chunk of row n of the tile. Every
  // item's bytes are loaded before any is expanded (independent loads in
  // flight); each byte becomes its two values at once, as the bf16x2
  // product of its table entry and the block scale (both exact in bf16).
  constexpr int ITEMS = (BN * 8 + THREADS - 1) / THREADS;
  auto decode_tile = [&](int st, int b) {
    const unsigned char* c = smem + S::C_OFF + st * C_BYTES;
    const unsigned char* e = smem + S::E_OFF + st * E_BYTES;
    unsigned char* bt = smem + S::B_OFF + b * B_BYTES;
    uint32_t by[ITEMS][4], eb[ITEMS];
#pragma unroll
    for (int t = 0; t < ITEMS; ++t) {
      const int i = tid + t * THREADS, n = i % BN, kq = i / BN;
      if (i < BN * 8) {
#pragma unroll
        for (int r = 0; r < 4; ++r) by[t][r] = c[(4 * kq + r) * BN + n];
        eb[t] = e[(kq >> 2) * BN + n];
      }
    }
#pragma unroll
    for (int t = 0; t < ITEMS; ++t) {
      const int i = tid + t * THREADS, n = i % BN, kq = i / BN;
      if (i < BN * 8) {
        const __nv_bfloat162 hs2 = __float2bfloat162_rn(half_scale(eb[t]));
        uint32_t w[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const __nv_bfloat162 v = __hmul2(
              *reinterpret_cast<const __nv_bfloat162*>(&lut2[by[t][r]]), hs2);
          w[r] = *reinterpret_cast<const uint32_t*>(&v);
        }
        *reinterpret_cast<uint4*>(bt + hopper::swz128(n, kq)) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  };

  float d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.0f;
  const int wg = tid >> 7;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_tile(s, kt0 + s);
    hopper::cp_async_commit();
  }
  __syncthreads();  // lut2
  if (nk > 0) {
    hopper::cp_async_wait<STAGES - 2>();
    __syncthreads();
    decode_tile(0, 0);
    hopper::fence_proxy_async();
  }
  __syncthreads();

  for (int it = 0; it < nk; ++it) {
    if (it + STAGES - 1 < nk)  // stage (it-1) % STAGES was consumed by it-1
      load_tile((it + STAGES - 1) % STAGES, kt0 + it + STAGES - 1);
    hopper::cp_async_commit();
    const uint32_t a = hopper::smem_addr(smem + S::A_OFF +
                                         (it % STAGES) * S::A_BYTES) +
                       wg * 64 * 128;
    const uint32_t bb = hopper::smem_addr(smem + S::B_OFF + (it & 1) * B_BYTES);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hopper::wgmma_ss_m64n128k16(d, hopper::desc128(a + 32 * kk),
                                  hopper::desc128(bb + 32 * kk));
    hopper::wgmma_commit();
    if (it + 1 < nk) {  // decode the next tile while the tensor cores run
      hopper::cp_async_wait<STAGES - 2>();
      __syncthreads();
      decode_tile((it + 1) % STAGES, (it + 1) & 1);
      hopper::fence_proxy_async();
    }
    hopper::wgmma_wait0();
    __syncthreads();
  }

  // accumulator fragment: warp w of the warpgroup holds rows 16w..16w+15;
  // d[4j..4j+1] at row lane/4, columns 8j + 2(lane%4) + {0, 1}; d[4j+2..3]
  // eight rows below
  const int wl = (tid >> 5) & 3, lane = tid & 31;
  const int row0 = m0 + wg * 64 + wl * 16 + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < M) {
        const float v0 = d[4 * j + 2 * h], v1 = d[4 * j + 2 * h + 1];
        if (gridDim.z == 1)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
              __floats2bfloat162_rn(v0, v1);
        else
          *reinterpret_cast<float2*>(
              partial + ((size_t)split * M + row) * N + col) = make_float2(v0, v1);
      }
    }
  }
}

template <int NWG>
int launch(const __nv_bfloat16* x, const uint8_t* codes, const uint8_t* exps,
           __nv_bfloat16* out, float* partial, int M, int K, int N, int splits,
           cudaStream_t st) {
  static hopper::DeviceSet attr_set;
  const int smem = Smem<NWG>::BYTES;
  if (!attr_set.has_current()) {
    cudaError_t err = cudaFuncSetAttribute(
        mxfp4_matmul_tc_kernel<NWG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr_set.add_current();
  }
  const int nkt = K / BK;
  const int kt_per_split = (nkt + splits - 1) / splits;
  dim3 grid(N / BN, (M + NWG * 64 - 1) / (NWG * 64), splits);
  mxfp4_matmul_tc_kernel<NWG><<<grid, NWG * 128, smem, st>>>(
      x, codes, exps, out, partial, M, K, N, kt_per_split);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---- route "mma": warp-level bf16 tensor cores at decode -------------------

namespace mma {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int BN = 128;  // columns a warp: 8 lane groups x 16
// byte -> code pair, a copy a lane: row b (256 bytes) holds lane l's copy
// at byte 4l, so one byte permute of the code word and 4 x lane makes the
// address, and a warp's 32 lookups hit 32 distinct banks
constexpr int LUT_BYTES = 256 * 256;

template <int MT>  // MT tiles of 8 rows of x
struct Smem {
  static constexpr int RED_BYTES = WARPS * 8 * MT * BN * 4;  // warp sums
  static constexpr int BYTES = LUT_BYTES > RED_BYTES ? LUT_BYTES : RED_BYTES;
};

// 16 bytes streamed past L1 (each weight byte is read once); volatile so
// the load stays where it is issued, a K block ahead of its use
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

// 16 bytes through L1 (exponent rows and x, re-read by neighbouring lanes)
__device__ __forceinline__ uint4 ld_cached(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "l"(p));
  return r;
}

// the block scale 2^(b-128) of biased E8M0 byte k of w: exponent field
// b - 1 (byte k permuted to bits 16..23, times 2^7, less 2^23), 0 at the
// floor (b = 1 gives 0, b = 0 gives -inf, which the max takes to 0);
// `_dequant_packed`'s scale
__device__ __forceinline__ float block_scale(uint32_t w, int k) {
  const uint32_t b16 = __byte_perm(w, 0u, 0x4044u | ((uint32_t)k << 8));
  return fmaxf(__uint_as_float(b16 * 128u - 0x00800000u), 0.0f);
}

// a lane's share of one 32-row K block: packed rows 4t..4t+3 of the block
// at its group's 16 columns, their exponent row, and x rows g (+ 8) at K
// 8t..8t+7 of the block (zero past M)
template <int MT>
struct Block {
  uint4 c[4], e, x[MT];
};

template <int MT>
__global__ void __launch_bounds__(THREADS, MT == 1 ? 2 : 1)
mxfp4_matmul_mma_kernel(const __nv_bfloat16* __restrict__ x,
                        const uint8_t* __restrict__ codes,
                        const uint8_t* __restrict__ exps,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ partial, int* __restrict__ arrivals,
                        int M, int K, int N, int kb_per_split, int wc) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  uint32_t* lut = reinterpret_cast<uint32_t*>(smem);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  // wc warps side by side over wc * 128 columns, wk = WARPS / wc of them
  // in turn over K at each
  const int wk = WARPS / wc, cw = warp % wc, kw = warp / wc;
  const int n0 = tile * wc * BN;
  const int col = n0 + cw * BN + 16 * g;  // this lane group's first column
  const bool col_ok = col < N;  // N % 16 == 0: all 16 columns or none
  const int kb0 = split * kb_per_split;
  const int kb1 = min(K / 32, kb0 + kb_per_split);
  // this warp's K blocks: kb0 + kw, kb0 + kw + wk, ...
  const int nk = kb0 + kw < kb1 ? (kb1 - kb0 - kw + wk - 1) / wk : 0;

  auto fetch = [&](int i, Block<MT>& b) {
    const int kb = kb0 + kw + i * wk;
    if (col_ok) {
      const uint8_t* cp = codes + ((size_t)kb * 16 + 4 * t) * N + col;
#pragma unroll
      for (int r = 0; r < 4; ++r) b.c[r] = ld_stream(cp + (size_t)r * N);
      b.e = ld_cached(exps + (size_t)kb * N + col);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) b.c[r] = make_uint4(0, 0, 0, 0);
      b.e = make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m = g + 8 * mt;
      b.x[mt] = m < M ? ld_cached(x + (size_t)m * K + kb * 32 + 8 * t)
                      : make_uint4(0, 0, 0, 0);
    }
  };
  Block<MT> cur, nxt;
  if (nk > 0) fetch(0, cur);

  // the table while the first block loads: entry tid, 32 copies with
  // 16-byte stores rotated so a quarter warp hits distinct banks
  {
    const __nv_bfloat162 v =
        __floats2bfloat162_rn(code2x(tid & 15), code2x(tid >> 4));
    const uint32_t e = *reinterpret_cast<const uint32_t*>(&v);
#pragma unroll
    for (int c = 0; c < 8; ++c)
      *reinterpret_cast<uint4*>(lut + tid * 64 + 4 * ((c + lane) & 7)) =
          make_uint4(e, e, e, e);
  }
  __syncthreads();
  const unsigned char* lutb = smem;
  const uint32_t lane4 = 4u * lane;
  // the code pair of byte k of w: address byte * 256 + 4 * lane
  auto pair = [&](uint32_t w, int k) {
    return *reinterpret_cast<const uint32_t*>(
        lutb + __byte_perm(w, lane4, 0x5504u | ((uint32_t)k << 4)));
  };

  float acc[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][j][q] = 0.0f;
  const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  // A row g is column col + j, row g + 8 column col + 8 + j: the block's
  // two k16 steps (step st: packed rows 4t + 2st, 4t + 2st + 1, i.e. K rows
  // 8t + 4st .. 8t + 4st + 3, whose x pairs are words 2st, 2st + 1 of the
  // lane's x run) sum the block on the tensor cores, and the f32 block
  // sum takes its column's scale
  auto compute = [&](const Block<MT>& b) {
    const uint32_t ew[4] = {b.e.x, b.e.y, b.e.z, b.e.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int k = j & 3;
      float bs[MT][4];
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        const uint4 ra = b.c[2 * st], rb = b.c[2 * st + 1];
        const uint32_t a0 = pair(j < 4 ? ra.x : ra.y, k);
        const uint32_t a1 = pair(j < 4 ? ra.z : ra.w, k);
        const uint32_t a2 = pair(j < 4 ? rb.x : rb.y, k);
        const uint32_t a3 = pair(j < 4 ? rb.z : rb.w, k);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          hopper::mma_m16n8k16_bf16(bs[mt], a0, a1, a2, a3,
                                    st ? b.x[mt].z : b.x[mt].x,
                                    st ? b.x[mt].w : b.x[mt].y,
                                    st ? bs[mt] : zero);
      }
      const float s0 = block_scale(ew[j >> 2], k);
      const float s1 = block_scale(ew[2 + (j >> 2)], k);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        acc[mt][j][0] = fmaf(bs[mt][0], s0, acc[mt][j][0]);
        acc[mt][j][1] = fmaf(bs[mt][1], s0, acc[mt][j][1]);
        acc[mt][j][2] = fmaf(bs[mt][2], s1, acc[mt][j][2]);
        acc[mt][j][3] = fmaf(bs[mt][3], s1, acc[mt][j][3]);
      }
    }
  };
  // two buffers in turn: block i + 1 is in flight while block i computes
  for (int i = 0; i < nk; i += 2) {
    if (i + 1 < nk) fetch(i + 1, nxt);
    compute(cur);
    if (i + 2 < nk) fetch(i + 2, cur);
    if (i + 1 < nk) compute(nxt);
  }
  __syncthreads();  // every warp is done with the table

  // sum the warps of a column in order: red[warp][row][column], rows 2t,
  // 2t + 1 (+ 8 mt) of columns 16g + j and 16g + 8 + j
  float* red = reinterpret_cast<float*>(smem);
  constexpr int ROWS = 8 * MT;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* r0 = red + (warp * ROWS + 8 * mt + 2 * t) * BN + 16 * g + j;
      r0[0] = acc[mt][j][0];
      r0[BN] = acc[mt][j][1];
      r0[8] = acc[mt][j][2];
      r0[BN + 8] = acc[mt][j][3];
    }
  __syncthreads();
  const bool direct = splits == 1;
  const int bn = wc * BN;  // the block's columns
  for (int i = tid; i < M * bn; i += THREADS) {
    const int r = i / bn, cc = i % bn, n = n0 + cc;
    float v = 0.0f;
    for (int w = cc / BN; w < WARPS; w += wc)  // the column's warps, in order
      v += red[(w * ROWS + r) * BN + cc % BN];
    if (n < N) {
      if (direct)
        out[(size_t)r * N + n] = __float2bfloat16_rn(v);
      else
        partial[((size_t)split * M + r) * N + n] = v;
    }
  }
  if (direct) return;

  // the last split to arrive at this column tile sums all of them in split
  // order and leaves the counter at zero for the next launch
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&arrivals[tile], 1) == splits - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int i = tid; i < M * bn; i += THREADS) {
    const int r = i / bn, n = n0 + i % bn;
    if (n < N) {
      float v = 0.0f;
      for (int z = 0; z < splits; ++z)
        v += __ldcg(partial + ((size_t)z * M + r) * N + n);
      out[(size_t)r * N + n] = __float2bfloat16_rn(v);
    }
  }
  if (tid == 0) arrivals[tile] = 0;
}

template <int MT>
int launch(const __nv_bfloat16* x, const uint8_t* codes, const uint8_t* exps,
           __nv_bfloat16* out, float* partial, int* arrivals, int M, int K,
           int N, int splits, int wc, cudaStream_t st) {
  static hopper::DeviceSet attr_set;
  const int smem = Smem<MT>::BYTES;  // the 64 KB table
  if (!attr_set.has_current()) {
    cudaError_t err = cudaFuncSetAttribute(
        mxfp4_matmul_mma_kernel<MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr_set.add_current();
  }
  const int nkb = K / 32;
  const int kb_per_split = (nkb + splits - 1) / splits;
  dim3 grid((N + wc * BN - 1) / (wc * BN), splits);
  mxfp4_matmul_mma_kernel<MT><<<grid, THREADS, smem, st>>>(
      x, codes, exps, out, partial, arrivals, M, K, N, kb_per_split, wc);
  return (int)cudaGetLastError();
}

}  // namespace mma

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
  return launch_splitk_sum(partial, o, splits, (size_t)M * N, st);
}

// x [M, K] bf16; codes u8 [K/2, N]; exps u8 [K/32, N]; out bf16 [M, N];
// partial f32 [splits, M, N] (unused when splits == 1). M >= 1,
// K % 64 == 0, N % 128 == 0, x / codes / exps 16-byte aligned; every split
// owns ceil(K/64 / splits) tiles (the last may own none and writes zeros).
// Returns the launches' cudaError_t.
extern "C" int mxfp4_matmul_tc_launch(const void* x, const uint8_t* codes,
                                      const uint8_t* exps, void* out,
                                      float* partial, int M, int K, int N,
                                      int splits, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(out);
  int err;
  if (M <= 64)
    err = tc::launch<1>(xb, codes, exps, o, partial, M, K, N, splits, st);
  else if (M <= 128)
    err = tc::launch<2>(xb, codes, exps, o, partial, M, K, N, splits, st);
  else
    err = tc::launch<3>(xb, codes, exps, o, partial, M, K, N, splits, st);
  if (err != cudaSuccess || splits == 1) return err;
  return launch_splitk_sum(partial, o, splits, (size_t)M * N, st);
}

// x [M, K] bf16; codes u8 [K/2, N]; exps u8 [K/32, N]; out bf16 [M, N];
// partial f32 [splits, M, N] (unused when splits == 1) and arrivals int32
// [ceil(N / (128 wc))], zero at rest (each launch leaves them so). wc in
// {1, 2, 4, 8}: warps side by side over the block's columns. 1 <= M <= 16,
// K % 32 == 0, N % 16 == 0, x / codes / exps 16-byte aligned. Returns the
// launch's cudaError_t.
extern "C" int mxfp4_matmul_mma_launch(const void* x, const uint8_t* codes,
                                       const uint8_t* exps, void* out,
                                       float* partial, int* arrivals, int M,
                                       int K, int N, int splits, int wc,
                                       void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(x);
  __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(out);
  if (M <= 8)
    return mma::launch<1>(xb, codes, exps, o, partial, arrivals, M, K, N,
                          splits, wc, st);
  return mma::launch<2>(xb, codes, exps, o, partial, arrivals, M, K, N,
                        splits, wc, st);
}
