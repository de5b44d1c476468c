// pim_matmul: epilogue-fused matmul on PIM-quantized weights, any M, for
// Hopper (sm_90a).
//
// Replaces src/repro/kernels/pim_matmul.py:_mm_kernel, the Pallas kernel the
// JAX package runs on the TPU.  It computes exactly
// repro_torch/kernels/pim_matmul.py:pim_matmul_plain:
//   out[m, n] = epilogue(sum_k f32(x[m, k]) * code[k, n]),
//   epilogue  = * scale[n] [+ bias[n]] -> activation -> [+ residual[m, n]],
// with an f32 accumulator and one f32 store per output.  Codes are int8
// (K, N), or int4 nibble-packed (K/2, N) with the low nibble holding the
// even K row and sign extension ((v & 0xF) ^ 8) - 8, as in the JAX
// package's quant_accumulate.
//
// What bounds it on the card: operations.  At the prefill shapes (M = 512)
// a code byte feeds 512 (int8) or 1024 (int4) multiply-adds, far above the
// ~20 operations per byte (67 TFLOP/s f32 over 3.35 TB/s) where the H100's
// CUDA cores, not HBM, become the limit.  What the design does about it:
//   * one 64 x 64 output tile per block of 256 threads, 4 x 4 outputs per
//     thread held in registers; each value staged in shared memory is used
//     64 times (a row of x by 64 columns, a code by 64 rows), so the inner
//     loop is two 16-byte shared loads per 16 multiply-adds;
//   * the Pallas kernel walks K as a sequential grid axis with the output
//     tile resident in VMEM; here a loop inside the block walks K in stages
//     of 32, the accumulator stays in registers, and the blocks of the grid
//     are independent: no split-K, no atomics, the same result every run;
//   * dequantize on load: x (f32 or bf16) and the codes are widened to f32
//     as they enter shared memory, so no dequantized weight is ever written
//     to HBM;
//   * the ragged M, N and K edges are masked where the tiles are loaded and
//     stored (zeros enter the sums), so no padded copy is made;
//   * the epilogue is pim_epilogue from epilogue.cuh, the same device
//     function pim_matvec runs.
// All of it runs on the CUDA cores in f32.  The tensor cores (bf16 mma with
// f32 accumulation, exact for int8 codes and bf16 x) are later work.  It
// allocates nothing: the caller passes the output and the stream.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

constexpr int kBlockM = 64;                     // output rows per block
constexpr int kBlockN = 64;                     // output columns per block
constexpr int kBlockK = 32;                     // K values per stage (BLOCK_K)
constexpr int kThreadsN = 16;                   // threads across columns
constexpr int kThreadsM = 16;                   // threads across rows
constexpr int kThreads = kThreadsM * kThreadsN;
constexpr int kRows = kBlockM / kThreadsM;      // 4 rows per thread
constexpr int kCols = kBlockN / kThreadsN;      // 4 columns per thread
constexpr int kPad = 4;                         // keeps rows 16-byte aligned

static_assert(kRows == 4 && kCols == 4, "the inner loop reads float4s");
static_assert(kBlockK % 2 == 0, "a stage holds whole nibble pairs");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int BITS, typename XT>
__global__ void __launch_bounds__(kThreads)
pim_matmul_kernel(const XT* __restrict__ x, const int8_t* __restrict__ codes,
                  const float* __restrict__ scale, const void* bias, bool bias_bf16,
                  const void* residual, bool residual_bf16, int activation,
                  float* __restrict__ out, int M, int K, int N) {
    // xs is K-major so that a thread's 4 rows are one float4.
    __shared__ __align__(16) float xs[kBlockK][kBlockM + kPad];
    __shared__ __align__(16) float ws[kBlockK][kBlockN + kPad];

    const int tid = threadIdx.x;
    const int tx = tid % kThreadsN, ty = tid / kThreadsN;
    const int m0 = blockIdx.y * kBlockM, n0 = blockIdx.x * kBlockN;

    float acc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < K; k0 += kBlockK) {
        // x tile: a warp reads 32 consecutive K values of one row.
        for (int i = tid; i < kBlockM * kBlockK; i += kThreads) {
            const int r = i / kBlockK, c = i % kBlockK;
            const int gm = m0 + r, gk = k0 + c;
            xs[c][r] = (gm < M && gk < K) ? to_f32(x[static_cast<size_t>(gm) * K + gk]) : 0.0f;
        }
        // Code tile, widened to f32: a warp reads 32 consecutive bytes of a row.
        if constexpr (BITS == 8) {
            for (int i = tid; i < kBlockK * kBlockN; i += kThreads) {
                const int r = i / kBlockN, c = i % kBlockN;
                const int gk = k0 + r, gn = n0 + c;
                ws[r][c] = (gk < K && gn < N)
                               ? static_cast<float>(codes[static_cast<size_t>(gk) * N + gn])
                               : 0.0f;
            }
        } else {
            // Packed row p holds K rows 2p (low nibble) and 2p + 1 (high).
            // K is even, so a pair is either wholly inside K or wholly past it.
            for (int i = tid; i < (kBlockK / 2) * kBlockN; i += kThreads) {
                const int r = i / kBlockN, c = i % kBlockN;
                const int gp = k0 / 2 + r, gn = n0 + c;
                const int v = (gp < K / 2 && gn < N) ? codes[static_cast<size_t>(gp) * N + gn] : 0;
                ws[2 * r][c] = static_cast<float>(((v & 0xF) ^ 8) - 8);
                ws[2 * r + 1][c] = static_cast<float>((((v >> 4) & 0xF) ^ 8) - 8);
            }
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kBlockK; ++kk) {
            const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * kRows]);
            const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * kCols]);
            const float av[kRows] = {a.x, a.y, a.z, a.w};
            const float bv[kCols] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < kRows; ++i)
#pragma unroll
                for (int j = 0; j < kCols; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int gm = m0 + ty * kRows + i;
        if (gm >= M) continue;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
            const int gn = n0 + tx * kCols + j;
            if (gn >= N) continue;
            const size_t mn = static_cast<size_t>(gm) * N + gn;
            out[mn] = pim_epilogue(acc[i][j], scale[gn], bias, bias_bf16, residual,
                                   residual_bf16, activation, gn, mn);
        }
    }
}

template <int BITS, typename XT>
void launch(const void* x, const int8_t* codes, const float* scale, const void* bias,
            bool bias_bf16, const void* residual, bool residual_bf16, int activation,
            float* out, int M, int K, int N, cudaStream_t stream) {
    const dim3 grid((N + kBlockN - 1) / kBlockN, (M + kBlockM - 1) / kBlockM);
    pim_matmul_kernel<BITS, XT><<<grid, kThreads, 0, stream>>>(
        static_cast<const XT*>(x), codes, scale, bias, bias_bf16, residual, residual_bf16,
        activation, out, M, K, N);
}

}  // namespace

// Launches the kernel on `stream`.  x: (M, K) f32 or bf16; codes: (K, N) int8
// (bits 8) or (K/2, N) nibbles (bits 4, K even); scale: (N,) f32; bias: (N,)
// f32/bf16 or null; residual: (M, N) f32/bf16 or null; out: (M, N) f32.  All
// contiguous.  Returns cudaGetLastError().
extern "C" int pim_matmul_launch(const void* x, int x_bf16, const void* codes, const void* scale,
                                 const void* bias, int bias_bf16, const void* residual,
                                 int residual_bf16, void* out, int M, int K, int N, int bits,
                                 int activation, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int8_t* w = static_cast<const int8_t*>(codes);
    const float* sc = static_cast<const float*>(scale);
    float* o = static_cast<float*>(out);
    const bool bb = bias_bf16 != 0, rb = residual_bf16 != 0;
    if (bits == 8) {
        if (x_bf16)
            launch<8, __nv_bfloat16>(x, w, sc, bias, bb, residual, rb, activation, o, M, K, N, s);
        else
            launch<8, float>(x, w, sc, bias, bb, residual, rb, activation, o, M, K, N, s);
    } else if (bits == 4 && K % 2 == 0) {
        if (x_bf16)
            launch<4, __nv_bfloat16>(x, w, sc, bias, bb, residual, rb, activation, o, M, K, N, s);
        else
            launch<4, float>(x, w, sc, bias, bb, residual, rb, activation, o, M, K, N, s);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
