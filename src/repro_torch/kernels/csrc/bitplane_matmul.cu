// bitplane_matmul: the bit-plane-decomposed matmul (PiCaSO's bit-serial MAC
// in spatial form) with the fused epilogue, any M, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/bitplane.py:_bitplane_kernel, the Pallas kernel
// the JAX package runs on the TPU.  It computes the function of
// repro_torch/kernels/bitplane.py:bitplane_matmul_plain:
//   out[m, n] = epilogue(sum_b w_b * sum_k f32(x[m, k]) * plane_b[k, n]),
//   w_b = 2^b for b < B - 1, w_{B-1} = -2^(B-1) (two's complement, LSB first),
//   epilogue = * scale[n] [+ bias[n]] -> activation -> [+ residual[m, n]],
// for planes (B, K, N) int8 in {0, 1} with 1 <= B <= 8, an f32 accumulator
// and one f32 store per output.
//
// Route: the weight is formed on load.  The TPU kernel runs one f32 product
// per plane and weights it; here each weight is summed from its B plane
// bytes as it enters shared memory, sum_b w_b * plane_b[k, n], an exact
// integer in [-2^(B-1), 2^(B-1) - 1], so one multiply-add per (m, k, n)
// follows instead of B.  Both routes compute the same function; the sums of
// f32 products are taken in another order than the plain version's (which
// sums each plane's products, then the weighted planes), so the two agree
// to f32 rounding.  With the weight formed, the rest is
// csrc/pim_matmul.cu's kernel, stage by stage: one 64 x 64 output tile per
// block of 256 threads, 4 x 4 outputs per thread in registers, K walked in
// stages of 32 in shared memory, the ragged M, N and K edges masked where
// the tiles are loaded and stored, no split-K and no atomics.  Each output
// is therefore the same chain of f32 multiply-adds, in the same K order, as
// pim_matmul's on the codes the planes stand for: the two kernels agree bit
// for bit, and the bit-plane path equals the packed one.
//
// What bounds it on the card: bytes.  The planes are one byte per bit, B * K
// * N bytes, 8x the int8 codes at B = 8; at qwen2-1.5b's prefill shapes
// (M = 512) their bytes outweigh the multiply-adds at the bf16 tensor
// cores' rate.  What the design does about it: each plane row segment is
// read as 16-byte vectors along N (where N is a multiple of 16 and the
// planes 16-byte aligned; byte loads at the ragged edge otherwise), the
// planes are collapsed into one f32 weight per (k, n) in shared memory, and
// no dequantized weight is ever written to device memory.  Like pim_matmul
// it runs its multiply-adds on the CUDA cores in f32, which is what bounds
// this design in practice; the tensor cores are later work.  It allocates
// nothing: the caller passes the output and the stream.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

constexpr int kBlockM = 64;                     // output rows per block
constexpr int kBlockN = 64;                     // output columns per block
constexpr int kBlockK = 32;                     // K values per stage
constexpr int kThreadsN = 16;                   // threads across columns
constexpr int kThreadsM = 16;                   // threads across rows
constexpr int kThreads = kThreadsM * kThreadsN;
constexpr int kRows = kBlockM / kThreadsM;      // 4 rows per thread
constexpr int kCols = kBlockN / kThreadsN;      // 4 columns per thread
constexpr int kPad = 4;                         // keeps rows 16-byte aligned
constexpr int kVec = 16;                        // plane bytes per vector load
constexpr int kMaxBits = 8;

static_assert(kRows == 4 && kCols == 4, "the inner loop reads float4s");
static_assert(kBlockN % kVec == 0, "a stage row is whole vectors");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// The weight of plane b of B: 2^b, and -2^(B-1) for the sign plane.
__device__ __forceinline__ int plane_weight(int b, int bits) {
    return b < bits - 1 ? (1 << b) : -(1 << b);
}

template <typename XT>
__global__ void __launch_bounds__(kThreads)
bitplane_matmul_kernel(const XT* __restrict__ x, const int8_t* __restrict__ planes, int bits,
                       bool vec_ok, const float* __restrict__ scale, const void* bias,
                       bool bias_bf16, const void* residual, bool residual_bf16, int activation,
                       float* __restrict__ out, int M, int K, int N) {
    // xs is K-major so that a thread's 4 rows are one float4.
    __shared__ __align__(16) float xs[kBlockK][kBlockM + kPad];
    __shared__ __align__(16) float ws[kBlockK][kBlockN + kPad];

    const int tid = threadIdx.x;
    const int tx = tid % kThreadsN, ty = tid / kThreadsN;
    const int m0 = blockIdx.y * kBlockM, n0 = blockIdx.x * kBlockN;
    const size_t plane_stride = static_cast<size_t>(K) * N;

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
        // Weight tile, formed on load: 16 columns of one K row per thread,
        // sum_b w_b * plane_b over the B planes, exact in int and in f32.
        for (int i = tid; i < kBlockK * (kBlockN / kVec); i += kThreads) {
            const int r = i / (kBlockN / kVec), c = (i % (kBlockN / kVec)) * kVec;
            const int gk = k0 + r, gn = n0 + c;
            int w[kVec];
#pragma unroll
            for (int u = 0; u < kVec; ++u) w[u] = 0;
            if (gk < K && gn < N) {
                const int8_t* p = planes + static_cast<size_t>(gk) * N + gn;
                if (vec_ok) {  // N % 16 == 0, so the whole vector lies inside N
                    for (int b = 0; b < bits; ++b) {
                        const int4 v = *reinterpret_cast<const int4*>(p + b * plane_stride);
                        const unsigned words[4] = {static_cast<unsigned>(v.x),
                                                   static_cast<unsigned>(v.y),
                                                   static_cast<unsigned>(v.z),
                                                   static_cast<unsigned>(v.w)};
                        const int wb = plane_weight(b, bits);
#pragma unroll
                        for (int u = 0; u < kVec; ++u)
                            w[u] += wb * static_cast<int>(
                                             static_cast<int8_t>(words[u / 4] >> (8 * (u % 4))));
                    }
                } else {
                    for (int b = 0; b < bits; ++b) {
                        const int wb = plane_weight(b, bits);
#pragma unroll
                        for (int u = 0; u < kVec; ++u)
                            if (gn + u < N) w[u] += wb * static_cast<int>(p[b * plane_stride + u]);
                    }
                }
            }
#pragma unroll
            for (int u = 0; u < kVec; u += 4)
                *reinterpret_cast<float4*>(&ws[r][c + u]) =
                    make_float4(static_cast<float>(w[u]), static_cast<float>(w[u + 1]),
                                static_cast<float>(w[u + 2]), static_cast<float>(w[u + 3]));
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

}  // namespace

// Launches the kernel on `stream`.  x: (M, K) f32 or bf16; planes: (bits, K,
// N) int8, 1 <= bits <= 8; scale: (N,) f32; bias: (N,) f32/bf16 or null;
// residual: (M, N) f32/bf16 or null; out: (M, N) f32.  All contiguous.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for bits out of range.
extern "C" int bitplane_matmul_launch(const void* x, int x_bf16, const void* planes, int bits,
                                      const void* scale, const void* bias, int bias_bf16,
                                      const void* residual, int residual_bf16, void* out, int M,
                                      int K, int N, int activation, void* stream) {
    if (bits < 1 || bits > kMaxBits) return static_cast<int>(cudaErrorInvalidValue);
    const bool vec_ok = N % kVec == 0 && reinterpret_cast<uintptr_t>(planes) % kVec == 0;
    const dim3 grid((N + kBlockN - 1) / kBlockN, (M + kBlockM - 1) / kBlockM);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int8_t* p = static_cast<const int8_t*>(planes);
    const float* sc = static_cast<const float*>(scale);
    float* o = static_cast<float*>(out);
    const bool bb = bias_bf16 != 0, rb = residual_bf16 != 0;
    if (x_bf16)
        bitplane_matmul_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(x), p, bits, vec_ok, sc, bias, bb, residual, rb,
            activation, o, M, K, N);
    else
        bitplane_matmul_kernel<float><<<grid, kThreads, 0, s>>>(
            static_cast<const float*>(x), p, bits, vec_ok, sc, bias, bb, residual, rb,
            activation, o, M, K, N);
    return static_cast<int>(cudaGetLastError());
}
