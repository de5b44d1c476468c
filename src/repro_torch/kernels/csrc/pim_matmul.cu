// pim_matmul: epilogue-fused matmul on PIM-quantized weights, any M, for
// Hopper (sm_90a).
//
// Replaces src/repro/kernels/pim_matmul.py:42 _mm_kernel, the Pallas kernel
// the JAX package runs on the TPU.  It computes
// repro_torch/kernels/pim_matmul.py:pim_matmul_plain:
//   out[m, n] = epilogue(sum_k f32(x[m, k]) * code[k, n]),
//   epilogue  = * scale[n] [+ bias[n]] -> activation -> [+ residual[m, n]],
// with f32 sums and one f32 store per output.  Codes are int8 (K, N), or
// int4 nibble-packed (K/2, N) with the low nibble holding the even K row and
// sign extension ((v & 0xF) ^ 8) - 8, as in the JAX package's
// quant_accumulate.
//
// What bounds it on the card: operations.  At the prefill shapes (M = 512)
// a code byte feeds 512 (int8) or 1024 (int4) multiply-adds; int8 and int4
// codes and bf16 x are exact in bf16 and their products exact in f32, so the
// card's least time is those multiply-adds at the bf16 tensor cores' rate.
//
// bf16 x (the route every timed shape takes) runs the main loop of
// pim_gemm.cuh on the tensor cores: mma.sync m16n8k16, bf16 in, f32
// accumulation, out^T = codes^T . x^T.  What the design does about the
// bound:
//   * codes (a ring 3 stages deep) and x (5 deep) move by 16-byte cp.async
//     four 32-K stages ahead of the MMAs (codes not 16-byte aligned, e.g.
//     N = 300, and x rows of K % 8 != 0 take narrower loads that give the
//     same values and the same MMA order);
//   * each stage's codes are widened once per CTA, by the threads that
//     copied them, into a bf16 tile that all warps read with ldmatrix.trans
//     (int8: the 2^23 magic, widen_int8's arithmetic; int4: the bf16 magic
//     of widen_int4, each packed row giving its two K rows, so A's K order
//     is the int8 order); the warps' tiles are up to 64 x 64 outputs, so a
//     fragment read from shared memory feeds up to 8 MMAs;
//   * every 16 K values' tensor-core sums join f32 running sums, so the sums
//     stay within rtol 1e-5 / atol 1e-4 of the f32 product at K = 8,960;
//   * the plan (repro_torch/kernels/pim_matmul.py:plan) picks a CTA tile of
//     256 x 128 or 128 x 16..128 outputs and a cluster of 1 to 8 CTAs
//     splitting K, whose partial tiles are added in rank order through
//     distributed shared memory, so narrow weights (N = 256) and deep ones
//     (K = 8,960) still give the 132 SMs a wave of CTAs;
//   * programmatic dependent launch overlaps each launch with the end of
//     the kernel before it.
// bitplane_matmul runs the same main loop with a loader that forms these
// int8 codes from bit-planes: at the same plan the two agree bit for bit.
//
// f32 x keeps the first port's CUDA-core body: one 64 x 64 output tile per
// block of 256 threads, x and codes widened to f32 in shared memory, f32
// multiply-adds, no split of K.  Its plan is fixed (64 x 64 tiles, cluster
// 1); no timed shape uses it.  It allocates nothing: the caller passes the
// output and the stream.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "pim_gemm.cuh"

namespace {

using namespace pim_gemm;

constexpr int kCodeStages = 3;  // the code ring's depth
constexpr int kXStages = 5;     // the x ring's depth: stages stream in 4 ahead

// int8 codes (BITS 8, K rows) or nibble-packed int4 codes (BITS 4, K / 2
// packed rows) of a (rows, N) matrix, a stage at a time, in 16-byte chunks:
// chunk i of a stage is row i / (BN / 16), columns (i % (BN / 16)) * 16 ..
// + 15, and the thread that copies a chunk widens it.
template <int BITS>
struct CodeLoader {
    static constexpr int kRows = BITS == 4 ? kStageK / 2 : kStageK;  // code rows of a stage
    const int8_t* codes;
    int rows, N;
    bool vec;  // rows 16-byte aligned: cp.async

    template <int BN>
    __host__ __device__ static constexpr int code_bytes() {
        return kRows * (BN + kCodePad);
    }

    template <int THREADS, int BN>
    __device__ void issue(unsigned char* slot, int k0, int n0, int tid) const {
        const int r0 = BITS == 4 ? k0 / 2 : k0;
        for_each<kRows * (BN / 16), THREADS>(tid, [&](int i) {
            const int row = i / (BN / 16), cc = (i % (BN / 16)) * 16;
            const int gr = r0 + row, col = n0 + cc;
            stage16(slot + row * (BN + kCodePad) + cc, codes + static_cast<size_t>(gr) * N + col,
                    codes, gr < rows && col < N, col, N, vec);
        });
    }

    template <int THREADS, int BN>
    __device__ void widen(const unsigned char* slot, __nv_bfloat16* a, int tid) const {
        constexpr int kAPitch = BN + kAPad;
        for_each<kRows * (BN / 16), THREADS>(tid, [&](int i) {
            const int row = i / (BN / 16), cc = (i % (BN / 16)) * 16;
            const uint4 v = *reinterpret_cast<const uint4*>(slot + row * (BN + kCodePad) + cc);
            const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                if constexpr (BITS == 8) {
                    *reinterpret_cast<uint2*>(a + row * kAPitch + cc + 4 * q) = widen_int8_row(w[q]);
                } else {
                    uint2 lo, hi;
                    widen_int4_row(w[q], lo, hi);
                    *reinterpret_cast<uint2*>(a + 2 * row * kAPitch + cc + 4 * q) = lo;
                    *reinterpret_cast<uint2*>(a + (2 * row + 1) * kAPitch + cc + 4 * q) = hi;
                }
            }
        });
    }
};

template <int BITS, int WN, int WM, int FN, int FM>
__global__ void __launch_bounds__(32 * WN * WM)
pim_matmul_mma_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ codes,
                      bool xvec, bool cvec, int M, int K, int N, int k_per_cta, Epilogue ep) {
    const CodeLoader<BITS> loader{codes, BITS == 4 ? K / 2 : K, N, cvec};
    gemm<CodeLoader<BITS>, WN, WM, FN, FM, kCodeStages, kXStages>(loader, x, xvec, M, K, N,
                                                                   k_per_cta, ep);
}

template <int BITS>
struct MatmulKernels {
    template <int WN, int WM, int FN, int FM>
    static auto fn() {
        return pim_matmul_mma_kernel<BITS, WN, WM, FN, FM>;
    }
};

// ---- f32 x: the CUDA-core body of the first port --------------------------

constexpr int kBlockM = 64;                     // output rows per block
constexpr int kBlockN = 64;                     // output columns per block
constexpr int kBlockK = 32;                     // K values per stage
constexpr int kThreadsN = 16;                   // threads across columns
constexpr int kThreadsM = 16;                   // threads across rows
constexpr int kThreads = kThreadsM * kThreadsN;
constexpr int kRows = kBlockM / kThreadsM;      // 4 rows per thread
constexpr int kCols = kBlockN / kThreadsN;      // 4 columns per thread
constexpr int kPad = 4;                         // keeps rows 16-byte aligned

static_assert(kRows == 4 && kCols == 4, "the inner loop reads float4s");
static_assert(kBlockK % 2 == 0, "a stage holds whole nibble pairs");

__device__ __forceinline__ float to_f32(float v) { return v; }

template <int BITS, typename XT>
__global__ void __launch_bounds__(kThreads)
pim_matmul_f32_kernel(const XT* __restrict__ x, const int8_t* __restrict__ codes,
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
void launch_f32(const void* x, const int8_t* codes, const float* scale, const void* bias,
                bool bias_bf16, const void* residual, bool residual_bf16, int activation,
                float* out, int M, int K, int N, cudaStream_t stream) {
    const dim3 grid((N + kBlockN - 1) / kBlockN, (M + kBlockM - 1) / kBlockM);
    pim_matmul_f32_kernel<BITS, XT><<<grid, kThreads, 0, stream>>>(
        static_cast<const XT*>(x), codes, scale, bias, bias_bf16, residual, residual_bf16,
        activation, out, M, K, N);
}

}  // namespace

// Launches the kernel on `stream` with the plan of
// repro_torch/kernels/pim_matmul.py:plan: tile_m x rows by tile_n columns a
// CTA, `cluster` CTAs splitting K in slices of k_per_cta values.  x: (M, K)
// f32 or bf16; codes: (K, N) int8 (bits 8) or (K/2, N) nibbles (bits 4, K
// even); scale: (N,) f32; bias: (N,) f32/bf16 or null; residual: (M, N)
// f32/bf16 or null; out: (M, N) f32.  All contiguous.  f32 x takes the fixed
// plan tile 64 x 64, cluster 1.  Returns cudaErrorInvalidValue for a plan it
// cannot run, else the launch's error.
extern "C" int pim_matmul_launch(const void* x, int x_bf16, const void* codes, const void* scale,
                                 const void* bias, int bias_bf16, const void* residual,
                                 int residual_bf16, void* out, int M, int K, int N, int bits,
                                 int activation, int tile_n, int tile_m, int cluster,
                                 int k_per_cta, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int8_t* w = static_cast<const int8_t*>(codes);
    const float* sc = static_cast<const float*>(scale);
    float* o = static_cast<float*>(out);
    const bool bb = bias_bf16 != 0, rb = residual_bf16 != 0;
    if (!(bits == 8 || (bits == 4 && K % 2 == 0))) return static_cast<int>(cudaErrorInvalidValue);
    if (!x_bf16) {
        if (tile_n != kBlockN || tile_m != kBlockM || cluster != 1 || M < 1 || N < 1 || K < 1)
            return static_cast<int>(cudaErrorInvalidValue);
        if (bits == 8)
            launch_f32<8, float>(x, w, sc, bias, bb, residual, rb, activation, o, M, K, N, s);
        else
            launch_f32<4, float>(x, w, sc, bias, bb, residual, rb, activation, o, M, K, N, s);
        return static_cast<int>(cudaGetLastError());
    }
    const int code_bytes = (bits == 4 ? kStageK / 2 : kStageK) * (tile_n + kCodePad);
    const int smem = smem_bytes(kCodeStages, code_bytes, kXStages, tile_m, tile_n);
    if (!plan_ok(M, K, N, tile_n, tile_m, cluster, k_per_cta, smem))
        return static_cast<int>(cudaErrorInvalidValue);
    const Epilogue ep{sc, bias, bb, residual, rb, activation, o};
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    const bool xvec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && K % 8 == 0;
    const bool cvec = reinterpret_cast<uintptr_t>(codes) % 16 == 0 && N % 16 == 0;
    const int row_tiles = (M + tile_m - 1) / tile_m, col_tiles = (N + tile_n - 1) / tile_n;
    const cudaError_t err =
        bits == 8 ? dispatch<MatmulKernels<8>>(tile_n, tile_m, cluster, row_tiles, col_tiles, smem,
                                               s, xb, w, xvec, cvec, M, K, N, k_per_cta, ep)
                  : dispatch<MatmulKernels<4>>(tile_n, tile_m, cluster, row_tiles, col_tiles, smem,
                                               s, xb, w, xvec, cvec, M, K, N, k_per_cta, ep);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
