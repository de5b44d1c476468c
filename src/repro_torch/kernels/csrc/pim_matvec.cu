// pim_matvec: decode-shaped (M <= 8 rows) GEMV on PIM-quantized weights with
// the fused epilogue, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/pim_matvec.py:_mv_kernel, the Pallas kernel the
// JAX package runs on the TPU.  It computes exactly
// repro_torch/kernels/pim_matvec.py:pim_matvec_plain:
//   out[m, n] = epilogue(sum_k f32(x[m, k]) * code[k, n]),
//   epilogue  = * scale[n] [+ bias[n]] -> activation -> [+ residual[m, n]],
// with an f32 accumulator and one f32 store per output.  Codes are int8
// (K, N), or int4 nibble-packed (K/2, N) with the low nibble holding the
// even K row and sign extension ((v & 0xF) ^ 8) - 8.
//
// What bounds it on the card: HBM bytes.  At the decode path's M = 4 a weight
// byte feeds 4 (int8) or 8 (int4) multiply-adds, 8 or 16 f32 operations,
// below the ~20 operations per byte (67 TFLOP/s f32 over 3.35 TB/s) where
// the H100's CUDA cores become the limit (int4 at M = 8 crosses it); the
// codes are the only large operand and are read exactly once.  What the
// design does about it:
//   * codes stay packed in HBM (1 byte, or half a byte, per weight) and are
//     widened to f32 in registers next to the multiply: no dequantized copy
//     of the weight is ever written;
//   * neighbouring threads read neighbouring code bytes of one row (the
//     weight is row-major (K, N) with N contiguous), 4 bytes per thread, so
//     a warp reads 128 contiguous bytes; each thread issues the loads of
//     kUnroll rows before it uses them, to keep more bytes in flight;
//   * the M rows of x are staged once per block in shared memory as f32 and
//     read by every thread as a broadcast;
//   * the Pallas kernel walks K sequentially with the output tile resident;
//     here K is split across blocks instead (grid = column blocks x K
//     splits), because a grid over N alone gives 1 to 35 blocks at the
//     model's widths and leaves most of the 132 SMs idle.  The split sums go
//     to an f32 scratch and a second, deterministic pass adds them in split
//     order and runs the epilogue, so results do not change from run to run
//     (no atomics).
// It allocates nothing: the caller passes the output and the scratch, and
// the stream.  Faster versions (16-byte loads, TMA, a persistent grid that
// reduces in shared memory across a cluster) are later work.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

constexpr int kThreadsN = 64;               // threads across columns
constexpr int kThreadsK = 4;                // threads across code rows
constexpr int kCols = 4;                    // adjacent columns per thread
constexpr int kBlockN = kThreadsN * kCols;  // 256 columns per block
constexpr int kStageRows = 128;             // code rows of x staged at once
constexpr int kUnroll = 4;                  // rows loaded before use

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// The kCols code bytes of one row from column col0 on; columns past N read 0.
__device__ __forceinline__ void load_codes(const int8_t* __restrict__ row, int col0,
                                           int n, bool vec, int8_t (&w)[kCols]) {
    if (vec) {
        const char4 v = *reinterpret_cast<const char4*>(row + col0);
        w[0] = v.x;
        w[1] = v.y;
        w[2] = v.z;
        w[3] = v.w;
    } else {
#pragma unroll
        for (int c = 0; c < kCols; ++c) w[c] = (col0 + c < n) ? row[col0 + c] : 0;
    }
}

// acc += x rows of code row r (staged in xs) times the row's codes.
template <int M, int BITS, int XW>
__device__ __forceinline__ void accumulate(float (&acc)[M][kCols], const float (&xs)[M][XW],
                                           int r, const int8_t (&w)[kCols]) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
        if constexpr (BITS == 8) {
            const float wf = static_cast<float>(w[c]);
#pragma unroll
            for (int m = 0; m < M; ++m) acc[m][c] = fmaf(xs[m][r], wf, acc[m][c]);
        } else {
            const int v = w[c];
            const float lo = static_cast<float>(((v & 0xF) ^ 8) - 8);         // K row 2r
            const float hi = static_cast<float>((((v >> 4) & 0xF) ^ 8) - 8);  // K row 2r+1
#pragma unroll
            for (int m = 0; m < M; ++m) {
                acc[m][c] = fmaf(xs[m][2 * r], lo, acc[m][c]);
                acc[m][c] = fmaf(xs[m][2 * r + 1], hi, acc[m][c]);
            }
        }
    }
}

// Pass 1: block (bx, by) sums code rows [by * rows_per_split, ...) for the
// 256 columns of bx and writes partial[by, m, n].
template <int M, int BITS, typename XT>
__global__ void __launch_bounds__(kThreadsN * kThreadsK)
pim_matvec_partial(const XT* __restrict__ x, const int8_t* __restrict__ codes,
                   float* __restrict__ partial, int K, int N, int rows,
                   int rows_per_split, bool vec) {
    constexpr int kPerRow = BITS == 4 ? 2 : 1;  // K values one code row holds
    constexpr int kXW = kStageRows * kPerRow;
    __shared__ float xs[M][kXW];
    __shared__ float red[kThreadsK - 1][M][kCols][kThreadsN];

    const int tx = threadIdx.x, ty = threadIdx.y;
    const int tid = ty * kThreadsN + tx;
    const int col0 = blockIdx.x * kBlockN + tx * kCols;
    const int r_begin = blockIdx.y * rows_per_split;
    const int r_end = min(r_begin + rows_per_split, rows);

    float acc[M][kCols];
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[m][c] = 0.0f;

    for (int s0 = r_begin; s0 < r_end; s0 += kStageRows) {
        const int n_rows = min(kStageRows, r_end - s0);
        const int n_x = n_rows * kPerRow;
        for (int i = tid; i < M * n_x; i += kThreadsN * kThreadsK) {
            const int m = i / n_x, j = i - m * n_x;
            xs[m][j] = to_f32(x[static_cast<size_t>(m) * K + static_cast<size_t>(s0) * kPerRow + j]);
        }
        __syncthreads();
        if (col0 < N) {
            const int8_t* base = codes + static_cast<size_t>(s0) * N;
            int r = ty;
            for (; r + (kUnroll - 1) * kThreadsK < n_rows; r += kUnroll * kThreadsK) {
                int8_t w[kUnroll][kCols];
#pragma unroll
                for (int u = 0; u < kUnroll; ++u)
                    load_codes(base + static_cast<size_t>(r + u * kThreadsK) * N, col0, N, vec, w[u]);
#pragma unroll
                for (int u = 0; u < kUnroll; ++u)
                    accumulate<M, BITS, kXW>(acc, xs, r + u * kThreadsK, w[u]);
            }
            for (; r < n_rows; r += kThreadsK) {
                int8_t w[kCols];
                load_codes(base + static_cast<size_t>(r) * N, col0, N, vec, w);
                accumulate<M, BITS, kXW>(acc, xs, r, w);
            }
        }
        __syncthreads();
    }

    // Add the kThreadsK row-interleaved sums of each column, in ty order.
    if (ty > 0) {
#pragma unroll
        for (int m = 0; m < M; ++m)
#pragma unroll
            for (int c = 0; c < kCols; ++c) red[ty - 1][m][c][tx] = acc[m][c];
    }
    __syncthreads();
    if (ty == 0 && col0 < N) {
#pragma unroll
        for (int m = 0; m < M; ++m) {
            float* out = partial + (static_cast<size_t>(blockIdx.y) * M + m) * N;
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
                float v = acc[m][c];
#pragma unroll
                for (int t = 0; t < kThreadsK - 1; ++t) v += red[t][m][c][tx];
                if (col0 + c < N) out[col0 + c] = v;
            }
        }
    }
}

// Pass 2: out[m, n] = epilogue(sum over splits, in split order).
__global__ void pim_matvec_reduce(const float* __restrict__ partial, int splits, int M, int N,
                                  const float* __restrict__ scale, const void* bias,
                                  bool bias_bf16, const void* residual, bool residual_bf16,
                                  int activation, float* __restrict__ out) {
    const size_t total = static_cast<size_t>(M) * N;
    const size_t mn = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (mn >= total) return;
    const int n = static_cast<int>(mn % N);
    float acc = 0.0f;
    for (int s = 0; s < splits; ++s) acc += partial[s * total + mn];
    out[mn] = pim_epilogue(acc, scale[n], bias, bias_bf16, residual, residual_bf16,
                           activation, n, mn);
}

template <int M, int BITS, typename XT>
void launch_partial(const void* x, const int8_t* codes, float* partial, int K, int N,
                    int rows, int rows_per_split, int splits, bool vec, cudaStream_t stream) {
    const dim3 grid((N + kBlockN - 1) / kBlockN, splits);
    const dim3 block(kThreadsN, kThreadsK);
    pim_matvec_partial<M, BITS, XT><<<grid, block, 0, stream>>>(
        static_cast<const XT*>(x), codes, partial, K, N, rows, rows_per_split, vec);
}

template <int BITS, typename XT>
bool dispatch_rows(int M, const void* x, const int8_t* codes, float* partial, int K, int N,
                   int rows, int rows_per_split, int splits, bool vec, cudaStream_t stream) {
#define PIM_MATVEC_CASE(m)                                                                 \
    case m:                                                                                \
        launch_partial<m, BITS, XT>(x, codes, partial, K, N, rows, rows_per_split, splits, \
                                    vec, stream);                                          \
        return true;
    switch (M) {
        PIM_MATVEC_CASE(1)
        PIM_MATVEC_CASE(2)
        PIM_MATVEC_CASE(3)
        PIM_MATVEC_CASE(4)
        PIM_MATVEC_CASE(5)
        PIM_MATVEC_CASE(6)
        PIM_MATVEC_CASE(7)
        PIM_MATVEC_CASE(8)
        default:
            return false;
    }
#undef PIM_MATVEC_CASE
}

}  // namespace

// Launches both passes on `stream`.  x: (M, K) f32 or bf16; codes: (K, N)
// int8 (bits 8) or (K/2, N) nibbles (bits 4); scale: (N,) f32; bias: (N,)
// f32/bf16 or null; residual: (M, N) f32/bf16 or null; partial: (splits, M, N)
// f32 scratch; out: (M, N) f32.  All contiguous.  Returns cudaGetLastError().
extern "C" int pim_matvec_launch(const void* x, int x_bf16, const void* codes, const void* scale,
                                 const void* bias, int bias_bf16, const void* residual,
                                 int residual_bf16, void* partial, void* out, int M, int K,
                                 int N, int bits, int activation, int splits,
                                 int rows_per_split, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int8_t* w = static_cast<const int8_t*>(codes);
    float* part = static_cast<float*>(partial);
    const int rows = bits == 4 ? K / 2 : K;
    const bool vec = N % kCols == 0 && reinterpret_cast<uintptr_t>(codes) % kCols == 0;
    bool ok = false;
    if (bits == 8) {
        ok = x_bf16 ? dispatch_rows<8, __nv_bfloat16>(M, x, w, part, K, N, rows, rows_per_split, splits, vec, s)
                    : dispatch_rows<8, float>(M, x, w, part, K, N, rows, rows_per_split, splits, vec, s);
    } else if (bits == 4) {
        ok = x_bf16 ? dispatch_rows<4, __nv_bfloat16>(M, x, w, part, K, N, rows, rows_per_split, splits, vec, s)
                    : dispatch_rows<4, float>(M, x, w, part, K, N, rows, rows_per_split, splits, vec, s);
    }
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t total = static_cast<size_t>(M) * N;
    const int threads = 256;
    pim_matvec_reduce<<<static_cast<unsigned>((total + threads - 1) / threads), threads, 0, s>>>(
        part, splits, M, N, static_cast<const float*>(scale), bias, bias_bf16 != 0, residual,
        residual_bf16 != 0, activation, static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}
