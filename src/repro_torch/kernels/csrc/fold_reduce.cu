// fold_reduce: the OpMux halve-and-add fold of the last axis, for Hopper
// (sm_90a).
//
// Replaces src/repro/kernels/fold_reduce.py:_fold_kernel, the Pallas kernel
// the JAX package runs on the TPU.  It computes exactly, bit for bit,
// repro_torch/kernels/fold_reduce.py:fold_reduce_plain: x is (rows, q) with
// q = 2^n, f32 or bf16 widened to f32 on load; at each level h = q/2, q/4,
// ..., 1 element i becomes x[i] + x[i + h]; element 0 is the row's result,
// one f32 per row.
//
// The contract is the association order, not only the sum.  The usual GPU
// reduction (a running sum over a strided loop per thread, then a tree
// across threads) adds the same values in another order and gives other
// bits.  What the design does instead:
//   * T = min(q, 1024) threads per row, 1024 / T rows per block.  Thread t
//     holds the E = q / T elements t, t + T, t + 2T, ...  The levels with
//     h >= T pair element j of that list with element j + h / T, so the
//     thread folds its own list in that tree order: it reads the list in
//     bit-reversed order, which turns the halving tree into the tree of
//     adjacent pairs over the reading order, and a stack of log2(E) + 1
//     partial sums folds that as the values arrive (pairwise summation);
//   * the levels 512 >= h >= 32 run across warps through shared memory, one
//     barrier a level;
//   * the levels h < 32 run in the warp: __shfl_down_sync(v, h, width) gives
//     lane i the value of lane i + h of its row.  For q < 32 a warp holds
//     32 / q rows, each in its own segment of width q;
//   * every add is __fadd_rn (round to nearest, never contracted), and the
//     library builds without fast-math.
// What bounds it on the card: bytes (one add per element read; rows * q
// elements in, rows f32 out).  Loads are coalesced (neighbouring threads
// read neighbouring elements) and each thread issues up to kChunk of them
// before it adds.  It allocates nothing: the caller passes the output and
// the stream.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;   // threads per block
constexpr int kLog2Threads = 10;
constexpr int kWarp = 32;
constexpr int kChunk = 8;        // loads a thread issues before it adds them
constexpr int kMaxDepth = 32;    // the stack of partial sums: log2(E) + 1 < 32

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename XT>
__global__ void __launch_bounds__(kThreads)
fold_reduce_kernel(const XT* __restrict__ x, float* __restrict__ out, long long rows, int q,
                   int log2_t, int log2_e) {
    __shared__ float buf[kThreads];
    const int T = 1 << log2_t, E = 1 << log2_e;
    const int t = threadIdx.x & (T - 1);
    const long long row =
        static_cast<long long>(blockIdx.x) * (kThreads >> log2_t) + (threadIdx.x >> log2_t);
    const bool live = row < rows;

    // Levels h >= T: the thread's own list, in the tree order.
    float v = 0.0f;
    if (live) {
        const XT* xr = x + row * q + t;
        float stack[kMaxDepth];
        int top = 0;
        for (int r0 = 0; r0 < E; r0 += kChunk) {
            float vals[kChunk];
#pragma unroll
            for (int u = 0; u < kChunk; ++u) {
                const int r = r0 + u;
                if (r < E) {
                    const int j = log2_e == 0
                                      ? 0
                                      : static_cast<int>(__brev(static_cast<unsigned>(r)) >>
                                                         (32 - log2_e));
                    vals[u] = to_f32(xr[static_cast<size_t>(j) << log2_t]);
                }
            }
#pragma unroll
            for (int u = 0; u < kChunk; ++u) {
                const int r = r0 + u;
                if (r < E) {
                    // Reading value r closes one subtree for each trailing
                    // 1 bit of r: the earlier (lower-index) half on the
                    // stack plus the later one.
                    float acc = vals[u];
                    for (int c = r; c & 1; c >>= 1) acc = __fadd_rn(stack[--top], acc);
                    stack[top++] = acc;
                }
            }
        }
        v = stack[0];
    }

    // Levels T/2 .. 32: across warps, through shared memory.  T is the same
    // for every thread of the block, so every thread meets every barrier.
    if (T > kWarp) {
        buf[threadIdx.x] = v;
        __syncthreads();
        for (int h = T >> 1; h >= kWarp; h >>= 1) {
            if (t < h) buf[threadIdx.x] = __fadd_rn(buf[threadIdx.x], buf[threadIdx.x + h]);
            __syncthreads();
        }
        v = buf[threadIdx.x];
    }

    // Levels below 32: in the warp (lanes of dead rows take part, unused).
    const int width = T < kWarp ? T : kWarp;
    for (int h = width >> 1; h >= 1; h >>= 1)
        v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, h, width));
    if (live && t == 0) out[row] = v;
}

}  // namespace

// Launches the kernel on `stream`.  x: (rows, q) f32 or bf16, contiguous,
// q a power of two; out: (rows,) f32.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for an empty x or a q that is not a power of two.
extern "C" int fold_reduce_launch(const void* x, int x_bf16, void* out, long long rows, int q,
                                  void* stream) {
    if (rows < 1 || q < 1 || (q & (q - 1)) != 0) return static_cast<int>(cudaErrorInvalidValue);
    int log2_q = 0;
    while ((1 << log2_q) < q) ++log2_q;
    const int log2_t = log2_q < kLog2Threads ? log2_q : kLog2Threads;
    const int log2_e = log2_q - log2_t;
    const long long rows_per_block = kThreads >> log2_t;
    const dim3 grid(static_cast<unsigned>((rows + rows_per_block - 1) / rows_per_block));
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* o = static_cast<float*>(out);
    if (x_bf16)
        fold_reduce_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(x), o, rows, q, log2_t, log2_e);
    else
        fold_reduce_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(x), o,
                                                            rows, q, log2_t, log2_e);
    return static_cast<int>(cudaGetLastError());
}
