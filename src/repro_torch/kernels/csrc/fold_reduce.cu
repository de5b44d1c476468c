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
// The contract is the association order, not only the sum: the usual GPU
// reduction adds the same values in another order and gives other bits.
// The design splits the levels by where their two operands live, so each
// level still pairs i with i + h.  A row is served by L = S * T lanes (T
// threads in each of S CTAs of a cluster; S = 1 unless the row is long and
// the rows few), and lane l holds the 16-byte vectors l, l + L, l + 2L, ...
// of the row, V elements each (4 f32 or 8 bf16), element i = V * (l + k L)
// + j at slot j of its k-th vector.  Then, from the top level down:
//   * h >= V L pairs vector k with vector k + h / (V L) of the same lane and
//     slot: the lane folds its own list.  Up to 8 vectors it holds them all
//     and halves in registers; beyond, it reads them in bit-reversed order,
//     which turns the halving tree into the tree of adjacent pairs over the
//     reading order, folds each 8 in registers and merges with a stack;
//   * V T <= h < V L pairs lane l with lane l + h / V in another CTA of the
//     cluster: the other CTAs write their values into rank 0's shared memory
//     (distributed shared memory), and after one cluster barrier rank 0 runs
//     these levels;
//   * 32 V <= h < V T: across warps of the CTA, through shared memory;
//   * V <= h < 32 V: in the warp, __shfl_down_sync slot by slot (a row of
//     128 f32 is one warp: 5 shuffle levels, then 2 in registers);
//   * h < V: slot j with slot j + h, in registers.
// Every add is __fadd_rn (round to nearest, never contracted), and the
// library builds without fast-math.  The shape of the split (V, T, S and
// the vectors a lane holds) comes from repro_torch/kernels/fold_reduce.py:
// plan, which the CPU tests emulate level by level.
// What bounds it on the card: bytes (one add per element read; rows * q
// elements in, rows f32 out).  Loads are 16 bytes a lane, neighbouring lanes
// on neighbouring vectors.  It allocates nothing: the caller passes the
// output and the stream.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;    // threads per CTA
constexpr int kLog2Threads = 8;
constexpr int kWarp = 32;
constexpr int kChunk = 8;        // vectors a lane folds in registers
constexpr int kMaxCluster = 4;  // CTAs of a row at most (rank 0's inbox holds the rest)
constexpr int kMaxDepth = 32;    // the stack of partial sums

template <typename XT>
struct Vec {
    static constexpr int kN = 16 / static_cast<int>(sizeof(XT));  // elements in 16 bytes
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// The vector at element `at` of a row: V elements, as one 16-byte load where
// `vec` (V is the full 16 bytes and the address aligned), else one by one.
template <typename XT>
__device__ __forceinline__ void load_vec(const XT* __restrict__ xr, long long at, int V, bool vec,
                                         float (&v)[Vec<XT>::kN]) {
    constexpr int kN = Vec<XT>::kN;
    if (vec) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(xr + at));
        const uint32_t words[4] = {w.x, w.y, w.z, w.w};
        if constexpr (kN == 4) {
#pragma unroll
            for (int j = 0; j < 4; ++j) v[j] = __uint_as_float(words[j]);
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                v[2 * j] = __uint_as_float(words[j] << 16);              // element 2j
                v[2 * j + 1] = __uint_as_float(words[j] & 0xFFFF0000u);  // element 2j + 1
            }
        }
    } else {
#pragma unroll
        for (int j = 0; j < kN; ++j) v[j] = j < V ? to_f32(xr[at + j]) : 0.0f;
    }
}

// Vectors [r0, r0 + kChunk) of the lane's reading order folded as adjacent
// pairs; vector r of the order is list vector k = brev(r) (log2_e bits).
template <typename XT>
__device__ __forceinline__ void fold_chunk(const XT* __restrict__ xr, int lane, int log2_l,
                                           int log2_e, int V, bool vec, int r0,
                                           float (&out)[Vec<XT>::kN]) {
    constexpr int kN = Vec<XT>::kN;
    float v[kChunk][kN];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
        const int k = static_cast<int>(__brev(static_cast<unsigned>(r0 + u)) >> (32 - log2_e));
        const long long lane_vec = static_cast<long long>(lane) + (static_cast<long long>(k) << log2_l);
        load_vec<XT>(xr, lane_vec * V, V, vec, v[u]);
    }
#pragma unroll
    for (int w = 1; w < kChunk; w *= 2)
#pragma unroll
        for (int u = 0; u + w < kChunk; u += 2 * w)
#pragma unroll
            for (int j = 0; j < kN; ++j) v[u][j] = __fadd_rn(v[u][j], v[u + w][j]);
#pragma unroll
    for (int j = 0; j < kN; ++j) out[j] = v[0][j];
}

// Grid: ceil(rows / (kThreads / T)) CTAs, or rows * S CTAs in clusters of S.
template <typename XT>
__global__ void __launch_bounds__(kThreads)
fold_reduce_kernel(const XT* __restrict__ x, float* __restrict__ out, long long rows, int q,
                   int log2_v, int log2_t, int log2_s, int log2_e, bool vec) {
    constexpr int kN = Vec<XT>::kN;
    __shared__ float buf[kN][kThreads];
    __shared__ float inbox[kMaxCluster - 1][kN][kThreads];
    const int V = 1 << log2_v, T = 1 << log2_t, S = 1 << log2_s, E = 1 << log2_e;
    const int t = threadIdx.x & (T - 1);
    const int rank = blockIdx.x & (S - 1);
    const long long row = static_cast<long long>(blockIdx.x >> log2_s) * (kThreads >> log2_t) +
                          (threadIdx.x >> log2_t);
    const bool live = row < rows;
    const int lane = rank * T + t;
    const int log2_l = log2_s + log2_t;  // lanes a row has

    // Levels h >= V L: the lane's own list.
    float a[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) a[j] = 0.0f;
    if (live) {
        const XT* xr = x + row * q;
        if (E <= kChunk) {
            // The halving tree over the list is the adjacent-pair tree over
            // the reversed reading order: read in list order and halve.
            float v[kChunk][kN];
#pragma unroll
            for (int u = 0; u < kChunk; ++u)
                if (u < E) {
                    const long long lane_vec = static_cast<long long>(lane) + (static_cast<long long>(u) << log2_l);
                    load_vec<XT>(xr, lane_vec * V, V, vec, v[u]);
                }
#pragma unroll
            for (int h = kChunk / 2; h >= 1; h /= 2)
                if (h < E)
#pragma unroll
                    for (int u = 0; u < h; ++u)
#pragma unroll
                        for (int j = 0; j < kN; ++j) v[u][j] = __fadd_rn(v[u][j], v[u + h][j]);
#pragma unroll
            for (int j = 0; j < kN; ++j) a[j] = v[0][j];
        } else {
            float stack[kMaxDepth][kN];
            int top = 0;
            for (int c = 0; c < (E >> 3); ++c) {
                float acc[kN];
                fold_chunk<XT>(xr, lane, log2_l, log2_e, V, vec, c * kChunk, acc);
                // Chunk c closes one subtree for each trailing 1 bit of c:
                // the earlier half on the stack plus the later one.
                for (int cc = c; cc & 1; cc >>= 1) {
                    --top;
#pragma unroll
                    for (int j = 0; j < kN; ++j) acc[j] = __fadd_rn(stack[top][j], acc[j]);
                }
#pragma unroll
                for (int j = 0; j < kN; ++j) stack[top][j] = acc[j];
                ++top;
            }
#pragma unroll
            for (int j = 0; j < kN; ++j) a[j] = stack[0][j];
        }
    }

    // Levels V T <= h < V L: lane l + h / V sits in CTA rank + h / (V T).
    // The other CTAs leave their lanes' values in rank 0's inbox through
    // distributed shared memory and finish; after one cluster barrier rank 0
    // runs these levels on its own copy, pairing rank r with rank r + d.
    if (S > 1) {
        cg::cluster_group cluster = cg::this_cluster();
        if (rank != 0) {
            float* to = cluster.map_shared_rank(&inbox[0][0][0], 0);
#pragma unroll
            for (int j = 0; j < kN; ++j) to[((rank - 1) * kN + j) * kThreads + threadIdx.x] = a[j];
        }
        cluster.sync();
        if (rank != 0) return;
        float r[kMaxCluster][kN];
#pragma unroll
        for (int j = 0; j < kN; ++j) r[0][j] = a[j];
#pragma unroll
        for (int c = 1; c < kMaxCluster; ++c)
            if (c < S)
#pragma unroll
                for (int j = 0; j < kN; ++j) r[c][j] = inbox[c - 1][j][threadIdx.x];
#pragma unroll
        for (int d = kMaxCluster / 2; d >= 1; d /= 2)
            if (d < S)
#pragma unroll
                for (int c = 0; c < d; ++c)
#pragma unroll
                    for (int j = 0; j < kN; ++j) r[c][j] = __fadd_rn(r[c][j], r[c + d][j]);
#pragma unroll
        for (int j = 0; j < kN; ++j) a[j] = r[0][j];
    }

    // Levels 32 V <= h < V T: across warps, through shared memory.  T is the
    // same for every thread of the CTA, so every thread meets every barrier.
    if (T > kWarp) {
#pragma unroll
        for (int j = 0; j < kN; ++j) buf[j][threadIdx.x] = a[j];
        __syncthreads();
        for (int d = T >> 1; d >= kWarp; d >>= 1) {
            if (t < d)
#pragma unroll
                for (int j = 0; j < kN; ++j)
                    buf[j][threadIdx.x] = __fadd_rn(buf[j][threadIdx.x], buf[j][threadIdx.x + d]);
            __syncthreads();
        }
#pragma unroll
        for (int j = 0; j < kN; ++j) a[j] = buf[j][threadIdx.x];
    }

    // Levels V <= h < 32 V: in the warp, slot by slot (lanes of dead rows
    // take part, unused).
    const int width = T < kWarp ? T : kWarp;
    for (int d = width >> 1; d >= 1; d >>= 1)
#pragma unroll
        for (int j = 0; j < kN; ++j)
            if (j < V) a[j] = __fadd_rn(a[j], __shfl_down_sync(0xffffffffu, a[j], d, width));

    // Levels h < V: in registers.
#pragma unroll
    for (int h = kN / 2; h >= 1; h /= 2)
        if (h < V)
#pragma unroll
            for (int j = 0; j < h; ++j) a[j] = __fadd_rn(a[j], a[j + h]);
    if (live && t == 0) out[row] = a[0];
}

template <typename XT>
cudaError_t launch(const XT* x, float* out, long long rows, int q, int log2_v, int log2_t,
                   int log2_s, int log2_e, bool vec, cudaStream_t stream) {
    const long long blocks = log2_s > 0 ? rows << log2_s
                                        : (rows + (kThreads >> log2_t) - 1) / (kThreads >> log2_t);
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    if (log2_s == 0) {
        fold_reduce_kernel<XT><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
            x, out, rows, q, log2_v, log2_t, log2_s, log2_e, vec);
        return cudaSuccess;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(blocks));
    cfg.blockDim = dim3(kThreads);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1u << log2_s;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, fold_reduce_kernel<XT>, x, out, rows, q, log2_v, log2_t,
                              log2_s, log2_e, vec);
}

}  // namespace

// Launches the kernel on `stream` with the plan of
// repro_torch/kernels/fold_reduce.py:plan: V = 2^log2_v elements a vector,
// T = 2^log2_t threads of a row in a CTA, S = 2^log2_s CTAs of a row (a
// cluster), E = 2^log2_e vectors a lane, V T S E = q.  x: (rows, q) f32 or
// bf16, contiguous, q a power of two; out: (rows,) f32.  Returns
// cudaErrorInvalidValue for an empty x or a plan it cannot run, else the
// launch's error.
extern "C" int fold_reduce_launch(const void* x, int x_bf16, void* out, long long rows, int q,
                                  int log2_v, int log2_t, int log2_s, int log2_e, void* stream) {
    const int elems = x_bf16 ? Vec<__nv_bfloat16>::kN : Vec<float>::kN;
    const bool ok = rows >= 1 && q >= 1 && (q & (q - 1)) == 0 && log2_v >= 0 && log2_t >= 0 &&
                    log2_s >= 0 && log2_e >= 0 && (1 << log2_v) <= elems &&
                    log2_t <= kLog2Threads && (1 << log2_s) <= kMaxCluster &&
                    (log2_s == 0 || log2_t == kLog2Threads) &&
                    log2_v + log2_t + log2_s + log2_e < 31 &&
                    (1LL << (log2_v + log2_t + log2_s + log2_e)) == q;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    const bool vec = (1 << log2_v) == elems && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* o = static_cast<float*>(out);
    const cudaError_t err =
        x_bf16 ? launch(static_cast<const __nv_bfloat16*>(x), o, rows, q, log2_v, log2_t, log2_s,
                        log2_e, vec, s)
               : launch(static_cast<const float*>(x), o, rows, q, log2_v, log2_t, log2_s, log2_e,
                        vec, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
