// bitplane_matmul: the bit-plane-decomposed matmul (PiCaSO's bit-serial MAC
// in spatial form) with the fused epilogue, any M, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/bitplane.py:35 _bitplane_kernel, the Pallas
// kernel the JAX package runs on the TPU.  It computes the function of
// repro_torch/kernels/bitplane.py:bitplane_matmul_plain:
//   out[m, n] = epilogue(sum_b w_b * sum_k f32(x[m, k]) * plane_b[k, n]),
//   w_b = 2^b for b < B - 1, w_{B-1} = -2^(B-1) (two's complement, LSB first),
//   epilogue = * scale[n] [+ bias[n]] -> activation -> [+ residual[m, n]],
// for planes (B, K, N) int8 in {0, 1} with 1 <= B <= 8, f32 sums and one f32
// store per output.  The weight is formed on load: sum_b w_b plane_b[k, n]
// is the B-bit two's-complement code, an exact integer, so one multiply-add
// per (m, k, n) follows instead of B.  The sums are taken in another order
// than the plain version's (each plane's products, then the weighted
// planes): the two agree to f32 rounding.
//
// What bounds it on the card: the planes' bytes.  They are one byte per bit,
// B K N bytes, 8x the int8 codes at B = 8 (10.5 GB for one pass of
// qwen2-1.5b's 196 linears, against 1.31 GB of int8 codes).
//
// bf16 x runs pim_matmul's main loop (pim_gemm.cuh) with a stage loader of
// its own; what the design does about the bound:
//   * a stage's B plane slices arrive by 16-byte cp.async through a ring two
//     stages deep (x's is four), three 32-K stages ahead of the MMAs (byte
//     loads where N % 16 != 0 or the planes are not 16-byte aligned), so the
//     plane stream runs while MMAs run;
//   * each 32-bit word of four weights becomes four int8 codes without
//     carries, u = OR_b (plane_b word << b) (each byte 0 or 1), then a
//     bytewise sign extension from B bits, (u ^ s) - s with s = 2^(B-1) in
//     each byte (__vsub4): the exact two's-complement codes, formed by the
//     thread that copied the planes.  From there it is pim_matmul's int8
//     path: widen_int8's arithmetic into the bf16 tile, the same MMAs, the
//     same f32 joins at the same K values.  Every plane byte is read from
//     shared memory once per CTA; the planes of a column tile are read from
//     device memory once per x-row tile of the plan.
// Why the two kernels agree bit for bit: at the same bits they take the
// same plan (repro_torch/kernels/pim_matmul.py:plan), whose stage and
// cluster boundaries are K values; the widened tiles hold the same bf16
// values (the codes), so the shared main loop runs the same multiply-adds
// in the same order, then the same rank-order reduction and epilogue.
//
// f32 x keeps the first port's CUDA-core body, the twin of pim_matmul's f32
// body (the weight formed on load, 64 x 64 tiles, f32
// multiply-adds in the same K order): the two agree bit for bit there too.
// It allocates nothing: the caller passes the output and the stream.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "pim_gemm.cuh"

namespace {

using namespace pim_gemm;

// The plane ring is two stages deep (at B = 8 a stage of 256 columns is 68
// KB of planes); x's is four, so stages stream in three ahead.
constexpr int kCodeStages = 2;
constexpr int kXStages = 4;
constexpr int kMaxBits = 8;

// B planes (B, K, N) of 0/1 bytes, a stage at a time, in 16-byte chunks:
// chunk i of a stage is row i / (BN / 16), columns (i % (BN / 16)) * 16 ..
// + 15 of every plane, and the thread that copies a chunk forms its codes.
struct PlaneLoader {
    const int8_t* planes;
    int bits, K, N;
    bool vec;  // rows 16-byte aligned: cp.async

    template <int BN>
    __device__ int code_bytes() const {
        return bits * kStageK * (BN + kCodePad);
    }

    template <int THREADS, int BN>
    __device__ void issue(unsigned char* slot, int k0, int n0, int tid) const {
        constexpr int kPlaneBytes = kStageK * (BN + kCodePad);
        for_each<kStageK * (BN / 16), THREADS>(tid, [&](int i) {
            const int row = i / (BN / 16), cc = (i % (BN / 16)) * 16;
            const int gk = k0 + row, col = n0 + cc;
            for (int b = 0; b < bits; ++b) {
                const int8_t* src = planes + (static_cast<size_t>(b) * K + gk) * N + col;
                stage16(slot + b * kPlaneBytes + row * (BN + kCodePad) + cc, src, planes,
                        gk < K && col < N, col, N, vec);
            }
        });
    }

    // Each 32-bit word of four weights: u = OR_b (plane b's word << b) (each
    // byte 0 or 1, so no carries), then the bytes sign-extended from B bits,
    // (u ^ s) - s with s = 2^(B-1): the two's-complement codes, widened as
    // pim_matmul widens int8 codes.
    template <int THREADS, int BN>
    __device__ void widen(const unsigned char* slot, __nv_bfloat16* a, int tid) const {
        constexpr int kPlaneBytes = kStageK * (BN + kCodePad);
        const uint32_t sign = 0x01010101u << (bits - 1);  // 2^(B-1) in each byte
        for_each<kStageK * (BN / 16), THREADS>(tid, [&](int i) {
            const int row = i / (BN / 16), cc = (i % (BN / 16)) * 16;
            const unsigned char* p = slot + row * (BN + kCodePad) + cc;
            uint32_t u[4] = {0u, 0u, 0u, 0u};
            for (int b = 0; b < bits; ++b) {
                const uint4 v = *reinterpret_cast<const uint4*>(p + b * kPlaneBytes);
                u[0] |= v.x << b;
                u[1] |= v.y << b;
                u[2] |= v.z << b;
                u[3] |= v.w << b;
            }
#pragma unroll
            for (int q = 0; q < 4; ++q)
                *reinterpret_cast<uint2*>(a + row * (BN + kAPad) + cc + 4 * q) =
                    widen_int8_row(__vsub4(u[q] ^ sign, sign));
        });
    }
};

template <int WN, int WM, int FN, int FM>
__global__ void __launch_bounds__(32 * WN * WM)
bitplane_matmul_mma_kernel(const __nv_bfloat16* __restrict__ x,
                           const int8_t* __restrict__ planes, int bits, bool xvec, bool pvec,
                           int M, int K, int N, int k_per_cta, Epilogue ep) {
    const PlaneLoader loader{planes, bits, K, N, pvec};
    gemm<PlaneLoader, WN, WM, FN, FM, kCodeStages, kXStages>(loader, x, xvec, M, K, N, k_per_cta,
                                                             ep);
}

struct BitplaneKernels {
    template <int WN, int WM, int FN, int FM>
    static auto fn() {
        return bitplane_matmul_mma_kernel<WN, WM, FN, FM>;
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
constexpr int kVec = 16;                        // plane bytes per vector load

static_assert(kRows == 4 && kCols == 4, "the inner loop reads float4s");
static_assert(kBlockN % kVec == 0, "a stage row is whole vectors");

__device__ __forceinline__ float to_f32(float v) { return v; }

// The weight of plane b of B: 2^b, and -2^(B-1) for the sign plane.
__device__ __forceinline__ int plane_weight(int b, int bits) {
    return b < bits - 1 ? (1 << b) : -(1 << b);
}

template <typename XT>
__global__ void __launch_bounds__(kThreads)
bitplane_matmul_f32_kernel(const XT* __restrict__ x, const int8_t* __restrict__ planes, int bits,
                           bool vec_ok, const float* __restrict__ scale, const void* bias,
                           bool bias_bf16, const void* residual, bool residual_bf16,
                           int activation, float* __restrict__ out, int M, int K, int N) {
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

// Launches the kernel on `stream` with the plan of
// repro_torch/kernels/pim_matmul.py:plan at these bits (the plan
// pim_matmul takes): tile_m x rows by tile_n columns a CTA, `cluster` CTAs
// splitting K in slices of k_per_cta values.  x: (M, K) f32 or bf16;
// planes: (bits, K, N) int8 in {0, 1}, 1 <= bits <= 8; scale: (N,) f32;
// bias: (N,) f32/bf16 or null; residual: (M, N) f32/bf16 or null; out: (M,
// N) f32.  All contiguous.  f32 x takes the fixed plan tile 64 x 64,
// cluster 1.  Returns cudaErrorInvalidValue for bits out of range or a plan it
// cannot run, else the launch's error.
extern "C" int bitplane_matmul_launch(const void* x, int x_bf16, const void* planes, int bits,
                                      const void* scale, const void* bias, int bias_bf16,
                                      const void* residual, int residual_bf16, void* out, int M,
                                      int K, int N, int activation, int tile_n, int tile_m,
                                      int cluster, int k_per_cta, void* stream) {
    if (bits < 1 || bits > kMaxBits) return static_cast<int>(cudaErrorInvalidValue);
    const bool vec_ok = N % kVec == 0 && reinterpret_cast<uintptr_t>(planes) % kVec == 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int8_t* p = static_cast<const int8_t*>(planes);
    const float* sc = static_cast<const float*>(scale);
    float* o = static_cast<float*>(out);
    const bool bb = bias_bf16 != 0, rb = residual_bf16 != 0;
    if (!x_bf16) {
        if (tile_n != kBlockN || tile_m != kBlockM || cluster != 1 || M < 1 || N < 1 || K < 1)
            return static_cast<int>(cudaErrorInvalidValue);
        const dim3 grid((N + kBlockN - 1) / kBlockN, (M + kBlockM - 1) / kBlockM);
        bitplane_matmul_f32_kernel<float><<<grid, kThreads, 0, s>>>(
            static_cast<const float*>(x), p, bits, vec_ok, sc, bias, bb, residual, rb,
            activation, o, M, K, N);
        return static_cast<int>(cudaGetLastError());
    }
    const int smem = smem_bytes(kCodeStages, bits * kStageK * (tile_n + kCodePad), kXStages,
                                tile_m, tile_n);
    if (!plan_ok(M, K, N, tile_n, tile_m, cluster, k_per_cta, smem))
        return static_cast<int>(cudaErrorInvalidValue);
    const Epilogue ep{sc, bias, bb, residual, rb, activation, o};
    const bool xvec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && K % 8 == 0;
    const int row_tiles = (M + tile_m - 1) / tile_m, col_tiles = (N + tile_n - 1) / tile_n;
    const cudaError_t err = dispatch<BitplaneKernels>(
        tile_n, tile_m, cluster, row_tiles, col_tiles, smem, s,
        static_cast<const __nv_bfloat16*>(x), p, bits, xvec, vec_ok, M, K, N, k_per_cta, ep);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
