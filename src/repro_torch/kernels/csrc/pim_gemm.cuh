// The main loop shared by pim_matmul and bitplane_matmul for bf16 x, on
// Hopper's tensor cores (sm_90a).
//
// Both kernels compute out[m, n] = epilogue(sum_k x[m, k] * code[k, n]) for
// x (M, K) bf16 and integer codes that are exact in bf16; they differ only
// in how a stage of codes reaches shared memory (a Loader: int8 codes,
// nibble-packed int4 codes, or B one-bit planes).  Everything after that is
// this file: for the same x, the same codes and the same plan the two run
// the same multiply-adds in the same order, so they agree bit for bit.
//
// The product is formed transposed, out^T = codes^T . x^T, as pim_matvec
// does: mma.sync m16n8k16 with A = 16 weight columns x 16 K values of the
// codes and B = 16 K values x 8 rows of x, bf16 in, f32 accumulation.
//   * A CTA covers kBN = 128 or 256 weight columns x kBM = 16..128 rows of x
//     and its cluster rank's slice of K (k_per_cta values, a multiple of
//     kStageK).  WN x WM warps each take 16 FN columns x 8 FM rows (up to
//     64 x 64).
//   * Each kStageK-deep stage of codes moves into a CODE_STAGES-deep ring,
//     and of x into an X_STAGES-deep ring, of shared memory by 16-byte
//     cp.async (zero filled past M, N and K), kDepth stages ahead of the one
//     the MMAs use; operands that are not 16-byte aligned take synchronous
//     narrower loads that give the same values.  x is row-major (M, K),
//     already the K-contiguous layout B needs: ldmatrix (no transpose)
//     reads it.
//   * The Loader widens each stage's codes once per CTA into a bf16 tile
//     [kStageK][kBN] (two buffers), which every warp reads with
//     ldmatrix.trans: a code is widened once per CTA, not once per x row.
//     Stage s + 1 is widened while stage s's MMAs run, so a code ring slot
//     is free once its stage is widened.
//   * The tensor cores sum each 16 K values' products from zero, and those
//     sums join the f32 running sums by f32 adds, so long sums round as f32
//     adds do.  A warp takes its 16-column groups one at a time, so only one
//     group's tensor-core sums (4 FM registers) live beside the running sums.
//   * The CTAs of a cluster split K; each leaves its partial tile in its
//     shared memory, and after a cluster barrier CTA r reads the partial
//     tiles' rows [r R, (r + 1) R) (R = kBM / cluster) from all of them
//     (distributed shared memory), adds them in rank order, runs the
//     epilogue and stores.  No atomics, no scratch in HBM, no second kernel:
//     the same result every run.
#pragma once

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "pim_mma.cuh"

namespace pim_gemm {

namespace cg = cooperative_groups;

constexpr int kStageK = 32;           // K values a ring stage holds
constexpr int kCodePad = 16;          // bytes after each staged code (or plane) row
constexpr int kAPad = 8;              // bf16 after each widened code row
constexpr int kXPitch = kStageK + 8;  // bf16 a staged x row takes
constexpr int kOutPad = 4;            // f32 after each row of a partial tile
constexpr int kSmemMax = 232448;      // shared memory a block may have

// The epilogue's operands and the output.
struct Epilogue {
    const float* scale;
    const void* bias;
    bool bias_bf16;
    const void* residual;
    bool residual_bf16;
    int activation;
    float* out;
};

// fn(i) for i = tid, tid + THREADS, ... below TOTAL, unrolled.
template <int TOTAL, int THREADS, class F>
__device__ __forceinline__ void for_each(int tid, F&& fn) {
#pragma unroll
    for (int i0 = 0; i0 < TOTAL; i0 += THREADS) {
        const int i = i0 + tid;
        if (TOTAL % THREADS == 0 || i < TOTAL) fn(i);
    }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// d = a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 out: a stage's first
// product, which starts its sums from zero.
__device__ __forceinline__ void mma_bf16_first(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f), "f"(0.0f),
          "f"(0.0f), "f"(0.0f));
}

// Four int8 codes of one K row (the bytes of w, columns n .. n + 3) as two
// bf16x2: (n, n + 1) and (n + 2, n + 3).  widen_int8's arithmetic, paired
// along the row.
__device__ __forceinline__ uint2 widen_int8_row(uint32_t w) {
    const uint32_t u = w ^ 0x80808080u;  // code + 128
    const uint32_t f0 = __float_as_uint(byte_f32(u, 0, 8388736.0f));  // 2^23 + 128
    const uint32_t f1 = __float_as_uint(byte_f32(u, 1, 8388736.0f));
    const uint32_t f2 = __float_as_uint(byte_f32(u, 2, 8388736.0f));
    const uint32_t f3 = __float_as_uint(byte_f32(u, 3, 8388736.0f));
    return make_uint2(__byte_perm(f0, f1, 0x7632), __byte_perm(f2, f3, 0x7632));
}

// Four packed int4 bytes of one packed row (columns n .. n + 3) as the bf16
// codes of its two K rows: lo, the low nibbles (K row 2p), and hi, the high
// nibbles (2p + 1), each two bf16x2 along the row.  widen_int4's bf16 magic:
// a biased nibble v under 0x43 is 128 + v; minus 136 leaves the code.
__device__ __forceinline__ void widen_int4_row(uint32_t w, uint2& lo, uint2& hi) {
    const uint32_t l = (w & 0x0F0F0F0Fu) ^ 0x08080808u;  // nibble + 8
    const uint32_t h = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
    const __nv_bfloat162 bias = __floats2bfloat162_rn(136.0f, 136.0f);
    uint32_t v[4] = {__byte_perm(l, 0x43434343u, 0x4140), __byte_perm(l, 0x43434343u, 0x4342),
                     __byte_perm(h, 0x43434343u, 0x4140), __byte_perm(h, 0x43434343u, 0x4342)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        __nv_bfloat162 b = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&v[j]), bias);
        v[j] = *reinterpret_cast<uint32_t*>(&b);
    }
    lo = make_uint2(v[0], v[1]);
    hi = make_uint2(v[2], v[3]);
}

// 16 bytes at src (columns col .. col + 15 of a row of n bytes) into shared
// memory at dst: one cp.async where the rows are 16-byte aligned (vec), else
// byte loads; zeros where !in and past column n.
__device__ __forceinline__ void stage16(unsigned char* dst, const int8_t* src, const int8_t* base,
                                        bool in, int col, int n, bool vec) {
    if (vec) {
        cp_async16(smem_addr(dst), in ? src : base, in);
        return;
    }
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (in)
        for (int c = 0; c < 16 && col + c < n; ++c)
            w[c / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(src[c])) << (8 * (c % 4));
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Shared-memory bytes of a CTA of bm x bn: the code ring (code_stages slots
// of code_bytes), the x ring (x_stages slots of bm staged rows) and the three
// widened tiles, or the CTA's partial tile that reuses them after the main
// loop, whichever is larger.
__host__ __device__ inline int smem_bytes(int code_stages, int code_bytes, int x_stages, int bm,
                                          int bn) {
    const int ring = code_stages * code_bytes + x_stages * bm * kXPitch * 2 +
                     3 * kStageK * (bn + kAPad) * 2;
    const int inbox = bm * (bn + kOutPad) * 4;
    return ring > inbox ? ring : inbox;
}

// The main loop and the cluster's reduction.  Grid (cluster, row tiles,
// column tiles), block 32 WN WM threads, cluster (cluster, 1, 1): CTA rank r
// sums K values [r k_per_cta, (r + 1) k_per_cta) of columns blockIdx.z kBN
// .. + kBN - 1 for x rows blockIdx.y kBM .. + kBM - 1.  Loader:
// code_bytes<BN>() (the bytes of one code ring slot), issue<THREADS, BN>(slot,
// k0, n0, tid) (start moving the codes of K values k0 .. k0 + kStageK - 1
// into the slot) and widen<THREADS, BN>(slot, a, tid) (the slot's codes as
// the bf16 tile a, kStageK rows of BN + kAPad).
template <class Loader, int WN, int WM, int FN, int FM, int CODE_STAGES, int X_STAGES>
__device__ __forceinline__ void gemm(const Loader& loader, const __nv_bfloat16* __restrict__ x,
                                     bool xvec, int M, int K, int N, int k_per_cta,
                                     const Epilogue& ep) {
    constexpr int kThreads = 32 * WN * WM;
    constexpr int kBN = 16 * FN * WN, kBM = 8 * FM * WM;
    constexpr int kAPitch = kBN + kAPad, kOutPitch = kBN + kOutPad;
    // Stage s + kDepth starts streaming in while stage s's MMAs run, and
    // stage s + 2 is widened after them (into one of three bf16 tiles).  Each
    // thread widens the code chunks it copied itself, so a code slot is free
    // for that thread's next copy once it has widened it: stage s + kDepth
    // reuses the slot of stage s + kDepth - CODE_STAGES, widened by then if
    // kDepth <= CODE_STAGES + 1.  Its x slot held stage s + kDepth -
    // X_STAGES, whose MMAs are done if kDepth <= X_STAGES - 1.
    constexpr int kDepth = CODE_STAGES + 1 < X_STAGES - 1 ? CODE_STAGES + 1 : X_STAGES - 1;
    static_assert(FM % 2 == 0, "x fragments load in pairs of 8-row groups");
    static_assert(kDepth >= 3, "stage s + 2 streams in while stage s's MMAs run");

    extern __shared__ __align__(16) unsigned char smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = blockIdx.x, csize = gridDim.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wn = warp % WN, wm = warp / WN;
    const int g = lane >> 2, t = lane & 3;
    const int m0 = blockIdx.y * kBM, n0 = blockIdx.z * kBN;
    const int k_begin = rank * k_per_cta;
    const int k_end = min(K, k_begin + k_per_cta);
    const int stages = (k_end - k_begin + kStageK - 1) / kStageK;

    const int code_bytes = loader.template code_bytes<kBN>();
    unsigned char* code_ring = smem;
    __nv_bfloat16* x_ring = reinterpret_cast<__nv_bfloat16*>(smem + CODE_STAGES * code_bytes);
    __nv_bfloat16* a_tiles = x_ring + X_STAGES * kBM * kXPitch;  // three tiles

    // Stage st: the loader's codes into code slot st % CODE_STAGES, x's rows
    // m0 .. m0 + kBM - 1 at K values k0 .. k0 + kStageK - 1 into x slot
    // st % X_STAGES (zero past M and K); one cp.async group.
    auto issue = [&](int st) {
        if (st < stages) {
            const int k0 = k_begin + st * kStageK;
            loader.template issue<kThreads, kBN>(code_ring + (st % CODE_STAGES) * code_bytes, k0,
                                                 n0, tid);
            __nv_bfloat16* xs = x_ring + (st % X_STAGES) * kBM * kXPitch;
            constexpr int kChunks = kStageK / 8;  // 16-byte pieces of an x row
            for_each<kBM * kChunks, kThreads>(tid, [&](int i) {
                const int r = i / kChunks, kk = k0 + (i % kChunks) * 8;
                const int m = m0 + r;
                const __nv_bfloat16* src = x + static_cast<size_t>(m) * K + kk;
                __nv_bfloat16* dst = xs + r * kXPitch + (i % kChunks) * 8;
                if (xvec) {
                    const bool in = m < M && kk < K;
                    cp_async16(smem_addr(dst), in ? src : x, in);
                } else {
                    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
                    uint32_t w[4] = {0u, 0u, 0u, 0u};
                    if (m < M)
                        for (int j = 0; j < 8 && kk + j < K; ++j)
                            w[j / 2] |= static_cast<uint32_t>(s[j]) << (16 * (j % 2));
                    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
                }
            });
        }
        cp_async_commit();
    };
    auto widen = [&](int st) {
        if (st < stages)
            loader.template widen<kThreads, kBN>(code_ring + (st % CODE_STAGES) * code_bytes,
                                                 a_tiles + (st % 3) * kStageK * kAPitch, tid);
    };

    float acc[FN][FM][4];
#pragma unroll
    for (int i = 0; i < FN; ++i)
#pragma unroll
        for (int j = 0; j < FM; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

    // Launched with programmatic stream serialization, the CTAs may start
    // while the kernel before them in the stream finishes: nothing above
    // reads global memory, nothing below runs before that kernel's results
    // are visible.
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
#pragma unroll
    for (int st = 0; st < kDepth - 1; ++st) issue(st);
    cp_async_wait<kDepth - 3>();  // stages 0 and 1 have landed
    widen(0);
    widen(1);
    issue(kDepth - 1);  // into stage 0's code slot, widened
    __syncthreads();

    // Lane L's ldmatrix row: A (ldmatrix.trans of the [k][n] tile) reads
    // matrices (k +0, n +0), (k +0, n +8), (k +8, n +0), (k +8, n +8), which
    // are A's fragments a0a1, a2a3, a4a5, a6a7; B (ldmatrix of x's [m][k]
    // rows) reads (m +0, k +0), (m +0, k +8), (m +8, k +0), (m +8, k +8),
    // which are b0b1 and b2b3 of two 8-row groups.
    const int a_k = ((lane >> 4) & 1) * 8 + (lane & 7);
    const int a_n = wn * 16 * FN + ((lane >> 3) & 1) * 8;
    const int b_m = wm * 8 * FM + ((lane >> 4) & 1) * 8 + (lane & 7);
    const int b_k = ((lane >> 3) & 1) * 8;

    for (int s = 0; s < stages; ++s) {
        // Tile s and x's stage s are visible since the last barrier.
        const __nv_bfloat16* a_tile = a_tiles + (s % 3) * kStageK * kAPitch;
        const __nv_bfloat16* xs = x_ring + (s % X_STAGES) * kBM * kXPitch;
#pragma unroll
        for (int kk = 0; kk < kStageK; kk += 16) {
            uint32_t b[FM][2];
#pragma unroll
            for (int j = 0; j < FM; j += 2) {
                uint32_t r[4];
                ldmatrix_x4(r, smem_addr(xs + (b_m + j * 8) * kXPitch + kk + b_k));
                b[j][0] = r[0];
                b[j][1] = r[1];
                b[j + 1][0] = r[2];
                b[j + 1][1] = r[3];
            }
            // One 16-column group at a time: the tensor cores' sums of its
            // 16 products from zero, then into the running sums in f32 adds.
#pragma unroll
            for (int i = 0; i < FN; ++i) {
                uint32_t a[4];
                ldmatrix_x4_trans(a, smem_addr(a_tile + (kk + a_k) * kAPitch + a_n + i * 16));
                float part[FM][4];
#pragma unroll
                for (int j = 0; j < FM; ++j) mma_bf16_first(part[j], a, b[j][0], b[j][1]);
#pragma unroll
                for (int j = 0; j < FM; ++j)
#pragma unroll
                    for (int r = 0; r < 4; ++r) acc[i][j][r] += part[j][r];
            }
        }
        issue(s + kDepth);
        cp_async_wait<kDepth - 2>();  // this thread's copies of stage s + 2 have landed
        widen(s + 2);
        __syncthreads();  // tile s + 2 and x's stage s + 1 are visible; tile s and x slot s are free
    }
    cp_async_wait<0>();
    // The loads are done: the next kernel in the stream may start its set-up
    // while this one reduces (it waits for this one's results).
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    __syncthreads();  // the rings are free: this CTA's partial tile takes their place

    // This CTA's partial tile, [row][column] at kOutPitch.  D fragment:
    // acc[i][j] = D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1],
    // D's rows the weight columns and its columns the x rows.
    float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int j = 0; j < FM; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            float* dst = tile + (wm * 8 * FM + j * 8 + 2 * t + h) * kOutPitch + wn * 16 * FN + g;
#pragma unroll
            for (int i = 0; i < FN; ++i) {
                dst[i * 16] = acc[i][j][h];
                dst[i * 16 + 8] = acc[i][j][h + 2];
            }
        }
    cluster.sync();

    // CTA r of the cluster finishes the tile's rows [r R, (r + 1) R), R =
    // kBM / csize: the cluster's partial tiles of them (16-byte reads of
    // distributed shared memory) added in rank order, then the epilogue and
    // the stores.  Thread tid takes columns (tid % kQuads) * 4 .. + 3 of
    // every kRowStep-th row.
    constexpr int kQuads = kBN / 4, kRowStep = kThreads / kQuads;
    static_assert(kThreads % kQuads == 0, "a thread keeps its columns");
    const int rows_per = kBM / csize;  // a power of two: csize divides kBM
    const int row_end = min(rank * rows_per + rows_per, M - m0);
    const int col = (tid % kQuads) * 4, n = n0 + col;
    float sc[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) sc[c] = n + c < N ? ep.scale[n + c] : 0.0f;
    const bool vec_out = N % 4 == 0;
    if (n < N) {
#pragma unroll 4
        for (int row = rank * rows_per + tid / kQuads; row < row_end; row += kRowStep) {
            const int at = row * kOutPitch + col;
            float4 s = *reinterpret_cast<const float4*>(cluster.map_shared_rank(tile, 0) + at);
            for (int src = 1; src < csize; ++src) {
                const float4 v =
                    *reinterpret_cast<const float4*>(cluster.map_shared_rank(tile, src) + at);
                s.x += v.x;
                s.y += v.y;
                s.z += v.z;
                s.w += v.w;
            }
            const float sv[4] = {s.x, s.y, s.z, s.w};
            float y[4];
            const size_t mn = static_cast<size_t>(m0 + row) * N + n;
#pragma unroll
            for (int c = 0; c < 4; ++c)
                y[c] = n + c < N ? pim_epilogue(sv[c], sc[c], ep.bias, ep.bias_bf16, ep.residual,
                                                ep.residual_bf16, ep.activation, n + c, mn + c)
                                 : 0.0f;
            if (vec_out) {
                *reinterpret_cast<float4*>(ep.out + mn) = make_float4(y[0], y[1], y[2], y[3]);
            } else {
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    if (n + c < N) ep.out[mn + c] = y[c];
            }
        }
    }
    cluster.sync();  // no CTA leaves while the others read its partial tile
}

// Launches kernel on grid (cluster, row tiles, column tiles) with a cluster
// of `cluster` CTAs along x, `smem` bytes of dynamic shared memory (the
// limit set at every launch) and programmatic dependent launch.
template <class Kernel, class... Args>
cudaError_t launch(Kernel kernel, int threads, int cluster, int row_tiles, int col_tiles,
                   int smem, cudaStream_t stream, Args... args) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, row_tiles, col_tiles);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[2];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[1].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 2;
    return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The CTA shapes (tile_n x tile_m) the kernels are built for: 256 x 128 on
// 8 warps (4 x 2) and 128 x 128 on 4 (2 x 2), each warp 64 columns x 64
// rows; 128 x 64 and 128 x 32 on 4 warps (2 x 2, 64 x 32 and 64 x 16 each);
// 128 x 16 on 4 warps (4 x 1, 32 x 16 each).
__host__ inline bool tile_ok(int bn, int bm) {
    return (bn == 256 && bm == 128) ||
           (bn == 128 && (bm == 128 || bm == 64 || bm == 32 || bm == 16));
}

// A plan the kernels can run: a CTA shape they are built for, a cluster of
// 1, 2, 4 or 8 CTAs (each finishing as many of the tile's rows) that each get
// K values (a multiple of kStageK) and none of which is empty, and shared
// memory within the card's 227 KB a block.
__host__ inline bool plan_ok(int M, int K, int N, int bn, int bm, int cluster, int k_per_cta,
                             int smem) {
    return M >= 1 && K >= 1 && N >= 1 && tile_ok(bn, bm) &&
           (cluster == 1 || cluster == 2 || cluster == 4 || cluster == 8) &&
           k_per_cta >= kStageK && k_per_cta % kStageK == 0 &&
           static_cast<long long>(cluster) * k_per_cta >= K &&
           static_cast<long long>(cluster - 1) * k_per_cta < K && smem <= kSmemMax;
}

// Launches Kernels::fn<WN, WM, FN, FM>(), the kernel of CTA shape bn x bm
// (one that tile_ok accepts), with args.
template <class Kernels, class... Args>
cudaError_t dispatch(int bn, int bm, int cluster, int row_tiles, int col_tiles, int smem,
                     cudaStream_t stream, Args... args) {
    if (bn == 256)
        return launch(Kernels::template fn<4, 2, 4, 8>(), 256, cluster, row_tiles, col_tiles,
                      smem, stream, args...);
    switch (bm) {
        case 128:
            return launch(Kernels::template fn<2, 2, 4, 8>(), 128, cluster, row_tiles,
                          col_tiles, smem, stream, args...);
        case 64:
            return launch(Kernels::template fn<2, 2, 4, 4>(), 128, cluster, row_tiles,
                          col_tiles, smem, stream, args...);
        case 32:
            return launch(Kernels::template fn<2, 2, 4, 2>(), 128, cluster, row_tiles,
                          col_tiles, smem, stream, args...);
        default:
            return launch(Kernels::template fn<4, 1, 2, 2>(), 128, cluster, row_tiles,
                          col_tiles, smem, stream, args...);
    }
}

}  // namespace pim_gemm
