// pim_matvec: decode-shaped (M <= 8 rows) GEMV on PIM-quantized weights with
// the fused epilogue, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/pim_matvec.py:_mv_kernel, the Pallas kernel the
// JAX package runs on the TPU.  It computes
// repro_torch/kernels/pim_matvec.py:pim_matvec_plain:
//   out[m, n] = epilogue(sum_k f32(x[m, k]) * code[k, n]),
//   epilogue  = * scale[n] [+ bias[n]] -> activation -> [+ residual[m, n]],
// with f32 sums and one f32 store per output.  Codes are int8 (K, N), or
// int4 nibble-packed (K/2, N) with the low nibble holding the even K row and
// sign extension ((v & 0xF) ^ 8) - 8.
//
// What bounds it on the card: HBM bytes, once the codes are widened cheaply
// enough.  A weight byte feeds M (int8) or 2M (int4) multiply-adds; on the
// CUDA cores widening a code and its M = 4 multiply-adds take about 6
// instructions, which at the issue rate the SMs reach leaves such a kernel
// compute-bound.  What the design does about it:
//   * the multiply-adds run on the tensor cores as out^T = codes^T x^T:
//     mma.sync m16n8k16, bf16 in (int8 and int4 codes are exact in bf16),
//     f32 accumulation; A is 16 weight columns x 16 K values of the codes,
//     B is x^T with its M <= 8 rows as the 8 columns.  bf16 x is exact; f32
//     x is split into three bf16 planes (hi + mid + lo, 24 bits), three
//     products summed in f32.  Each ring stage's products accumulate in
//     the tensor cores and then join the running sums by f32 adds, so the
//     long sums round as f32 adds do.  What is left on the CUDA cores is widening
//     the codes: 4 int8 codes from one ldmatrix.trans register take one
//     LOP3, four byte permutes and subtracts (2^23 magic) and two permutes
//     that keep the bf16 halves; int4 nibbles fit a bf16 magic directly;
//   * the codes stream through a kStages-deep cp.async ring of tiles of
//     stage_rows code rows (up to 8 KB) in shared memory (16-byte copies, rows padded so
//     that ldmatrix's 8 row addresses fall in 8 bank groups); x's rows of the
//     CTA's K slice are staged once as bf16 (chunked only where a slice
//     exceeds kXsBytes), the first batch of x loads issued before the codes;
//   * one launch per linear.  The grid is (cluster size) x (column tiles) x
//     (groups of x rows); the CTAs of one thread-block cluster split the
//     code rows (K) of one column tile between them.  Each CTA's warps split
//     the tile's columns and K steps, add their partial tiles in warp order,
//     and every CTA writes its partial sums of each output into the shared
//     memory of the CTA that finishes it (distributed shared memory).  After
//     one cluster barrier each CTA adds what it received in rank order, runs
//     the epilogue and stores.  No scratch in HBM, no second kernel, no
//     atomics: results are the same from run to run;
//   * programmatic dependent launch: the CTAs are launched while the kernel
//     before them finishes and wait (griddepcontrol.wait) before they read
//     any global memory; once their code stream is done they let the next
//     kernel start its set-up, so launch latency overlaps the reduction;
//   * the tile shape comes from the weight's shape (planner in
//     repro_torch/kernels/pim_matvec.py:plan): 32 to 128 columns a tile, a
//     cluster of 1 to 8 CTAs, and groups of x rows where a narrow weight
//     cannot otherwise give every SM a CTA.
// It allocates nothing: the caller passes the output and the stream.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "pim_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;         // warps a CTA has
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCluster = 8;    // the portable cluster size
constexpr int kStages = 4;        // the code ring's depth
constexpr int kStageBytes = 8192; // code bytes a ring stage holds at most
constexpr int kRowPad = 16;       // bytes of padding after each staged code row
constexpr int kXPad = 8;          // bf16 of padding after each staged x row
constexpr int kXsBytes = 48 * 1024;  // the staged x chunk at most
constexpr int kMmaN = 8;          // x rows an mma covers (B's columns)

// Grid (cluster, col_tiles, m_groups), block kThreads, cluster (cluster, 1, 1).
// CTA rank s of a cluster sums code rows [s * rows_per_cta, ...) of the
// TILE columns of tile blockIdx.y, for x rows [blockIdx.z * m_rows, ...).
// Warp w takes the 32 columns (w % kWn) * 32 and the 16-row units
// w / kWn, w / kWn + kWk, ... of each ring stage.
template <int BITS, int PLANES, int TILE>
__global__ void __launch_bounds__(kThreads)
pim_matvec_kernel(const void* __restrict__ x, bool x_bf16, const int8_t* __restrict__ codes,
                  const float* __restrict__ scale, const void* bias, bool bias_bf16,
                  const void* residual, bool residual_bf16, int activation,
                  float* __restrict__ out, int M, int K, int N, int rows, int rows_per_cta,
                  int m_rows, int stage_rows, int chunk_rows, bool vec, bool xvec) {
    constexpr int kPerRow = BITS == 4 ? 2 : 1;      // K values one code row holds
    constexpr int kWn = TILE / 32;                  // warps across the columns
    constexpr int kWk = kWarps / kWn;               // warps across the K steps
    constexpr int kPitch = TILE + kRowPad;          // bytes of a staged code row
    constexpr int kChunksPerRow = TILE / 16;        // 16-byte copies a code row takes
    const int slot_bytes = stage_rows * kPitch;
    const int units = stage_rows / 16;              // 16-row units a stage holds
    constexpr int kXBatch = 8;                      // x loads a thread issues at once

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = blockIdx.x, csize = gridDim.x;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wn = warp % kWn, wk = warp / kWn;
    const int g = lane >> 2, t = lane & 3;
    const int n0 = blockIdx.y * TILE;
    const int m0 = blockIdx.z * m_rows;
    const int r_begin = rank * rows_per_cta;
    const int r_end = min(r_begin + rows_per_cta, rows);
    // Outputs [rank * share, ...) of the tile (m_rows x TILE) are this CTA's.
    const int share = (m_rows * TILE + csize - 1) / csize;

    // Shared memory: the code ring (after the stream: the warps' partial
    // tiles), the staged x chunk (PLANES x kMmaN rows of x_ld bf16), and the
    // inbox where the cluster's CTAs leave their partial sums of this CTA's
    // share (csize x share f32).
    extern __shared__ __align__(16) unsigned char smem[];
    unsigned char* ring = smem;
    float* red = reinterpret_cast<float*>(smem);
    const int x_ld = ((chunk_rows + stage_rows - 1) / stage_rows) * stage_rows * kPerRow + kXPad;
    const int ring_bytes = max(kStages * slot_bytes, kWk * m_rows * TILE * 4);
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + ring_bytes);
    float* inbox = reinterpret_cast<float*>(xs + PLANES * kMmaN * x_ld);

    // B's columns past the CTA's x rows are 0 in every chunk: zero them once.
    const int m_real = max(0, min(m_rows, M - m0));
    for (int i = tid; i < PLANES * (kMmaN - m_real) * x_ld; i += kThreads) {
        const int p = i / ((kMmaN - m_real) * x_ld), rest = i - p * (kMmaN - m_real) * x_ld;
        xs[(p * kMmaN + m_real) * x_ld + rest] = __float2bfloat16_rn(0.0f);
    }

    // Launched with programmatic stream serialization, the CTAs may start
    // while the kernel before them in the stream finishes: nothing above
    // reads global memory, nothing below runs before that kernel's results
    // are visible (the codes too: the kernel before may have written them).
    asm volatile("griddepcontrol.wait;\n" ::: "memory");

    // The epilogue's first scale, loaded while the codes stream; its bias
    // and residual on their way to L1.
    float scale0 = 0.0f;
    {
        const int e = rank * share + tid;
        const int n = n0 + e % TILE, m = e / TILE;
        if (tid < share && e < m_rows * TILE && n < N && m0 + m < M) {
            scale0 = __ldg(scale + n);
            if (bias != nullptr)
                asm volatile("prefetch.global.L1 [%0];" ::"l"(static_cast<const char*>(bias) +
                                                             n * (bias_bf16 ? 2 : 4)));
            if (residual != nullptr)
                asm volatile("prefetch.global.L1 [%0];" ::"l"(
                    static_cast<const char*>(residual) +
                    (static_cast<size_t>(m0 + m) * N + n) * (residual_bf16 ? 2 : 4)));
        }
    }

    float acc[2][4];  // this warp's two 16-column groups, mma D fragments
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;

    for (int c0 = r_begin; c0 < r_end; c0 += chunk_rows) {
        const int n_rows = min(chunk_rows, r_end - c0);
        const int stages = (n_rows + stage_rows - 1) / stage_rows;
        const int n_k = n_rows * kPerRow;                 // x values of the chunk
        const int n_kx = stages * stage_rows * kPerRow;   // staged: zero past n_k

        // Stage st's code rows [c0 + st * stage_rows, ...) into ring slot
        // st % kStages; rows past the chunk and columns past N read 0.
        auto issue = [&](int st) {
            if (st < stages) {
                unsigned char* slot = ring + (st % kStages) * slot_bytes;
                for (int i = tid; i < stage_rows * kChunksPerRow; i += kThreads) {
                    const int row = i / kChunksPerRow, cc = i % kChunksPerRow;
                    const int gr = st * stage_rows + row;  // within the chunk
                    const int col = n0 + cc * 16;
                    const bool in = gr < n_rows && col < N;
                    const int8_t* src = codes + static_cast<size_t>(c0 + gr) * N + col;
                    unsigned char* dst = slot + row * kPitch + cc * 16;
                    if (vec) {
                        cp_async16(smem_addr(dst), in ? src : codes, in);
                    } else {
                        uint32_t w[4] = {0u, 0u, 0u, 0u};
                        for (int c = 0; c < 16; ++c)
                            if (in && col + c < N)
                                w[c / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(src[c]))
                                            << (8 * (c % 4));
                        *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
                    }
                }
            }
            cp_async_commit();
        };

        // x item it: row it / per_row of the CTA's x rows, a 16-byte vector
        // (xvec) or one value; values past n_k are 0.
        const int x_vec = x_bf16 ? 8 : 4;
        const int per_row = xvec ? n_kx / x_vec : n_kx;
        const int n_items = m_real * per_row;
        auto x_load = [&](int it, uint4& v) {
            v = make_uint4(0u, 0u, 0u, 0u);
            const int m = it / per_row, q = it - m * per_row;
            if (it >= n_items) return;
            const size_t row = static_cast<size_t>(m0 + m) * K + static_cast<size_t>(c0) * kPerRow;
            if (xvec) {
                if (q * x_vec < n_k)
                    v = __ldg(reinterpret_cast<const uint4*>(
                        static_cast<const char*>(x) +
                        ((row + static_cast<size_t>(q) * x_vec) << (x_bf16 ? 1 : 2))));
            } else if (q < n_k) {
                v.x = __float_as_uint(
                    x_bf16 ? __bfloat162float(__ldg(static_cast<const __nv_bfloat16*>(x) + row + q))
                           : __ldg(static_cast<const float*>(x) + row + q));
            }
        };
        // Item it into the planes: bf16 of the value, then (f32 x) bf16 of
        // what each plane leaves off.
        auto x_store = [&](int it, const uint4& v) {
            if (it >= n_items) return;
            const int m = it / per_row, q = it - m * per_row;
            float f[8];
            int n = 1;
            if (!xvec) {
                f[0] = __uint_as_float(v.x);
            } else if (x_bf16) {
                const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    f[2 * i] = __uint_as_float(w[i] << 16);
                    f[2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
                }
                n = 8;
            } else {
                f[0] = __uint_as_float(v.x);
                f[1] = __uint_as_float(v.y);
                f[2] = __uint_as_float(v.z);
                f[3] = __uint_as_float(v.w);
                n = 4;
            }
            const int j0 = xvec ? q * x_vec : q;
#pragma unroll
            for (int p = 0; p < PLANES; ++p) {
                __nv_bfloat16* dst = xs + (p * kMmaN + m) * x_ld + j0;
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    if (i < n) {
                        const __nv_bfloat16 h = __float2bfloat16_rn(f[i]);
                        dst[i] = h;
                        f[i] -= __bfloat162float(h);
                    }
                }
            }
        };

        if (c0 != r_begin) __syncthreads();  // the previous chunk's reads are done
        // x's first loads in flight, then the codes (they do not need x),
        // then x into shared memory.
        uint4 xv[kXBatch];
#pragma unroll
        for (int b = 0; b < kXBatch; ++b) x_load(tid + b * kThreads, xv[b]);
#pragma unroll
        for (int st = 0; st < kStages - 1; ++st) issue(st);
#pragma unroll
        for (int b = 0; b < kXBatch; ++b) x_store(tid + b * kThreads, xv[b]);
        for (int it0 = tid + kXBatch * kThreads; it0 < n_items; it0 += kXBatch * kThreads) {
#pragma unroll
            for (int b = 0; b < kXBatch; ++b) x_load(it0 + b * kThreads, xv[b]);
#pragma unroll
            for (int b = 0; b < kXBatch; ++b) x_store(it0 + b * kThreads, xv[b]);
        }

        for (int st = 0; st < stages; ++st) {
            cp_async_wait<kStages - 2>();
            __syncthreads();  // stage st (and, the first time, x) is visible; st - 1 is read
            const unsigned char* slot = ring + (st % kStages) * slot_bytes;
            // The stage's products accumulate in the tensor cores, then join
            // the running sums in f32 adds: the long sums round as f32 adds
            // do, whatever the tensor cores' accumulation order.
            float part[2][4];
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int i = 0; i < 4; ++i) part[j][i] = 0.0f;
            for (int u = wk; u < units; u += kWk) {
                // Rows u * 16 .. + 15 of the stage, columns wn * 32 .. + 31:
                // matrices (rows +0, cols +0), (+8, +0), (+0, +16), (+8, +16).
                const int mrow = u * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
                const int mcol = wn * 32 + (lane >> 4) * 16;
                uint32_t r[4];
                ldmatrix_x4_trans(r, smem_addr(slot + mrow * kPitch + mcol));
                const int kk = (st * stage_rows + u * 16) * kPerRow;  // chunk K of the unit
                if constexpr (BITS == 8) {
                    uint32_t a[2][4];
                    widen_int8(r[0], a[0][0], a[0][1]);
                    widen_int8(r[1], a[0][2], a[0][3]);
                    widen_int8(r[2], a[1][0], a[1][1]);
                    widen_int8(r[3], a[1][2], a[1][3]);
#pragma unroll
                    for (int p = 0; p < PLANES; ++p) {
                        const __nv_bfloat16* xr = xs + (p * kMmaN + g) * x_ld + kk + 2 * t;
                        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xr);
                        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xr + 8);
                        mma_bf16(part[0], a[0], b0, b1);
                        mma_bf16(part[1], a[1], b0, b1);
                    }
                } else {
                    // r[0]/r[2]: packed rows +0..7 (K +0..15) of the two
                    // column groups, r[1]/r[3]: packed rows +8..15 (K +16..31).
                    // A's K pairs (2t, 2t + 1) and (2t + 8, 2t + 9) are the
                    // K values 4t, 4t + 1 and 4t + 2, 4t + 3: B follows.
                    uint32_t a[4][4];
                    widen_int4(r[0], a[0]);
                    widen_int4(r[1], a[1]);
                    widen_int4(r[2], a[2]);
                    widen_int4(r[3], a[3]);
#pragma unroll
                    for (int p = 0; p < PLANES; ++p) {
                        const __nv_bfloat16* xr = xs + (p * kMmaN + g) * x_ld + kk + 4 * t;
                        const uint2 b_lo = *reinterpret_cast<const uint2*>(xr);
                        const uint2 b_hi = *reinterpret_cast<const uint2*>(xr + 16);
                        mma_bf16(part[0], a[0], b_lo.x, b_lo.y);
                        mma_bf16(part[0], a[1], b_hi.x, b_hi.y);
                        mma_bf16(part[1], a[2], b_lo.x, b_lo.y);
                        mma_bf16(part[1], a[3], b_hi.x, b_hi.y);
                    }
                }
            }
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[j][i] += part[j][i];
            issue(st + kStages - 1);  // into the slot read one stage ago
        }
    }
    cp_async_wait<0>();
    // The stream is done: the next kernel in the stream may start its
    // set-up while this one reduces (it waits for this one's results).
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    __syncthreads();  // the ring is about to become red

    // D fragment: acc[j] = D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1]
    // with D row g the column 2g of the group, row g + 8 the column 2g + 1,
    // and D column the x row.  Each warp's partial tile goes to red[wk].
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const int col = wn * 32 + j * 16 + 2 * g;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int m = 2 * t + (i & 1);
            if (m < m_rows) red[(wk * m_rows + m) * TILE + col + (i >> 1)] = acc[j][i];
        }
    }
    __syncthreads();
    // This CTA's partial tile, the K warps' tiles added in warp order, goes to
    // the inbox of the CTA that finishes each output.
    for (int e = tid; e < m_rows * TILE; e += kThreads) {
        float s = red[e];
#pragma unroll
        for (int w = 1; w < kWk; ++w) s += red[w * m_rows * TILE + e];
        const int owner = e / share;
        cluster.map_shared_rank(inbox, owner)[rank * share + e - owner * share] = s;
    }
    cluster.sync();

    // This CTA's share: the cluster's partial sums added in rank order, then
    // the epilogue.  Nothing reads another CTA's memory after the barrier.
    for (int i = tid; i < share; i += kThreads) {
        const int e = rank * share + i;
        if (e >= m_rows * TILE) break;
        const int m = e / TILE, n = n0 + e % TILE;
        if (m0 + m >= M || n >= N) continue;
        float s = inbox[i];
        for (int src = 1; src < csize; ++src) s += inbox[src * share + i];
        const size_t mn = static_cast<size_t>(m0 + m) * N + n;
        out[mn] = pim_epilogue(s, i == tid ? scale0 : scale[n], bias, bias_bf16, residual,
                               residual_bf16, activation, n, mn);
    }
}

struct Args {
    const void* x;
    bool x_bf16;
    const int8_t* codes;
    const float* scale;
    const void* bias;
    bool bias_bf16;
    const void* residual;
    bool residual_bf16;
    int activation;
    float* out;
    int M, K, N, rows, rows_per_cta, m_rows, stage_rows, chunk_rows;
    bool vec, xvec;
};

template <int BITS, int PLANES, int TILE>
cudaError_t launch(const Args& a, int cluster, int col_tiles, int m_groups, size_t smem,
                   cudaStream_t stream) {
    const auto kernel = pim_matvec_kernel<BITS, PLANES, TILE>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, col_tiles, m_groups);
    cfg.blockDim = dim3(kThreads);
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
    return cudaLaunchKernelEx(&cfg, kernel, a.x, a.x_bf16, a.codes, a.scale, a.bias, a.bias_bf16,
                              a.residual, a.residual_bf16, a.activation, a.out, a.M, a.K, a.N,
                              a.rows, a.rows_per_cta, a.m_rows, a.stage_rows, a.chunk_rows, a.vec, a.xvec);
}

template <int BITS, int PLANES>
cudaError_t dispatch_tile(const Args& a, int tile, int cluster, int col_tiles, int m_groups,
                          size_t smem, cudaStream_t s) {
    switch (tile) {
        case 32: return launch<BITS, PLANES, 32>(a, cluster, col_tiles, m_groups, smem, s);
        case 64: return launch<BITS, PLANES, 64>(a, cluster, col_tiles, m_groups, smem, s);
        case 128: return launch<BITS, PLANES, 128>(a, cluster, col_tiles, m_groups, smem, s);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// Launches the kernel on `stream` with the plan of
// repro_torch/kernels/pim_matvec.py:plan: tile_n columns a CTA (32, 64 or
// 128), `cluster` CTAs splitting the code rows in slices of rows_per_cta, x
// rows in groups of m_rows (1, 2, 4 or 8), x staged chunk_rows code rows at
// a time.  x: (M, K) f32 or bf16; codes: (K, N) int8 (bits 8) or (K/2, N)
// nibbles (bits 4); scale: (N,) f32; bias: (N,) f32/bf16 or null; residual:
// (M, N) f32/bf16 or null; out: (M, N) f32.  All contiguous.  Returns
// cudaErrorInvalidValue for a plan it cannot run, else the launch's error.
extern "C" int pim_matvec_launch(const void* x, int x_bf16, const void* codes, const void* scale,
                                 const void* bias, int bias_bf16, const void* residual,
                                 int residual_bf16, void* out, int M, int K, int N, int bits,
                                 int activation, int tile_n, int cluster, int rows_per_cta,
                                 int m_rows, int stage_rows, int chunk_rows, void* stream) {
    const int rows = bits == 4 ? K / 2 : K;
    const int per_row = bits == 4 ? 2 : 1;
    const int planes = x_bf16 ? 1 : 3;
    const long long staged_k =
        static_cast<long long>((chunk_rows + stage_rows - 1) / stage_rows) * stage_rows * per_row;
    const bool ok = (bits == 4 || bits == 8) && M >= 1 && M <= 8 && N >= 1 && rows >= 1 &&
                    (bits == 8 || K % 2 == 0) &&
                    (tile_n == 32 || tile_n == 64 || tile_n == 128) && cluster >= 1 &&
                    cluster <= kMaxCluster && rows_per_cta >= 1 &&
                    static_cast<long long>(cluster) * rows_per_cta >= rows &&
                    static_cast<long long>(cluster - 1) * rows_per_cta < rows &&
                    (m_rows == 1 || m_rows == 2 || m_rows == 4 || m_rows == 8) &&
                    stage_rows >= 16 && stage_rows % 16 == 0 && stage_rows * tile_n <= kStageBytes &&
                    chunk_rows >= 1 && planes * kMmaN * (staged_k + kXPad) * 2 <= kXsBytes;
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    const int col_tiles = (N + tile_n - 1) / tile_n;
    const int m_groups = (M + m_rows - 1) / m_rows;
    const int share = (m_rows * tile_n + cluster - 1) / cluster;
    const size_t ring = static_cast<size_t>(kStages) * stage_rows * (tile_n + kRowPad);
    const size_t red =
        static_cast<size_t>(kWarps / (tile_n / 32)) * m_rows * tile_n * sizeof(float);
    const size_t smem = (ring > red ? ring : red) +
                        static_cast<size_t>(planes) * kMmaN * (staged_k + kXPad) * 2 +
                        static_cast<size_t>(cluster) * share * sizeof(float);
    const int x_vec = x_bf16 ? 8 : 4;
    Args a{x, x_bf16 != 0, static_cast<const int8_t*>(codes), static_cast<const float*>(scale),
           bias, bias_bf16 != 0, residual, residual_bf16 != 0, activation,
           static_cast<float*>(out), M, K, N, rows, rows_per_cta, m_rows, stage_rows, chunk_rows,
           N % 16 == 0 && reinterpret_cast<uintptr_t>(codes) % 16 == 0,
           // x in whole 16-byte vectors: aligned rows, every chunk starting on one
           reinterpret_cast<uintptr_t>(x) % 16 == 0 && K % x_vec == 0 &&
               (rows_per_cta * per_row) % x_vec == 0 && (chunk_rows * per_row) % x_vec == 0};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (bits == 8)
        err = x_bf16 ? dispatch_tile<8, 1>(a, tile_n, cluster, col_tiles, m_groups, smem, s)
                     : dispatch_tile<8, 3>(a, tile_n, cluster, col_tiles, m_groups, smem, s);
    else
        err = x_bf16 ? dispatch_tile<4, 1>(a, tile_n, cluster, col_tiles, m_groups, smem, s)
                     : dispatch_tile<4, 3>(a, tile_n, cluster, col_tiles, m_groups, smem, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
