// flash_attention: softmax(q k^T / sqrt(D)) v with an online softmax over
// KV tiles, for Hopper (sm_90a).
//
// Replaces src/repro/kernels/flash_attn.py:_flash_kernel, the Pallas kernel
// the JAX package runs on the TPU, and serves the model's long-prompt
// attention (src/repro/models/attention.py:_chunked_attention).  It computes
// repro_torch/kernels/flash_attn.py:flash_attention_plain up to the order of
// f32 sums: q (B, Sq, KV, G, D) attends over k, v (B, Sk, KV, D), query head
// (kv, g) reading KV head kv; with `causal` query i sees keys 0..i (top-left
// aligned); scores, the running max and denominator and the accumulator are
// f32 whatever the input type; the output (B, Sq, KV, G, D) is contiguous
// and in the input type.  Any Sq and Sk: the ragged edges are masked here.
//
// What bounds it on the card: operations.  At qwen2-1.5b's long prefill
// (Sq = Sk = 16,384, 12 query heads, D = 128, causal) a layer is 4.1e11
// multiply-adds against about 117 MB of q, k, v and output.  The launcher
// picks one of two routes by the input type alone:
//
// bf16 (flash_attn_mma_kernel): the tensor cores, through mma.sync.
//   * one block of 4 warps per (query head, 64 query rows), 16 rows a warp;
//     q's tile goes through shared memory once and stays in registers as
//     the A fragments of m16n8k16 (bf16 in, f32 accumulation);
//   * K and V stream through shared memory in bf16 tiles of 64 keys, in a
//     ring of 2 stages filled by 16-byte cp.async: tile j+1 loads while
//     tile j is computed.  Rows are padded by 16 bytes, so the 8 rows an
//     ldmatrix reads fall in 8 distinct bank groups;
//   * S = q k^T with ldmatrix'd K fragments; bf16 x bf16 products are exact
//     in f32, so S differs from the plain version only in the order of its
//     f32 sums.  The scale multiplies S after the product, as in the plain
//     version;
//   * p = exp(s - m_new) in f32 from the accumulator registers (as exp2 of
//     a log2e-scaled argument); the row sum l takes the f32 p.  p.v must
//     keep the plain version's f32 p: p is split into p_hi = bf16(p) and
//     p_lo = bf16(p - p_hi), and two MMAs against the same V fragments
//     (ldmatrix.trans, the keys being V's rows) add both.  A single bf16 p,
//     as the library's SDPA rounds it, breaks the bf16 tolerance about 13x;
//     the split costs a third MMA per key pair (1.5x the bound's tensor
//     work).  The accumulator fragment of S is the A fragment of P.V, so p
//     never leaves registers;
//   * masked scores (causal, or keys past Sk, which cp.async zero-fills) are
//     -inf and weigh 0; only the diagonal tile and the ragged tail are
//     masked, tiles wholly above the diagonal are skipped; a row with every
//     key so far masked subtracts 0, so it adds exp(-inf) = 0 and its first
//     rescale is exp(-inf) = 0, never NaN;
//   * the query blocks run heaviest first; the 6 query heads of a GQA group
//     are neighbouring blocks, so their K/V reads hit L2 (one layer's K and
//     V at 16,384 tokens are 16.8 MB of the 50 MB L2).
//   mma.sync reaches a fraction of the bf16 rate that wgmma with TMA and
//   warp specialisation would; those are the remaining step to the library.
//
// f32 (flash_attn_kernel): the CUDA cores.  f32 inputs do not fit the bf16
// tensor cores without a 3-way split, which would breach the f32 tolerance,
// so this route keeps f32 FMAs, and the f32 CUDA-core rate is its ceiling:
//   * one block of 128 threads per (query head, 32 query rows); a query row
//     is owned by 4 neighbouring lanes, each holding a quarter of q's row and
//     of the f32 accumulator in registers (D / 4 values each: 32 at D = 128),
//     so the accumulator never leaves registers.  A lane's quarter is the
//     float4 chunks c with c % 4 == lane % 4, which makes the 4 lanes read 64
//     contiguous bytes of shared memory at once (no bank conflicts);
//   * K and V stream through shared memory in tiles of 32 keys (32 KB a
//     block at D = 128);
//   * a tile's 32 scores are dot products reduced over the 4 lanes of a row
//     with two __shfl_xor_sync (every lane ends with the same bits), kept in
//     registers; the row's max moves once per tile, the accumulator and
//     denominator are rescaled once per tile by exp(m_old - m_new), which is
//     exp(-inf) = 0 on the first tile, never NaN;
//   * masked scores (causal, or keys past Sk, which load as 0) are -inf and
//     weigh exp(-inf) = 0; with `causal` a block stops at the tile holding
//     its last row's key, so tiles wholly above the diagonal are skipped;
//   * the query blocks run heaviest first (the last rows see the most keys
//     under `causal`), so the short blocks fill the tail of the grid.
// Both use IEEE division (the library builds without fast-math).
// Nothing here allocates: the caller passes the output and the stream.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kMaxQBlocks = 65535;  // gridDim.y

struct Args {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    int sq, sk, kvh, g;
    long long q_sb, q_ss, q_sh, q_sg;  // strides in elements; the last dim's is 1
    long long k_sb, k_ss, k_sh;
    long long v_sb, v_ss, v_sh;
    int causal;
    float scale;
};

// ---- the f32 route: CUDA cores ---------------------------------------------

constexpr int kThreads = 128;             // threads per block
constexpr int kParts = 4;                 // lanes per query row
constexpr int kBQ = kThreads / kParts;    // query rows per block
constexpr int kBKV = 32;                  // keys per shared-memory tile

template <int D>
__global__ void __launch_bounds__(kThreads) flash_attn_kernel(const Args a) {
    constexpr int kChunks = D / 16;  // float4 chunks a lane owns
    constexpr int kOwn = 4 * kChunks;
    __shared__ __align__(16) float ks[kBKV][D];
    __shared__ __align__(16) float vs[kBKV][D];

    const int head = blockIdx.x;
    const int b = head / (a.kvh * a.g), h = (head / a.g) % a.kvh, gi = head % a.g;
    const int qb = gridDim.y - 1 - blockIdx.y;  // heaviest first
    const int row = threadIdx.x / kParts, part = threadIdx.x % kParts;
    const int qi = qb * kBQ + row;
    const bool live = qi < a.sq;

    const float* qp = static_cast<const float*>(a.q) + b * a.q_sb +
                      static_cast<long long>(live ? qi : 0) * a.q_ss + h * a.q_sh + gi * a.q_sg;
    const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + h * a.k_sh;
    const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + h * a.v_sh;

    float qr[kOwn], acc[kOwn];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            qr[4 * c + e] = live ? qp[16 * c + 4 * part + e] : 0.0f;
            acc[4 * c + e] = 0.0f;
        }
    }
    float m = -CUDART_INF_F, l = 0.0f;

    // The keys the block's rows see: all, or under `causal` up to its last row.
    const int kend = a.causal ? min(a.sk, min(a.sq, (qb + 1) * kBQ)) : a.sk;
    for (int k0 = 0; k0 < kend; k0 += kBKV) {
        __syncthreads();  // every lane is done with the previous tile
        for (int e = threadIdx.x; e < kBKV * D; e += kThreads) {
            const int j = e / D, d = e % D;
            const long long key = k0 + j;
            const bool in = key < a.sk;
            ks[j][d] = in ? kp[key * a.k_ss + d] : 0.0f;
            vs[j][d] = in ? vp[key * a.v_ss + d] : 0.0f;
        }
        __syncthreads();

        float s[kBKV];
        float tile_max = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < kBKV; ++j) {
            float dot = 0.0f;
#pragma unroll
            for (int c = 0; c < kChunks; ++c) {
                const float4 kk = *reinterpret_cast<const float4*>(&ks[j][16 * c + 4 * part]);
                dot = fmaf(qr[4 * c], kk.x, dot);
                dot = fmaf(qr[4 * c + 1], kk.y, dot);
                dot = fmaf(qr[4 * c + 2], kk.z, dot);
                dot = fmaf(qr[4 * c + 3], kk.w, dot);
            }
            dot += __shfl_xor_sync(0xffffffffu, dot, 1);
            dot += __shfl_xor_sync(0xffffffffu, dot, 2);
            const int key = k0 + j;
            const bool masked = key >= a.sk || (a.causal && key > qi);
            s[j] = masked ? -CUDART_INF_F : dot * a.scale;
            tile_max = fmaxf(tile_max, s[j]);
        }

        const float m_new = fmaxf(m, tile_max);
        if (m_new == -CUDART_INF_F) continue;  // every key so far masked: nothing to add
        const float corr = expf(m - m_new);   // 0 on the row's first live tile
        l *= corr;
#pragma unroll
        for (int i = 0; i < kOwn; ++i) acc[i] *= corr;
#pragma unroll
        for (int j = 0; j < kBKV; ++j) {
            const float p = expf(s[j] - m_new);  // a masked key weighs 0
            l += p;
#pragma unroll
            for (int c = 0; c < kChunks; ++c) {
                const float4 vv = *reinterpret_cast<const float4*>(&vs[j][16 * c + 4 * part]);
                acc[4 * c] = fmaf(p, vv.x, acc[4 * c]);
                acc[4 * c + 1] = fmaf(p, vv.y, acc[4 * c + 1]);
                acc[4 * c + 2] = fmaf(p, vv.z, acc[4 * c + 2]);
                acc[4 * c + 3] = fmaf(p, vv.w, acc[4 * c + 3]);
            }
        }
        m = m_new;
    }

    if (!live) return;
    const float den = fmaxf(l, 1e-30f);
    float* op = static_cast<float*>(a.o) +
                (((static_cast<long long>(b) * a.sq + qi) * a.kvh + h) * a.g + gi) * D;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) op[16 * c + 4 * part + e] = acc[4 * c + e] / den;
    }
}

// ---- the bf16 route: tensor cores (mma.sync) ---------------------------------

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;  // threads per block
constexpr int kMmaBQ = 16 * kMmaWarps;       // query rows per block, 16 a warp
constexpr int kMmaBKV = 64;                  // keys per shared-memory tile
constexpr int kStages = 2;                   // K/V tiles in the cp.async ring
constexpr int kPad = 8;                      // bf16 of padding per shared-memory row
constexpr float kLog2e = 1.4426950408889634f;

// Bytes of dynamic shared memory: q's tile, then kStages (K, V) tile pairs.
template <int D>
constexpr int mma_smem_bytes() {
    return (kMmaBQ + 2 * kStages * kMmaBKV) * (D + kPad) * 2;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes where !in.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(in ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
    return *reinterpret_cast<uint32_t*>(&x);
}

// (x, y) -> hi = bf16(x, y) and lo = bf16 of what hi leaves off, packed as
// an A-fragment register each (x in the low half).
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    hi = bits(h);
    lo = bits(__floats2bfloat162_rn(x - __low2float(h), y - __high2float(h)));
}

// Rows r0 .. r0 + rows - 1 of a (row, D) bf16 matrix with row stride `stride`
// into shared memory at `dst` (row pitch D + kPad); rows at or past `n` are
// zero-filled.  16 bytes per cp.async, spread over the block's threads.
template <int D, int rows>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* base,
                                          long long stride, int r0, int n) {
    constexpr int kChunks = D / 8;
    static_assert(rows * kChunks % kMmaThreads == 0, "whole passes of the block");
#pragma unroll
    for (int i = 0; i < rows * kChunks / kMmaThreads; ++i) {
        const int e = threadIdx.x + i * kMmaThreads;
        const int r = e / kChunks, c = e % kChunks;
        const bool in = r0 + r < n;
        const __nv_bfloat16* src = base + (in ? static_cast<long long>(r0 + r) * stride : 0) + 8 * c;
        cp_async16(dst + 2 * (r * (D + kPad) + 8 * c), src, in);
    }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads) flash_attn_mma_kernel(const Args a) {
    constexpr int kRow = D + kPad;          // shared-memory row pitch, in bf16
    constexpr int kTileBytes = 2 * kMmaBKV * kRow;
    constexpr int kKSteps = D / 16;         // k-steps of q k^T
    constexpr int kNTiles = kMmaBKV / 8;    // 8-key column tiles of S
    constexpr int kDTiles = D / 8;          // 8-wide column tiles of the output
    extern __shared__ __align__(16) unsigned char smem[];
    const uint32_t qs = smem_addr(smem);
    const uint32_t kv0 = qs + 2 * kMmaBQ * kRow;  // stage st: K at +2 st tiles, V after it

    const int head = blockIdx.x;
    const int b = head / (a.kvh * a.g), h = (head / a.g) % a.kvh, gi = head % a.g;
    const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaBQ;  // heaviest first
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int row0 = q0 + 16 * warp + lane / 4;  // this lane's rows: row0 and row0 + 8
    const int col0 = 2 * (lane % 4);             // and its columns in each 8-wide tile

    const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh +
                              gi * a.q_sg;
    const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + h * a.k_sh;
    const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + h * a.v_sh;

    // The keys the block's rows see: all, or under `causal` up to its last row.
    const int kend = a.causal ? min(a.sk, min(a.sq, q0 + kMmaBQ)) : a.sk;
    const int n_tiles = (kend + kMmaBKV - 1) / kMmaBKV;

    load_tile<D, kMmaBQ>(qs, qp, a.q_ss, q0, a.sq);
    load_tile<D, kMmaBKV>(kv0, kp, a.k_ss, 0, a.sk);
    load_tile<D, kMmaBKV>(kv0 + kTileBytes, vp, a.v_ss, 0, a.sk);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    uint32_t qf[kKSteps][4];  // q's A fragments, for the whole loop
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk)
        ldmatrix_x4(qf[kk], qs + 2 * ((16 * warp + lane % 16) * kRow + 16 * kk + 8 * (lane / 16)));

    float o[kDTiles][4];
#pragma unroll
    for (int t = 0; t < kDTiles; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.0f;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f};

    for (int j = 0; j < n_tiles; ++j) {
        if (j > 0) {
            cp_async_wait_all();  // tile j is in shared memory
            __syncthreads();      // for every thread; and all are done with tile j - 1
        }
        if (j + 1 < n_tiles) {  // the next tile loads while this one is computed
            const uint32_t next = kv0 + 2 * ((j + 1) % kStages) * kTileBytes;
            load_tile<D, kMmaBKV>(next, kp, a.k_ss, (j + 1) * kMmaBKV, a.sk);
            load_tile<D, kMmaBKV>(next + kTileBytes, vp, a.v_ss, (j + 1) * kMmaBKV, a.sk);
            cp_async_commit();
        }
        const uint32_t ks = kv0 + 2 * (j % kStages) * kTileBytes, vs = ks + kTileBytes;
        const int k0 = j * kMmaBKV;

        // S = q k^T: s[t] is the 16 x 8 tile of keys k0 + 8t .. k0 + 8t + 7.
        float s[kNTiles][4];
#pragma unroll
        for (int t = 0; t < kNTiles; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
            for (int t = 0; t < kNTiles; t += 2) {
                uint32_t kf[4];  // B fragments of key tiles t and t + 1
                ldmatrix_x4(kf, ks + 2 * ((8 * t + lane % 8 + 8 * (lane / 16)) * kRow +
                                          16 * kk + 8 * (lane / 8 % 2)));
                mma_bf16(s[t], qf[kk], kf[0], kf[1]);
                mma_bf16(s[t + 1], qf[kk], kf[2], kf[3]);
            }
        }

        // Scale, mask, and move the running max (2 rows a lane: r = 0, 1).
        const bool edge = k0 + kMmaBKV > a.sk || (a.causal && k0 + kMmaBKV - 1 > q0);
        float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
        for (int t = 0; t < kNTiles; ++t) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                float x = s[t][c] * a.scale;
                if (edge) {
                    const int key = k0 + 8 * t + col0 + c % 2;
                    if (key >= a.sk || (a.causal && key > row0 + 8 * (c / 2))) x = -CUDART_INF_F;
                }
                s[t][c] = x;
                mx[c / 2] = fmaxf(mx[c / 2], x);
            }
        }
        float base[2];  // log2e * the max each p is taken against
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_new = fmaxf(m[r], mx[r]);
            // Every key so far masked: subtract 0, so each p is exp(-inf) = 0.
            const float m_use = m_new == -CUDART_INF_F ? 0.0f : m_new;
            const float corr = exp2f((m[r] - m_use) * kLog2e);  // 0 on the first live tile
            l[r] *= corr;
#pragma unroll
            for (int t = 0; t < kDTiles; ++t) {
                o[t][2 * r] *= corr;
                o[t][2 * r + 1] *= corr;
            }
            m[r] = m_new;
            base[r] = m_use * kLog2e;
        }
#pragma unroll
        for (int t = 0; t < kNTiles; ++t) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const float p = exp2f(fmaf(s[t][c], kLog2e, -base[c / 2]));
                l[c / 2] += p;
                s[t][c] = p;
            }
        }

        // O += P V over 16-key steps: P's A fragment is S tiles 2u and 2u + 1,
        // split into bf16 halves; both multiply the same V fragments.
#pragma unroll
        for (int u = 0; u < kMmaBKV / 16; ++u) {
            uint32_t hi[4], lo[4];
            split_bf16x2(s[2 * u][0], s[2 * u][1], hi[0], lo[0]);
            split_bf16x2(s[2 * u][2], s[2 * u][3], hi[1], lo[1]);
            split_bf16x2(s[2 * u + 1][0], s[2 * u + 1][1], hi[2], lo[2]);
            split_bf16x2(s[2 * u + 1][2], s[2 * u + 1][3], hi[3], lo[3]);
#pragma unroll
            for (int t = 0; t < kDTiles; t += 2) {
                uint32_t vf[4];  // B fragments of output column tiles t and t + 1
                ldmatrix_x4_trans(vf, vs + 2 * ((16 * u + lane % 8 + 8 * (lane / 8 % 2)) * kRow +
                                                8 * t + 8 * (lane / 16)));
                mma_bf16(o[t], hi, vf[0], vf[1]);
                mma_bf16(o[t], lo, vf[0], vf[1]);
                mma_bf16(o[t + 1], hi, vf[2], vf[3]);
                mma_bf16(o[t + 1], lo, vf[2], vf[3]);
            }
        }
    }

    // The 4 lanes of a row hold partial sums of its denominator.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        const int qi = row0 + 8 * r;
        if (qi >= a.sq) continue;
        const float den = fmaxf(l[r], 1e-30f);
        __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o) +
                            (((static_cast<long long>(b) * a.sq + qi) * a.kvh + h) * a.g + gi) * D;
#pragma unroll
        for (int t = 0; t < kDTiles; ++t)
            *reinterpret_cast<__nv_bfloat162*>(op + 8 * t + col0) =
                __floats2bfloat162_rn(o[t][2 * r] / den, o[t][2 * r + 1] / den);
    }
}

template <int D>
int launch_d(const Args& a, int heads, int bf16, cudaStream_t s) {
    const int bq = bf16 ? kMmaBQ : kBQ;
    const long long qblocks = (static_cast<long long>(a.sq) + bq - 1) / bq;
    if (qblocks > kMaxQBlocks) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(static_cast<unsigned>(heads), static_cast<unsigned>(qblocks));
    if (!bf16) {
        flash_attn_kernel<D><<<grid, kThreads, 0, s>>>(a);
        return static_cast<int>(cudaGetLastError());
    }
    constexpr int bytes = mma_smem_bytes<D>();  // 87,040 at D = 128: above the 48 KB default
    // At every launch: cheap, legal inside a graph capture, and set for the
    // device that is current now.
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attn_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_attn_mma_kernel<D><<<grid, kMmaThreads, bytes, s>>>(a);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream`.  q (b, sq, kvh, g, d), k and v (b, sk,
// kvh, d), f32 or bf16 (`bf16`), each with the given strides (in elements)
// and stride 1 in the last dim; o (b, sq, kvh, g, d) contiguous, same type.
// bf16 runs on the tensor cores and needs every pointer 16-byte aligned and
// every stride but the last a multiple of 8 (the wrapper checks); f32 runs
// on the CUDA cores.  Returns cudaGetLastError(), the error of raising the
// shared-memory limit, or cudaErrorInvalidValue for an empty shape, a head
// dim the kernel is not compiled for, or a grid it cannot launch.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* o, int bf16,
                                 int b, int sq, int sk, int kvh, int g, int d, long long q_sb,
                                 long long q_ss, long long q_sh, long long q_sg, long long k_sb,
                                 long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                                 long long v_sh, int causal, float scale, void* stream) {
    if (b < 1 || sq < 1 || sk < 1 || kvh < 1 || g < 1) return static_cast<int>(cudaErrorInvalidValue);
    const long long heads = static_cast<long long>(b) * kvh * g;
    if (heads > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    const Args a{q, k, v, o, sq, sk, kvh, g, q_sb, q_ss, q_sh, q_sg, k_sb, k_ss, k_sh,
                 v_sb, v_ss, v_sh, causal, scale};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int h = static_cast<int>(heads);
    switch (d) {
        case 16: return launch_d<16>(a, h, bf16, s);
        case 32: return launch_d<32>(a, h, bf16, s);
        case 64: return launch_d<64>(a, h, bf16, s);
        case 128: return launch_d<128>(a, h, bf16, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
