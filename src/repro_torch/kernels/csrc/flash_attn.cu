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
// multiply-adds against about 117 MB of q, k, v and output.  This design is
// the simple one: f32 FMAs on the CUDA cores (no tensor cores, no TMA, no
// pipelining of the tile loads), so the f32 CUDA-core rate is its ceiling.
// What the design does:
//   * one block of 128 threads per (query head, 32 query rows); a query row
//     is owned by 4 neighbouring lanes, each holding a quarter of q's row and
//     of the f32 accumulator in registers (D / 4 values each: 32 at D = 128),
//     so the accumulator never leaves registers.  A lane's quarter is the
//     float4 chunks c with c % 4 == lane % 4, which makes the 4 lanes read 64
//     contiguous bytes of shared memory at once (no bank conflicts);
//   * K and V stream through shared memory in tiles of 32 keys, widened to
//     f32 once per tile as they are stored there (32 KB a block at D = 128);
//   * a tile's 32 scores are dot products reduced over the 4 lanes of a row
//     with two __shfl_xor_sync (every lane ends with the same bits), kept in
//     registers; the row's max moves once per tile, the accumulator and
//     denominator are rescaled once per tile by exp(m_old - m_new), which is
//     exp(-inf) = 0 on the first tile, never NaN;
//   * masked scores (causal, or keys past Sk, which load as 0) are -inf and
//     weigh exp(-inf) = 0; with `causal` a block stops at the tile holding
//     its last row's key, so tiles wholly above the diagonal are skipped;
//   * the query blocks run heaviest first (the last rows see the most keys
//     under `causal`), so the short blocks fill the tail of the grid;
//   * plain expf and IEEE division (the library builds without fast-math).
// It allocates nothing: the caller passes the output and the stream.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;             // threads per block
constexpr int kParts = 4;                 // lanes per query row
constexpr int kBQ = kThreads / kParts;    // query rows per block
constexpr int kBKV = 32;                  // keys per shared-memory tile
constexpr int kMaxQBlocks = 65535;        // gridDim.y

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int D, typename T>
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

    const T* qp = static_cast<const T*>(a.q) + b * a.q_sb +
                  static_cast<long long>(live ? qi : 0) * a.q_ss + h * a.q_sh + gi * a.q_sg;
    const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
    const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;

    float qr[kOwn], acc[kOwn];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            qr[4 * c + e] = live ? to_f32(qp[16 * c + 4 * part + e]) : 0.0f;
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
            ks[j][d] = in ? to_f32(kp[key * a.k_ss + d]) : 0.0f;
            vs[j][d] = in ? to_f32(vp[key * a.v_ss + d]) : 0.0f;
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
    T* op = static_cast<T*>(a.o) +
            (((static_cast<long long>(b) * a.sq + qi) * a.kvh + h) * a.g + gi) * D;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) store(&op[16 * c + 4 * part + e], acc[4 * c + e] / den);
    }
}

template <int D>
void launch_d(const Args& a, dim3 grid, int bf16, cudaStream_t s) {
    if (bf16)
        flash_attn_kernel<D, __nv_bfloat16><<<grid, kThreads, 0, s>>>(a);
    else
        flash_attn_kernel<D, float><<<grid, kThreads, 0, s>>>(a);
}

}  // namespace

// Launches the kernel on `stream`.  q (b, sq, kvh, g, d), k and v (b, sk,
// kvh, d), f32 or bf16 (`bf16`), each with the given strides (in elements)
// and stride 1 in the last dim; o (b, sq, kvh, g, d) contiguous, same type.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for an empty shape, a
// head dim the kernel is not compiled for, or a grid it cannot launch.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* o, int bf16,
                                 int b, int sq, int sk, int kvh, int g, int d, long long q_sb,
                                 long long q_ss, long long q_sh, long long q_sg, long long k_sb,
                                 long long k_ss, long long k_sh, long long v_sb, long long v_ss,
                                 long long v_sh, int causal, float scale, void* stream) {
    if (b < 1 || sq < 1 || sk < 1 || kvh < 1 || g < 1) return static_cast<int>(cudaErrorInvalidValue);
    const long long heads = static_cast<long long>(b) * kvh * g;
    const long long qblocks = (static_cast<long long>(sq) + kBQ - 1) / kBQ;
    if (heads > INT_MAX || qblocks > kMaxQBlocks) return static_cast<int>(cudaErrorInvalidValue);
    const Args a{q, k, v, o, sq, sk, kvh, g, q_sb, q_ss, q_sh, q_sg, k_sb, k_ss, k_sh,
                 v_sb, v_ss, v_sh, causal, scale};
    const dim3 grid(static_cast<unsigned>(heads), static_cast<unsigned>(qblocks));
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (d) {
        case 16: launch_d<16>(a, grid, bf16, s); break;
        case 32: launch_d<32>(a, grid, bf16, s); break;
        case 64: launch_d<64>(a, grid, bf16, s); break;
        case 128: launch_d<128>(a, grid, bf16, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
