// Tensor-core building blocks shared by the PIM kernels for Hopper (sm_90a):
// pim_matvec, pim_matmul and bitplane_matmul.
//
// cp.async copies into shared memory (with zero fill), ldmatrix.trans
// fragments, the bf16 mma.sync m16n8k16 with f32 accumulation, and the exact
// widening of int8 and int4 codes to bf16 (every such code is exact in bf16,
// and a bf16 x times a code is exact in f32).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// Byte b of u as f32 minus `bias`: 0x4B0000nn is 2^23 + nn exactly.
__device__ __forceinline__ float byte_f32(uint32_t u, int b, float bias) {
    return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | b)) - bias;
}

// One ldmatrix.trans register of int8 codes, bytes (k, n), (k, n + 1),
// (k + 1, n), (k + 1, n + 1), as two bf16x2 A-fragment registers: (k, n) and
// (k + 1, n) for column n, the same for column n + 1.  An integer's f32 has
// zero low halves, so its high half is its bf16, exactly.
__device__ __forceinline__ void widen_int8(uint32_t r, uint32_t& col0, uint32_t& col1) {
    const uint32_t u = r ^ 0x80808080u;  // code + 128
    const uint32_t f0 = __float_as_uint(byte_f32(u, 0, 8388736.0f));  // 2^23 + 128
    const uint32_t f1 = __float_as_uint(byte_f32(u, 1, 8388736.0f));
    const uint32_t f2 = __float_as_uint(byte_f32(u, 2, 8388736.0f));
    const uint32_t f3 = __float_as_uint(byte_f32(u, 3, 8388736.0f));
    col0 = __byte_perm(f0, f2, 0x7632);
    col1 = __byte_perm(f1, f3, 0x7632);
}

// One ldmatrix.trans register of packed int4 codes (packed rows p, p + 1 x
// columns n, n + 1) as four bf16x2 A-fragment registers, one per byte: its
// low nibble (K row 2p') and high nibble (K row 2p' + 1).  A biased nibble v
// under bf16's 128 (0x43 0x00 | v) is 128 + v; one bf16x2 subtract of 136
// leaves the code, exactly.
__device__ __forceinline__ void widen_int4(uint32_t r, uint32_t (&a)[4]) {
    const uint32_t lo = (r & 0x0F0F0F0Fu) ^ 0x08080808u;  // nibble + 8
    const uint32_t hi = ((r >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
    const __nv_bfloat162 bias = __floats2bfloat162_rn(136.0f, 136.0f);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const uint32_t sel = j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12);
        uint32_t v = (__byte_perm(lo, hi, sel) & 0x00FF00FFu) | 0x43004300u;
        __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&v);
        h = __hsub2(h, bias);
        a[j] = *reinterpret_cast<uint32_t*>(&h);
    }
}
