// The fused epilogue shared by the PIM matmul kernels.
//
// acc * scale [+ bias] -> activation -> [+ residual], all in f32, in that
// order: the device twin of repro_torch/kernels/epilogue.py:apply_epilogue
// (and of the JAX package's kernels/epilogue.py).  Every kernel that ends in
// this epilogue calls pim_epilogue, so the semantics cannot drift between
// kernels.
#pragma once

#include <cuda_bf16.h>

// Activation ids; repro_torch/kernels/epilogue.py:ACTIVATION_IDS numbers them
// the same way.
enum PimActivation { PIM_ACT_NONE = 0, PIM_ACT_RELU = 1, PIM_ACT_SILU = 2, PIM_ACT_GELU = 3 };

// Element i of an f32 or bf16 vector, as f32.
__device__ __forceinline__ float pim_load_f32(const void* p, bool is_bf16, size_t i) {
    return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                   : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float pim_activate(float y, int activation) {
    switch (activation) {
        case PIM_ACT_RELU:
            return fmaxf(y, 0.0f);
        case PIM_ACT_SILU:
            return y / (1.0f + expf(-y));
        case PIM_ACT_GELU: {
            // tanh form, as jax.nn.gelu and F.gelu(approximate="tanh")
            const float k0 = 0.7978845608028654f;  // sqrt(2/pi)
            return 0.5f * y * (1.0f + tanhf(k0 * (y + 0.044715f * y * y * y)));
        }
        default:
            return y;
    }
}

// bias, residual: null when absent, else f32 or bf16 as the flags say.
// n indexes the output column, mn the (row, column) element.
__device__ __forceinline__ float pim_epilogue(float acc, float scale,
                                              const void* bias, bool bias_bf16,
                                              const void* residual, bool residual_bf16,
                                              int activation, int n, size_t mn) {
    float y = acc * scale;
    if (bias != nullptr) y += pim_load_f32(bias, bias_bf16, n);
    y = pim_activate(y, activation);
    if (residual != nullptr) y += pim_load_f32(residual, residual_bf16, mn);
    return y;
}
