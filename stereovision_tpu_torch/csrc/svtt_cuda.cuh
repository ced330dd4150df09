// Shared helpers of the port's CUDA kernels (support.cu, matching.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace svtt {

constexpr int kBig = 1 << 30;  // "no candidate" energy / key

// Sum of absolute differences of two 16-byte descriptors: four packed
// byte-SAD instructions on 32-bit words.
__device__ __forceinline__ int sad16(uint4 a, uint4 b) {
    return (int)(__vsadu4(a.x, b.x) + __vsadu4(a.y, b.y) +
                 __vsadu4(a.z, b.z) + __vsadu4(a.w, b.w));
}

}  // namespace svtt
