// Shared helpers of the port's CUDA kernels (support.cu, matching.cu,
// lr.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace svtt {

constexpr int kBig = 1 << 30;  // "no candidate" energy / key

// Sum of the four byte-wise |a - b| of two packed words, plus acc: one
// VABSDIFF4.U8.ACC instruction on sm_90a.
__device__ __forceinline__ unsigned sad4(unsigned a, unsigned b,
                                         unsigned acc) {
    unsigned r;
    asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
        : "=r"(r)
        : "r"(a), "r"(b), "r"(acc));
    return r;
}

// Sum of absolute differences of two 16-byte descriptors, plus acc.
__device__ __forceinline__ unsigned sad16_acc(uint4 a, uint4 b,
                                             unsigned acc) {
    acc = sad4(a.x, b.x, acc);
    acc = sad4(a.y, b.y, acc);
    acc = sad4(a.z, b.z, acc);
    return sad4(a.w, b.w, acc);
}

// Bytes p[0], p[plane], p[2 plane], p[3 plane] packed into one word, the
// first in the low byte: one column of four descriptor planes.
__device__ __forceinline__ unsigned pack4(const uint8_t* p, size_t plane) {
    return (unsigned)__ldg(p) | (unsigned)__ldg(p + plane) << 8 |
           (unsigned)__ldg(p + 2 * plane) << 16 |
           (unsigned)__ldg(p + 3 * plane) << 24;
}

// The 16-byte descriptor of one pixel from the 16 planes of a (16, H, W)
// stack: p points at the pixel in plane 0, planes lie `plane` bytes apart.
__device__ __forceinline__ uint4 column16(const uint8_t* p, size_t plane) {
    return make_uint4(pack4(p, plane), pack4(p + 4 * plane, plane),
                      pack4(p + 8 * plane, plane),
                      pack4(p + 12 * plane, plane));
}

constexpr int kMaxDevices = 64;

// The current device's opt-in maximum of dynamic shared memory a block,
// found once per device by `setup(limit)`, which sets it on the kernels
// that need it (once, so no launch from another thread ever lowers it) and
// returns a CUDA error; the negated error if either failed.  Each caller
// passes its own `once` and `limit` tables (one per kernel family).
template <typename Setup>
int smem_limit_once(std::once_flag* once, int* limit, Setup setup) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return -(int)e;
    if (dev >= kMaxDevices) return -(int)cudaErrorInvalidDevice;
    std::call_once(once[dev], [dev, limit, setup] {
        int v = 0;
        cudaError_t e = cudaDeviceGetAttribute(
            &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (e == cudaSuccess) e = setup(v);
        limit[dev] = e == cudaSuccess ? v : -(int)e;
    });
    return limit[dev];
}

}  // namespace svtt
