// K4: left/right consistency check, at full resolution and on the half
// lattice, one frame or a batch of frames a launch.
//
// Replaces the Pallas kernel stereovision_tpu/ops/pallas/lr_pl.py:36
// (_kernel, both modes: the half warp of sub=True :50-55; the batched
// mode :38-43, :76-81, reached through the custom_vmap rule :145-160;
// wrapper lr_consistency_check :122): a D1 pixel is kept iff
// |D2[trunc(u - s d)] - d| <= thr, a D2 pixel iff |D1[trunc(u + s d)] - d|
// <= thr, and becomes -10 otherwise or when the warped column leaves the
// row; s is 1, or 0.5 on the half lattice, whose maps hold full-resolution
// disparities.  The float warp u -/+ s d and its truncation are the plain
// version's, for any float map (the pipeline's maps hold integers, for
// which they are the reference's int(u -/+ s d), elas.cpp:957-966).  Plain
// version: ops/postprocess.py (lr_consistency_check).
//
// What bounds it: bytes, two f32 maps read and two written (7.5 MB at
// KITTI 1242x375, 2.2 us at 3.35 TB/s), a handful of operations each; at
// that size one launch is within a few microseconds of the launch floor:
// on an H100 it takes 4.2 us of device time where an empty kernel takes
// 1.8 (launches queued back to back behind a spin kernel, floor.cu).
// Design: one block per row (blockIdx.x = v, blockIdx.y = frame b).  The
// block loads both rows, D1's and D2's, into shared memory (8 W bytes,
// 9.9 KB at W = 1242) with coalesced 4-byte loads, computes both
// directions from shared memory and writes both output rows coalesced.  A
// 4968-byte row is 8- but not 16-byte aligned on odd rows, so the loads
// are scalar: a warp's 32 neighbouring floats are already whole sectors.
// It replaced a first design (one thread a pixel in a 2-D grid, the warped
// value gathered from global memory through the L1 cache), which read each
// row of the other map again at data-dependent columns.  The TPU kernel's
// loop over every disparity value (one lane roll per d, written to avoid
// gathers) has no counterpart.
//
// The ceiling: rows wider than 48 KB / 8 = 6144 columns need the device's
// opt-in shared memory, given once per device (29056 columns on an H100);
// svtt_lr_max_width reports it and lr_cu.launch raises past it.
//
// Row stripes (the sharded mode of lr_pl.py:122-165: row stripes over the
// mesh's 'tile' axis, no halo; the check never leaves a row): the inputs
// may be a stripe of each frame's rows, a view whose frames lie fstride
// floats apart; the outputs are contiguous.

#include "svtt_cuda.cuh"

namespace {

constexpr int kThreads = 256;

// One direction: keep Da[u] iff the other row agrees at u + sign * Da[u]
// * scale.
__device__ __forceinline__ float check(const float* Da, const float* Db,
                                       int u, int W, float sign, float scale,
                                       float thr) {
    const float d = Da[u];
    const float uw = (float)u + sign * d * scale;
    if (d >= 0.f && uw >= 0.f && uw < (float)W) {
        if (!(fabsf(Db[(int)uw] - d) > thr)) return d;
    }
    return -10.f;
}

// D1, D2: frames of H rows of W floats, fstride floats apart; O1, O2:
// contiguous rows; row v = blockIdx.x of frame b = blockIdx.y.  Dynamic
// shared memory: 2 W floats.
__global__ void __launch_bounds__(kThreads)
    lr_check_kernel(const float* __restrict__ D1,
                    const float* __restrict__ D2, int H, int W,
                    long long fstride, float scale, float thr,
                    float* __restrict__ O1, float* __restrict__ O2) {
    extern __shared__ float rows[];
    float* r1 = rows;
    float* r2 = rows + W;
    const size_t row = ((size_t)blockIdx.y * H + blockIdx.x) * W;
    const size_t in = blockIdx.y * fstride + (size_t)blockIdx.x * W;
    for (int u = threadIdx.x; u < W; u += kThreads) {
        r1[u] = D1[in + u];
        r2[u] = D2[in + u];
    }
    __syncthreads();
    for (int u = threadIdx.x; u < W; u += kThreads) {
        O1[row + u] = check(r1, r2, u, W, -1.f, scale, thr);
        O2[row + u] = check(r2, r1, u, W, 1.f, scale, thr);
    }
}

// The device's opt-in maximum of dynamic shared memory a block, set on the
// kernel once per device; the negated CUDA error if that failed.
int smem_limit() {
    static std::once_flag once[svtt::kMaxDevices];
    static int limit[svtt::kMaxDevices];
    return svtt::smem_limit_once(once, limit, [](int v) {
        return cudaFuncSetAttribute(
            lr_check_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, v);
    });
}

}  // namespace

// The widest row whose two maps fit the current device's shared memory;
// a launch past it fails with cudaErrorInvalidValue.
extern "C" int svtt_lr_max_width(int* W) {
    const int lim = smem_limit();
    if (lim < 0) return -lim;
    *W = lim / (int)(2 * sizeof(float));
    return (int)cudaSuccess;
}

// `frames` H x W maps each, the inputs' frames fstride floats apart (H W
// for whole frames), the outputs contiguous; scale: column warp per unit
// of disparity (1, or 0.5 on the half lattice).
extern "C" int svtt_lr_check(const void* D1, const void* D2, int frames,
                             int H, int W, long long fstride, float scale,
                             float thr, void* O1, void* O2, void* stream) {
    const size_t smem = 2 * sizeof(float) * (size_t)W;
    const int lim = smem_limit();
    if (lim < 0) return -lim;
    if (smem > (size_t)lim) return (int)cudaErrorInvalidValue;
    if (frames == 0 || H == 0 || W == 0) return (int)cudaSuccess;
    if (frames > 65535) return (int)cudaErrorInvalidValue;
    lr_check_kernel<<<dim3(H, frames), kThreads, smem,
                      (cudaStream_t)stream>>>(
        (const float*)D1, (const float*)D2, H, W, fstride, scale, thr,
        (float*)O1, (float*)O2);
    return (int)cudaGetLastError();
}
