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
// disparities.  The disparities are exact integers here, so the float warp
// u -/+ s d is exact and its truncation is the reference's int(u -/+ s d)
// (elas.cpp:957-966).  Plain version: ops/postprocess.py
// (lr_consistency_check).
//
// What bounds it: bytes — two f32 maps read and two written (7.5 MB at
// KITTI size), a handful of operations each.  Design: one thread a pixel
// and a direct gather from the other map's row, which the L1 cache serves.
// The TPU kernel's loop over every disparity value (one lane roll per d,
// written to avoid gathers) has no counterpart.  Rows are independent, so
// a batch folds its frames into the row axis (blockIdx.y = b H + v).

#include <cuda_runtime.h>

namespace {

// One direction: keep Da[u] iff the other map agrees at u + sign * Da[u]
// * scale.
__device__ __forceinline__ float check(const float* Da_row,
                                       const float* Db_row, int u, int W,
                                       float sign, float scale, float thr) {
    const float d = Da_row[u];
    const float uw = (float)u + sign * d * scale;
    if (d >= 0.f && uw >= 0.f && uw < (float)W) {
        const float db = Db_row[(int)uw];
        if (!(fabsf(db - d) > thr)) return d;
    }
    return -10.f;
}

__global__ void lr_check_kernel(const float* __restrict__ D1,
                                const float* __restrict__ D2, int W,
                                float scale, float thr,
                                float* __restrict__ O1,
                                float* __restrict__ O2) {
    const int u = blockIdx.x * blockDim.x + threadIdx.x;
    const int v = blockIdx.y;
    if (u >= W) return;
    const size_t row = (size_t)v * W;
    O1[row + u] = check(D1 + row, D2 + row, u, W, -1.f, scale, thr);
    O2[row + u] = check(D2 + row, D1 + row, u, W, 1.f, scale, thr);
}

}  // namespace

// `frames` H x W maps each; scale: column warp per unit of disparity (1, or
// 0.5 on the half lattice).
extern "C" int svtt_lr_check(const void* D1, const void* D2, int frames,
                             int H, int W, float scale, float thr, void* O1,
                             void* O2, void* stream) {
    const dim3 block(128);
    const dim3 grid((W + 127) / 128, frames * H);
    lr_check_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float*)D1, (const float*)D2, W, scale, thr, (float*)O1,
        (float*)O2);
    return (int)cudaGetLastError();
}
