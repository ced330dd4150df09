// K1: dense MAP matching, at full resolution and on the half lattice, one
// frame or a batch of frames a launch.
//
// Replaces the Pallas kernel stereovision_tpu/ops/pallas/matching_pl.py:60
// (_kernel, both modes: sub=True reads even/odd B planes :62-66, shifts by
// d>>1 :96 and warps the full-res column 2u :121; the batched mode's
// leading grid axis :72, :76-88, reached through the custom_vmap rule
// :278-293; wrappers compute_disparity :313 and compute_disparity_pair
// :476, helpers _pack_bytes :295 and _active_lists :302).  Per output pixel (x, y), at
// the full-resolution pixel (u, v) = (s x, s y) with lattice step s = 1 or
// 2, it returns the minimum over its candidate disparities of the key
//   ((SAD16 + prior + off) * 2 + in_window) * 512 + d     (:135)
// where the candidates are the set bits of the cell of (u, v) outside the
// plane window [d_lo, d_hi] plus the window itself, and the warped column
// u -/+ d must lie in [2, W-3].  The key carries d in its low 9 bits, so it
// is a total order and the minimum does not depend on the visiting order.
// The plane maps (d_lo, d_hi, d_plane, pvalid) come from the PyTorch prep;
// the kernel never evaluates the plane.  Plain version: ops/matching.py
// (match_keys).
//
// What bounds it: bytes.  The inputs are 2 x 7.5 MB of descriptors plus
// the cell words and four int32 maps (24 MB at KITTI 1242x375), while the
// work is a data-dependent candidate count (about 12 candidates a pixel on
// a KITTI-size scene, each a 16-byte SAD).  Design: one thread a
// pixel; descriptors are laid out (H, W, 16) by the wrapper, so a pixel's
// descriptor is one 16-byte load and its SAD four __vsadu4.  Each thread
// walks only its own candidates — the set bits of its cell's packed words
// (__ffs) and its window — instead of the TPU kernel's per-block active
// lists, lane windows and rolls.  On the half lattice A holds only the
// lattice's columns while B keeps its full rows, so a thread's warp s x -/+ d
// is still one 16-byte load: the TPU kernel's even/odd B planes and
// per-parity active lists have no counterpart.  A batch is a third grid
// axis (blockIdx.z = frame) over per-frame strides of every array but the
// prior table, which all frames share.

#include "svtt_cuda.cuh"

namespace {

using svtt::kBig;
using svtt::sad16;

// Per frame b = blockIdx.z: A: (Ho, Wo, 16) uint8 as (Ho, Wo) uint4, the
// lattice's descriptors; B: (Ho, W, 16) as (Ho, W) uint4, full rows;
// cell_bits: (Gh, Gw, nwords) packed candidate words (bit b of word w =
// disparity 32 w + b); d_lo/d_hi/d_plane/pvalid: (Ho, Wo) int32.  prior:
// (D,) int32, one table for every frame.
__global__ void match_keys_kernel(
    const uint4* __restrict__ A, const uint4* __restrict__ B,
    const unsigned* __restrict__ cell_bits, const int* __restrict__ d_lo,
    const int* __restrict__ d_hi, const int* __restrict__ d_plane,
    const int* __restrict__ pvalid, const int* __restrict__ prior, int Ho,
    int Wo, int W, int step, int D, int nwords, int gs, int Gh, int Gw,
    int off, int right, int* __restrict__ key) {
    const int x = blockIdx.x * blockDim.x + threadIdx.x;
    const int y = blockIdx.y;
    const size_t b = blockIdx.z;
    if (x >= Wo) return;
    const int u = step * x;  // full-resolution column and row
    const int v = step * y;
    const size_t i = (b * Ho + y) * Wo + x;
    const uint4 a = A[i];
    const uint4* Brow = B + (b * Ho + y) * W;
    const int lo = d_lo[i];
    const int hi = d_hi[i];
    int best = kBig;

    // grid candidates outside the window: raw SAD, in_window = 0
    const unsigned* cw =
        cell_bits + (((b * Gh) + v / gs) * Gw + u / gs) * nwords;
    for (int w = 0; w < nwords; ++w) {
        unsigned bits = cw[w];
        while (bits) {
            const int d = w * 32 + __ffs(bits) - 1;
            bits &= bits - 1;
            if (d >= lo && d <= hi) continue;
            const int uw = right ? u + d : u - d;
            if (uw < 2 || uw > W - 3) continue;
            best = min(best, (sad16(a, Brow[uw]) + off) * 2 * 512 + d);
        }
    }

    // the plane window: SAD + prior, in_window = 1
    const int dp = d_plane[i];
    const bool pv = pvalid[i] != 0;
    for (int d = lo; d <= hi; ++d) {
        const int uw = right ? u + d : u - d;
        if (uw < 2 || uw > W - 3) continue;
        const int delta = min(abs(d - dp), D - 1);
        const int pr = pv ? prior[delta] : 0;
        best = min(best, ((sad16(a, Brow[uw]) + pr + off) * 2 + 1) * 512 + d);
    }
    key[i] = best;
}

}  // namespace

// `frames` frames, each an Ho x Wo output lattice of step `step` over rows
// of W columns and a Gh x Gw cell grid.
extern "C" int svtt_match_keys(const void* A, const void* B,
                               const void* cell_bits, const void* d_lo,
                               const void* d_hi, const void* d_plane,
                               const void* pvalid, const void* prior,
                               int frames, int Ho, int Wo, int W, int step,
                               int D, int nwords, int gs, int Gh, int Gw,
                               int off, int right, void* key, void* stream) {
    const dim3 block(128);
    const dim3 grid((Wo + 127) / 128, Ho, frames);
    match_keys_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const uint4*)A, (const uint4*)B, (const unsigned*)cell_bits,
        (const int*)d_lo, (const int*)d_hi, (const int*)d_plane,
        (const int*)pvalid, (const int*)prior, Ho, Wo, W, step, D, nwords,
        gs, Gh, Gw, off, right, (int*)key);
    return (int)cudaGetLastError();
}
