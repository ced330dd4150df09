// K2: support-point matching scan.
//
// Replaces the Pallas kernel stereovision_tpu/ops/pallas/support_pl.py:50
// (_kernel, wrappers support_matches :211 and _support_scan :146; the
// batched mode's leading grid axis :52, :61, reached through the
// custom_vmap rule :168-200: here a third grid axis, one frame each).  It
// computes what that kernel computes: on every candidate row (rows v-2 and
// v+2 of v = step * k, 32 descriptor bytes per column) and every column u,
// for d ascending over [d_lo, d_hi], the best and second-best (energy, d)
//   forward   Fg(u)   = F(u-2) + F(u+2)        valid iff u >= d + 5
//   backward  Fg(u+d) = F(u+d-2) + F(u+d+2)    valid iff u <= W - d - 5
// with F(x) = SAD32(A(x), B(x - d)) and the strict-< update of
// support_pl.py:75-91.  A column outside [0, W) reads as zero bytes, as in
// the plain version (ops/support.py: support_scan).
//
// What bounds it: byte operations.  Both directions read one table F(x, d):
// at KITTI 1242x375, D = 256 the least work is one SAD32 per (row, x, d)
// that either reads, 75 x ~285k x 64, about 1.4 G byte operations over
// inputs of 6 MB, far above the card's ops/byte balance for 32-bit integer
// work.  Design: one thread per (row, column); the thread's own four
// 32-byte descriptors stay in registers across the whole d loop, each SAD
// is eight __vsadu4 on packed words, and d values whose direction is
// invalid are skipped, not masked, so no load or SAD is spent on them.
// This simple form recomputes F: each thread evaluates four SAD32 per d
// (F(u-2), F(u+2) forward, F(u+d-2), F(u+d+2) backward), about 4x the
// least work.  A tile that computes F(x, d) once in shared memory and
// combines it at x +- 2 and at u + d would remove that.
// The TPU kernel's lane rolls and carried shifted stripe have no
// counterpart: a thread addresses B(u - d) directly and the L1/L2 caches
// serve the neighbouring threads' overlapping reads.

#include "svtt_cuda.cuh"

namespace {

using svtt::kBig;
using svtt::sad16;

struct Desc32 {
    uint4 lo, hi;  // descriptor bytes of rows v-2 and v+2 at one column
};

__device__ __forceinline__ Desc32 load32(const uint4* row, int x, int W) {
    Desc32 r;
    if (x >= 0 && x < W) {
        r.lo = row[2 * x];
        r.hi = row[2 * x + 1];
    } else {
        r.lo = make_uint4(0u, 0u, 0u, 0u);
        r.hi = r.lo;
    }
    return r;
}

__device__ __forceinline__ int sad32(const Desc32& a, const Desc32& b) {
    return sad16(a.lo, b.lo) + sad16(a.hi, b.hi);
}

// Two-minimum update with strict <: ties keep the earlier (smaller) d.
__device__ __forceinline__ void keep_two(int cost, int d, int& e1, int& d1,
                                         int& e2, int& d2) {
    if (cost < e1) {
        e2 = e1;
        d2 = d1;
        e1 = cost;
        d1 = d;
    } else if (cost < e2) {
        e2 = cost;
        d2 = d;
    }
}

// Per frame b = blockIdx.z: A, B: (Hc, W, 32) uint8 as (Hc, W, 2) uint4;
// out: (8, Hc, W) int32.
__global__ void support_scan_kernel(const uint4* __restrict__ A,
                                    const uint4* __restrict__ B, int Hc,
                                    int W, int d_lo, int d_hi,
                                    int* __restrict__ out) {
    const int u = blockIdx.x * blockDim.x + threadIdx.x;
    const int r = blockIdx.y;
    const size_t b = blockIdx.z;
    if (u >= W) return;
    const uint4* Arow = A + (b * Hc + r) * W * 2;
    const uint4* Brow = B + (b * Hc + r) * W * 2;
    const Desc32 a_m = load32(Arow, u - 2, W);
    const Desc32 a_p = load32(Arow, u + 2, W);
    const Desc32 b_m = load32(Brow, u - 2, W);
    const Desc32 b_p = load32(Brow, u + 2, W);
    int f1e = kBig, f1d = -1, f2e = kBig, f2d = -1;
    int b1e = kBig, b1d = -1, b2e = kBig, b2d = -1;
    // An invalid d scores kBig, which never passes the strict <, so
    // skipping it leaves the minima as the masked scan leaves them.
    for (int d = d_lo; d <= d_hi; ++d) {
        if (u >= d + 5) {
            const int fg = sad32(a_m, load32(Brow, u - 2 - d, W)) +
                           sad32(a_p, load32(Brow, u + 2 - d, W));
            keep_two(fg, d, f1e, f1d, f2e, f2d);
        }
        if (u <= W - d - 5) {
            const int bg = sad32(load32(Arow, u + d - 2, W), b_m) +
                           sad32(load32(Arow, u + d + 2, W), b_p);
            keep_two(bg, d, b1e, b1d, b2e, b2d);
        }
    }
    const size_t plane = (size_t)Hc * W;
    out += b * 8 * plane;
    const size_t i = (size_t)r * W + u;
    out[i] = f1e;
    out[plane + i] = f1d;
    out[2 * plane + i] = f2e;
    out[3 * plane + i] = f2d;
    out[4 * plane + i] = b1e;
    out[5 * plane + i] = b1d;
    out[6 * plane + i] = b2e;
    out[7 * plane + i] = b2d;
}

}  // namespace

extern "C" int svtt_support_scan(const void* A, const void* B, int frames,
                                 int Hc, int W, int d_lo, int d_hi, void* out,
                                 void* stream) {
    const dim3 block(128);
    const dim3 grid((W + 127) / 128, Hc, frames);
    support_scan_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const uint4*)A, (const uint4*)B, Hc, W, d_lo, d_hi, (int*)out);
    return (int)cudaGetLastError();
}
