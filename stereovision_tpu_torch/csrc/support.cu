// K2: support-point matching scan.
//
// Replaces the Pallas kernel stereovision_tpu/ops/pallas/support_pl.py:50
// (_kernel, wrappers support_matches :211 and _support_scan :146; the
// batched mode's leading grid axis :52, :61, reached through the
// custom_vmap rule :168-200: here a third grid axis, one frame each).  It
// computes what that kernel computes: on every candidate row (rows v-2 and
// v+2 of v = step * k, clipped to the frame, 32 descriptor bytes per
// column) and every column u, for d ascending over [d_lo, d_hi], the best
// and second-best (energy, d)
//   forward   Fg(u)   = F(u-2) + F(u+2)        valid iff u >= d + 5
//   backward  Fg(u+d) = F(u+d-2) + F(u+d+2)    valid iff u <= W - d - 5
// with F(x) = SAD32(A(x), B(x - d)) and the strict-< update of
// support_pl.py:75-91.  A column outside [0, W) reads as zero bytes, as in
// the plain version (ops/support.py: support_scan).
//
// What bounds it: byte operations.  Both directions read one table F(x, d):
// at KITTI 1242x375, D = 256 the least work is one SAD32 per (row, x, d)
// that either reads, 75 x ~285k x 64, about 1.4 G byte operations over
// inputs of 15 MB, far above the card's ops/byte balance for 32-bit
// integer work.  Design: one block per (frame, candidate row, segment of S
// output columns), one thread an output column.  The block reads the
// descriptor planes (..., 16, H, W) itself: each thread gathers one
// column's 32 bytes (16 planes of rows v-2 and v+2; a warp reads 32
// neighbouring bytes of one plane row a load) and packs them into two
// 16-byte vectors in shared memory, A over [u0-2, u0+S+d_top+2), B over
// [u0-2-d_top, u0+S+2), zero outside the frame, so no loop below tests a
// bound.  It then walks d in chunks of 16.  For each chunk it computes
// F(x, d) once for the x that the segment's valid outputs read (x <
// u0+S+d+2 at most) into an int16 table (SAD32 <= 8160); a thread fills
// two neighbouring columns over the chunk's 16 d with A in registers and
// B carried from one d to the next (B(x+1-d-1) = B(x-d)), one 16-byte
// shared load per SAD32.  Each thread then reads its forward pair at x =
// u-/+2 and its backward pair at x = u+d-/+2 from the table.  That is
// (S + d + 4) / S SAD32 per (u, d), about 1.5 at S = 256 (the last
// segment of a row needs only its own width), where a thread of the first
// port's kernel computed four (F(u-2), F(u+2), F(u+d-2), F(u+d+2)), 4x the
// least work, from bounds-checked global loads.  It replaced that design
// for this reason, and because the first port laid the candidate rows out
// in torch ops before every launch (a gather and a transpose, 0.6 ms a
// frame on an H100).  Chunks of d in which no output of the segment is
// valid in either direction end the walk (validity only shrinks as d
// grows).  Each SAD32 is eight vabsdiff4 with accumulate on packed words,
// one VABSDIFF4.U8.ACC instruction each on sm_90a (__vabsdiffu4 plus
// __dp4a would add an IDP.4A to each; a byte-wise min has no instruction
// of its own).  The TPU kernel's lane rolls and carried shifted stripe
// have no counterpart.
//
// The ceiling: the windows and the table take about 96 (S + d_top + 5)
// bytes of shared memory, 49.5 KB at D = 256 and S = 256, where d_top =
// min(disp_max, W - 5).  The kernel is given the device's opt-in maximum
// once per device (227 KB on an H100, so d_top <= 2160);
// svtt_support_max_span reports the ceiling, and support_cu.launch raises
// past it.  Segments of 128 and 512 columns were slower than 256 in every
// mode on an H100.
//
// Row stripes (the sharded mode of support_pl.py:146-190: candidate-row
// stripes over the mesh's 'tile' axis, no halo): a launch may cover the
// candidate rows [first, first + count) only, reading a slab of the planes
// whose row 0 is frame row row0, with the clamp clip(v -/+ 2, 0, H - 1)
// taken at the frame's true height H.  The planes may be a view (frame
// and plane strides given), so a stripe on the frame's own device reads
// the frame in place.

#include "svtt_cuda.cuh"

namespace {

using svtt::kBig;
using svtt::pack4;
using svtt::sad16_acc;

constexpr int kChunk = 16;     // d values a table
constexpr int kSegment = 256;  // output columns a block (S)

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

// Column x of one candidate row's 32 bytes: planes 0-15 of row ra (lo),
// of row rb (hi); zero outside [0, W).
__device__ __forceinline__ void gather(const uint8_t* desc, size_t plane,
                                       int ra, int rb, int W, int x,
                                       uint4* lo, uint4* hi) {
    uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
    if (x >= 0 && x < W) {
        const uint8_t* pa = desc + (size_t)ra * W + x;
        const uint8_t* pb = desc + (size_t)rb * W + x;
        a = make_uint4(pack4(pa, plane), pack4(pa + 4 * plane, plane),
                       pack4(pa + 8 * plane, plane),
                       pack4(pa + 12 * plane, plane));
        b = make_uint4(pack4(pb, plane), pack4(pb + 4 * plane, plane),
                       pack4(pb + 8 * plane, plane),
                       pack4(pb + 12 * plane, plane));
    }
    *lo = a;
    *hi = b;
}

// Per frame b = blockIdx.z: desc1, desc2 16 uint8 planes of a slab whose
// row 0 is frame row row0 (frames fstride bytes apart, planes `plane`
// bytes apart, rows W); out (8, count, W) int32.  Block: S = kSegment
// threads on candidate row first + blockIdx.y of a frame of H rows, output
// columns [u0, u0 + S), u0 = S blockIdx.x.  d_top = min(d_hi, W - 5): no
// output is valid at a larger d.  Dynamic shared memory: smem_bytes(d_top).
__global__ void __launch_bounds__(kSegment)
    support_scan_kernel(const uint8_t* __restrict__ desc1,
                        const uint8_t* __restrict__ desc2, long long fstride,
                        long long plane, int H, int row0, int first, int W,
                        int step, int d_lo, int d_top, int* __restrict__ out) {
    constexpr int S = kSegment;
    extern __shared__ uint4 smem[];
    const int N = S + max(d_top, 0) + 4;  // window columns
    const int NT = (N + 1) & ~1;         // table row, even: pairs store
    // one spare column each: a pair may read one past the window for an
    // entry that no output reads
    uint4* A_lo = smem;  // A(u0 - 2 + x), x in [0, N)
    uint4* A_hi = A_lo + N + 1;
    uint4* B_lo = A_hi + N + 1;  // B(u0 - 2 - d_top + i)
    uint4* B_hi = B_lo + N + 1;
    short* T = (short*)(B_hi + N + 1);  // kChunk rows: F(u0 - 2 + x, d)

    const int t = threadIdx.x;
    const int u0 = blockIdx.x * S, u = u0 + t;
    const int r = blockIdx.y;
    const int Hc = gridDim.y;
    const size_t b = blockIdx.z;
    const int vc = (first + r) * step;
    const int ra = min(max(vc - 2, 0), H - 1) - row0;
    const int rb = min(max(vc + 2, 0), H - 1) - row0;
    const int ue = min(u0 + S, W);  // the segment's outputs: [u0, ue)
    const int Se = ue - u0;

    int f1e = kBig, f1d = -1, f2e = kBig, f2d = -1;
    int b1e = kBig, b1d = -1, b2e = kBig, b2d = -1;
    if (d_lo <= d_top) {
        const uint8_t* d1 = desc1 + b * fstride;
        const uint8_t* d2 = desc2 + b * fstride;
        for (int i = t; i < N; i += S) {
            gather(d1, plane, ra, rb, W, u0 - 2 + i, A_lo + i, A_hi + i);
            gather(d2, plane, ra, rb, W, u0 - 2 - d_top + i, B_lo + i,
                   B_hi + i);
        }
        __syncthreads();
    }
    for (int dA = d_lo; dA <= d_top; dA += kChunk) {
        // validity only shrinks as d grows: once no output of the segment
        // is valid in either direction, none is at a larger d
        if (ue - 1 < dA + 5 && u0 > W - dA - 5) break;
        const int nd = min(kChunk, d_top - dA + 1);
        // The table entries F(x, d) that valid outputs read: forward
        // u in [u0, ue) reads x = u - u0 and u - u0 + 4, x < Se + 4;
        // backward u <= W - d - 5 reads x = u - u0 + d (+ 4), x <
        // min(Se + d + 4, W - u0).  A thread fills two neighbouring
        // columns over the chunk's d: A stays in registers, and B(x - d)
        // of the right column at d is B of the left one at d - 1.
        const int C = max(Se + 4, min(Se + dA + nd + 3, W - u0));
        for (int x0 = 2 * t; x0 < C; x0 += 2 * S) {
            const uint4 a0l = A_lo[x0], a0h = A_hi[x0];
            const uint4 a1l = A_lo[x0 + 1], a1h = A_hi[x0 + 1];
            int j = x0 < Se + 4 ? 0 : max(0, x0 - Se - dA - 3);
            int k = x0 + d_top - dA - j;  // B index of (x0, dA + j)
            uint4 bl = B_lo[k + 1], bh = B_hi[k + 1];
            for (; j < nd; ++j, --k) {
                const uint4 cl = B_lo[k], ch = B_hi[k];
                const unsigned f0 =
                    sad16_acc(a0h, ch, sad16_acc(a0l, cl, 0u));
                const unsigned f1 =
                    sad16_acc(a1h, bh, sad16_acc(a1l, bl, 0u));
                *(unsigned*)(T + j * NT + x0) = f0 | f1 << 16;
                bl = cl;
                bh = ch;
            }
        }
        __syncthreads();
        if (u < W) {
            for (int j = 0; j < nd; ++j) {
                const int d = dA + j;
                const short* Tj = T + j * NT;
                if (u >= d + 5)
                    keep_two((int)Tj[t] + (int)Tj[t + 4], d, f1e, f1d, f2e,
                             f2d);
                if (u <= W - d - 5)
                    keep_two((int)Tj[t + d] + (int)Tj[t + d + 4], d, b1e,
                             b1d, b2e, b2d);
            }
        }
        __syncthreads();
    }
    if (u >= W) return;
    const size_t outplane = (size_t)Hc * W;
    out += b * 8 * outplane + (size_t)r * W + u;
    out[0] = f1e;
    out[outplane] = f1d;
    out[2 * outplane] = f2e;
    out[3 * outplane] = f2d;
    out[4 * outplane] = b1e;
    out[5 * outplane] = b1d;
    out[6 * outplane] = b2e;
    out[7 * outplane] = b2d;
}

// Dynamic shared memory of a block when no output is valid past d_top:
// four uint4 windows of N + 1 columns and kChunk int16 table rows.
size_t smem_bytes(int d_top) {
    const size_t N = kSegment + (d_top > 0 ? d_top : 0) + 4;
    return 4 * sizeof(uint4) * (N + 1) + kChunk * 2 * ((N + 1) & ~(size_t)1);
}

// The device's opt-in maximum of dynamic shared memory a block, set on the
// kernel once for each device in the process (so no launch from another
// thread ever lowers it); the negated CUDA error if that failed.
int smem_limit() {
    static std::once_flag once[svtt::kMaxDevices];
    static int limit[svtt::kMaxDevices];
    return svtt::smem_limit_once(once, limit, [](int v) {
        return cudaFuncSetAttribute(
            support_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            v);
    });
}

}  // namespace

// The largest d_top = min(disp_max, W - 5) whose window fits the current
// device's shared memory (2160 on an H100: 227 KB); a launch past it
// fails with cudaErrorInvalidValue.
extern "C" int svtt_support_max_span(int* d_top) {
    const int lim = smem_limit();
    if (lim < 0) return -lim;
    int d = (int)(lim / (6 * sizeof(uint4))) - kSegment - 5;
    while (smem_bytes(d + 1) <= (size_t)lim) ++d;
    while (d > 0 && smem_bytes(d) > (size_t)lim) --d;
    *d_top = d;
    return (int)cudaSuccess;
}

// desc1, desc2: `frames` stacks of 16 uint8 planes of W columns, frames
// fstride bytes apart and planes `plane` bytes apart, whose row 0 is row
// row0 of a frame of H rows; out: `frames` (8, count, W) int32, the scan
// of candidate rows [first, first + count).  A whole (16, H, W) frame:
// fstride 16 H W, plane H W, row0 and first 0, count ceil(H / step).
extern "C" int svtt_support_scan(const void* desc1, const void* desc2,
                                 int frames, long long fstride,
                                 long long plane, int H, int row0, int first,
                                 int count, int W, int step, int d_lo,
                                 int d_hi, void* out, void* stream) {
    const int d_top = d_hi < W - 5 ? d_hi : W - 5;
    const size_t smem = smem_bytes(d_top);
    const int lim = smem_limit();
    if (lim < 0) return -lim;
    if (smem > (size_t)lim) return (int)cudaErrorInvalidValue;
    if (frames == 0 || count == 0) return (int)cudaSuccess;
    const dim3 grid((W + kSegment - 1) / kSegment, count, frames);
    support_scan_kernel<<<grid, kSegment, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)desc1, (const uint8_t*)desc2, fstride, plane, H, row0,
        first, W, step, d_lo, d_top, (int*)out);
    return (int)cudaGetLastError();
}
