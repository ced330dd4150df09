// K1: dense MAP matching, at full resolution and on the half lattice, one
// frame or a batch of frames a launch.
//
// Replaces the Pallas kernel stereovision_tpu/ops/pallas/matching_pl.py:60
// (_kernel, both modes: sub=True reads even/odd B planes :62-66, shifts by
// d>>1 :96 and warps the full-res column 2u :121; the batched mode's
// leading grid axis :72, :76-88, reached through the custom_vmap rule
// :278-293; wrappers compute_disparity :313 and compute_disparity_pair
// :476, helpers _pack_bytes :295 and _active_lists :302).  Per output pixel
// (x, y), at the full-resolution pixel (u, v) = (s x, s y) with lattice
// step s = 1 or 2, it returns the minimum over its candidate disparities of
// the key
//   ((SAD16 + prior + off) * 2 + in_window) * 512 + d     (:135)
// where the candidates are the set bits of the cell of (u, v) outside the
// plane window [d_lo, d_hi] plus the window itself (within [0, D)), the
// descriptors are those of row clip(v, 2, H-3) of both images, and the
// warped column u -/+ d must lie in [2, W-3].  The key carries d in its low
// 9 bits, so it is a total order and the minimum does not depend on the
// visiting order.  The plane maps (d_lo, d_hi, d_plane, pvalid) come from
// the PyTorch prep; the kernel never evaluates the plane.  Plain version:
// ops/matching.py (match_keys).
//
// What bounds it: bytes.  At KITTI 1242x375, D = 256 it must read a frame's
// Ho descriptor rows of both images (2 x 7.5 MB), the (D, gh, gw) grid
// mask (0.3 MB) and four int32 maps (7.5 MB) and write the keys (1.9 MB);
// the work, about 17 candidates a pixel of one 16-byte SAD each, is far
// below the card's integer rate.  On an H100 a pass takes about 0.03 ms of
// device time (0.012 on the half lattice), ~4x its bytes bound: each block
// stages ~3 window columns for each of its pixels from L2 with byte loads,
// and waits on their latency.  Candidate counts vary by pixel, but a
// warp's 32 pixels keep 0.90 to 0.95 of its slots busy (one or two cells a
// warp, which share their bits), so one thread a pixel stays.
//
// Design: one block per (frame, R = 4 output rows, segment of S = 128
// output columns), one thread an output pixel.  The block reads the (16,
// H, W) descriptor planes and the bool grid mask as the engine holds them:
//   - it packs each row's B window, the columns [u_first - d_top, u_last]
//     (left pass) or [u_first, u_last + d_top] (right) clipped to [2, W-3],
//     d_top = min(D - 1, W - 3), into shared memory as one 16-byte
//     descriptor a column, gathered with byte loads in which neighbouring
//     threads read neighbouring bytes of a plane row (rows of a 1242-wide
//     plane are not 16-byte aligned, so no vector load along W).  On the
//     half lattice the window is stored even offsets first, then odd ones,
//     so that the threads of a warp, whose warps u -/+ d share a parity,
//     read neighbouring 16-byte slots without bank conflicts;
//   - it packs, once for its R rows, the D/32 candidate words of every cell
//     its pixels fall in (one or two cell rows of at most 8 cells at full
//     resolution, 14 on the half lattice), a thread a (cell, word),
//     neighbouring threads on neighbouring cells, so each of its 32 loads
//     reads bytes next to its neighbours'.  The mask was the largest share
//     of what a one-row block read from L2 (its cells' 256 d-rows, for 128
//     pixels), and 20 output rows share a cell row;
//   - each thread keeps its own A descriptor (its column of row clip(v, 2,
//     H-3), 16 byte loads) and maps in registers, then walks its candidates
//     against shared memory: the set bits of its cell's words by __ffs,
//     then the window; each SAD16 is four VABSDIFF4 with accumulate.
// It replaced a first design (one thread a pixel, 16-byte loads of B from
// global memory at data-dependent columns) for its wrapper's layout step:
// the descriptors were gathered and transposed to (rows, columns, 16) and
// the mask packed into words by torch ops before every launch (its wrapper
// took 0.72-0.86 ms a pass on an H100 against a 0.13 ms launch, both timed
// one call between two events).  A batch is a third grid axis
// (blockIdx.z = frame) over per-frame strides of every array but the prior
// table, which all frames share.
//
// The ceiling: the R windows take 16 R (s (S - 1) + 1 + d_top) bytes of
// shared memory and the words 4 ceil(D/32) (s (S - 1) / gs + 2) (s (R - 1)
// / gs + 2), 25 KB at D = 256 (33 KB on the half lattice).  Past 48 KB (a
// disp_max near 600) the kernel needs the device's opt-in maximum, which
// it is given once per device; svtt_match_max_span reports the largest
// d_top that fits, and matching_cu.launch raises past it.
//
// Row stripes (the sharded mode of matching_pl.py:242-293: output-row
// stripes over the mesh's 'tile' axis, no halo): a launch may cover the
// output rows [y0, y0 + Ho) of a frame of H true rows only, reading a slab
// of the planes whose row 0 is frame row row0 (it holds rows clip(s y, 2,
// H - 3) of its outputs), a slab of the mask whose row 0 is cell row g0,
// and the maps' rows of the stripe.  Every input may be a view (frame,
// plane and row strides given), so a stripe on the frame's own device
// reads the frame in place.

#include "svtt_cuda.cuh"

namespace {

using svtt::column16;
using svtt::kBig;
using svtt::sad16_acc;

// The block's shape, S output columns by R rows.  Measured on an H100
// against other shapes: 128 x 4 was the fastest on the half lattice and
// within 5 % of the fastest (256 x 2) at full resolution, 3-15 % faster
// than 128 x 1 in every mode; 64 columns lost everywhere.  The R rows
// share their cells' candidate words.
constexpr int kSegment = 128;
constexpr int kRows = 4;

// Columns of a row's B window, and cells and cell rows of a block's
// candidate words, at most.
__host__ __device__ constexpr int window_cols(int step, int d_top) {
    return step * (kSegment - 1) + 1 + d_top;
}
__host__ __device__ constexpr int max_cells(int step, int gs) {
    return step * (kSegment - 1) / gs + 2;
}
__host__ __device__ constexpr int max_cell_rows(int step, int gs) {
    return step * (kRows - 1) / gs + 2;
}

size_t smem_bytes(int step, int d_top, int nwords, int gs) {
    return sizeof(uint4) * (size_t)kRows * window_cols(step, d_top) +
           sizeof(unsigned) * (size_t)nwords * max_cells(step, gs) *
               max_cell_rows(step, gs);
}

// Per frame b = blockIdx.z: desc_a (the pass's own image), desc_b (the
// other): 16 uint8 planes of W columns whose row 0 is frame row row0
// (frames dfs bytes apart, planes dps apart); mask: D uint8 (bool) planes
// of gw columns whose row 0 is cell row g0 (frames mfs bytes apart, planes
// mps apart); d_lo, d_hi, d_plane, pvalid: Ho rows of Wo int32 (frames
// pfs words apart); key: (Ho, Wo) int32, contiguous.  prior: (D,) int32,
// one table for every frame.  Block: kSegment x kRows threads, thread (t,
// ty) on output row y0 + R blockIdx.y + ty of a frame of H true rows,
// output column S blockIdx.x + t.  Dynamic shared memory: smem_bytes(kStep,
// d_top, ceil(D / 32), gs).
template <int kStep>
__global__ void __launch_bounds__(kSegment* kRows) match_keys_kernel(
    const uint8_t* __restrict__ desc_a, const uint8_t* __restrict__ desc_b,
    const uint8_t* __restrict__ mask, const int* __restrict__ d_lo,
    const int* __restrict__ d_hi, const int* __restrict__ d_plane,
    const int* __restrict__ pvalid, const int* __restrict__ prior,
    long long dfs, long long dps, int row0, long long mfs, long long mps,
    int g0, long long pfs, int H, int W, int y0, int Ho, int Wo, int D,
    int gs, int gw, int d_top, int off, int right, int* __restrict__ key) {
    constexpr int S = kSegment;
    extern __shared__ uint4 smem[];
    const int nwords = (D + 31) >> 5;
    const int t = threadIdx.x;
    const int yb = blockIdx.y * kRows;  // the block's first row (stripe)
    const int y = yb + threadIdx.y;
    uint4* Bw = smem + threadIdx.y * window_cols(kStep, d_top);
    unsigned* words =
        (unsigned*)(smem + kRows * window_cols(kStep, d_top));
    const size_t b = blockIdx.z;
    const int x0 = blockIdx.x * S;
    const int xe = min(x0 + S, Wo);
    const int uf = kStep * x0, ul = kStep * (xe - 1);  // full-res columns
    const int v = kStep * (y0 + y);     // the frame row of the output row
    const int r = min(max(v, 2), H - 3) - row0;  // both images match on

    // the B window; every accepted warp lies in it
    const int wlo = max(right ? uf : uf - d_top, 2);
    const int whi = min(right ? ul + d_top : ul, W - 3);
    const int nb = whi - wlo + 1;
    const int half = (nb + 1) >> 1;  // kStep 2: even offsets, then odd
    const uint8_t* rowb = desc_b + b * dfs + (size_t)r * W + wlo;
    if (y < Ho)
        for (int i = t; i < nb; i += S)
            Bw[kStep == 1 ? i : (i & 1) * half + (i >> 1)] =
                column16(rowb + i, dps);

    // the candidate words of the cells under the segment, in the cell rows
    // of the block's rows: bit j of word w of cell (cy0 + q, cx0 + c) is
    // mask[32 w + j, cy0 + q, cx0 + c]; neighbouring threads take
    // neighbouring cells
    const int cx0 = uf / gs;
    const int ncells = ul / gs - cx0 + 1;
    const int cy0 = kStep * (y0 + yb) / gs;
    const int ncy = kStep * (y0 + min(yb + kRows, Ho) - 1) / gs - cy0 + 1;
    const size_t mplane = mps;
    const uint8_t* m = mask + b * mfs + (size_t)(cy0 - g0) * gw + cx0;
    for (int k = threadIdx.y * S + t; k < ncy * ncells * nwords;
         k += S * kRows) {
        const int c = k % ncells, q = k / ncells % ncy;
        const int w = k / (ncells * ncy);
        const int n = min(32, D - 32 * w);
        const uint8_t* mp = m + (size_t)q * gw + c + (size_t)(32 * w) * mplane;
        unsigned bits = 0;
#pragma unroll 8
        for (int j = 0; j < n; ++j)
            bits |= (unsigned)(__ldg(mp + j * mplane) != 0) << j;
        words[(q * ncells + c) * nwords + w] = bits;
    }

    // the thread's own pixel: A and the maps, loaded while the block stages
    const int x = x0 + t;
    const int u = kStep * x;
    const size_t i = b * pfs + (size_t)y * Wo + x;
    uint4 a = make_uint4(0u, 0u, 0u, 0u);
    int lo = 0, hi = -1, dp = 0, pv = 0;
    if (x < Wo && y < Ho) {
        a = column16(desc_a + b * dfs + (size_t)r * W + u, dps);
        lo = d_lo[i];
        hi = d_hi[i];
        dp = d_plane[i];
        pv = pvalid[i];
    }
    __syncthreads();
    if (x >= Wo || y >= Ho) return;

    auto sad = [&](int uw) {
        const int o = uw - wlo;
        return (int)sad16_acc(
            a, Bw[kStep == 1 ? o : (o & 1) * half + (o >> 1)], 0u);
    };
    int best = kBig;
    // grid candidates outside the window: raw SAD, in_window = 0; no word
    // past the largest d whose warp stays in the row
    const unsigned* cw =
        words + ((v / gs - cy0) * ncells + u / gs - cx0) * nwords;
    const int d_max = right ? W - 3 - u : u - 2;
    const int w_end = d_max < 0 ? 0 : min(nwords, (d_max >> 5) + 1);
    for (int w = 0; w < w_end; ++w) {
        unsigned bits = cw[w];
        while (bits) {
            const int d = w * 32 + __ffs(bits) - 1;
            bits &= bits - 1;
            if (d >= lo && d <= hi) continue;
            const int uw = right ? u + d : u - d;
            if (uw < 2 || uw > W - 3) continue;
            best = min(best, (sad(uw) + off) * 2 * 512 + d);
        }
    }
    // the plane window: SAD + prior, in_window = 1
    const int wl = max(lo, 0), wh = min(hi, D - 1);
    for (int d = wl; d <= wh; ++d) {
        const int uw = right ? u + d : u - d;
        if (uw < 2 || uw > W - 3) continue;
        const int pr = pv ? __ldg(prior + min(abs(d - dp), D - 1)) : 0;
        best = min(best, ((sad(uw) + pr + off) * 2 + 1) * 512 + d);
    }
    key[(b * Ho + y) * Wo + x] = best;
}

// The device's opt-in maximum of dynamic shared memory a block, set on both
// kernels once per device; the negated CUDA error if that failed.
int smem_limit() {
    static std::once_flag once[svtt::kMaxDevices];
    static int limit[svtt::kMaxDevices];
    return svtt::smem_limit_once(once, limit, [](int v) {
        cudaError_t e = cudaFuncSetAttribute(
            match_keys_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            v);
        if (e != cudaSuccess) return e;
        return cudaFuncSetAttribute(
            match_keys_kernel<2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            v);
    });
}

}  // namespace

// The largest d_top = min(disp_max, W - 3) whose window and words (nwords
// = ceil(disp_num / 32) a cell) fit the current device's shared memory at
// lattice step `step` and cell size gs; a launch past it fails with
// cudaErrorInvalidValue.
extern "C" int svtt_match_max_span(int step, int gs, int nwords,
                                   int* d_top) {
    const int lim = smem_limit();
    if (lim < 0) return -lim;
    if (step != 1 && step != 2) return (int)cudaErrorInvalidValue;
    const long long rest =
        (long long)lim - (long long)sizeof(unsigned) * nwords *
                             max_cells(step, gs) * max_cell_rows(step, gs);
    *d_top = rest < 0 ? -1
                      : (int)(rest / ((long long)sizeof(uint4) * kRows)) -
                            window_cols(step, 0);
    return (int)cudaSuccess;
}

// `frames` frames, each the output rows [y0, y0 + Ho) of an Wo wide
// lattice of step `step` (1 or 2) over the descriptor planes of a frame of
// H true rows and W columns and a cell grid of gs x gs pixels, gw cells
// wide, D planes: the planes' slab starts at frame row row0 (frames dfs
// bytes apart, planes dps apart), the mask's at cell row g0 (frames mfs
// bytes apart, planes mps apart), the maps' frames lie pfs words apart and
// the keys are contiguous.  A whole (16, H, W) frame with a (D, gh, gw)
// mask: dfs 16 H W, dps H W, mfs D gh gw, mps gh gw, pfs Ho Wo, row0, g0
// and y0 0.
extern "C" int svtt_match_keys(const void* desc_a, const void* desc_b,
                               const void* mask, const void* d_lo,
                               const void* d_hi, const void* d_plane,
                               const void* pvalid, const void* prior,
                               int frames, long long dfs, long long dps,
                               int row0, long long mfs, long long mps, int g0,
                               long long pfs, int H, int W, int y0, int Ho,
                               int Wo, int step, int D, int gs, int gw,
                               int off, int right, void* key, void* stream) {
    if (step != 1 && step != 2) return (int)cudaErrorInvalidValue;
    const int span = D - 1 < W - 3 ? D - 1 : W - 3;
    const int d_top = span > 0 ? span : 0;
    const size_t smem = smem_bytes(step, d_top, (D + 31) / 32, gs);
    const int lim = smem_limit();
    if (lim < 0) return -lim;
    if (smem > (size_t)lim) return (int)cudaErrorInvalidValue;
    if (frames == 0 || Ho == 0 || Wo == 0) return (int)cudaSuccess;
    const dim3 grid((Wo + kSegment - 1) / kSegment, (Ho + kRows - 1) / kRows,
                    frames);
    const cudaStream_t s = (cudaStream_t)stream;
    auto kernel = step == 1 ? match_keys_kernel<1> : match_keys_kernel<2>;
    kernel<<<grid, dim3(kSegment, kRows), smem, s>>>(
        (const uint8_t*)desc_a, (const uint8_t*)desc_b, (const uint8_t*)mask,
        (const int*)d_lo, (const int*)d_hi, (const int*)d_plane,
        (const int*)pvalid, (const int*)prior, dfs, dps, row0, mfs, mps, g0,
        pfs, H, W, y0, Ho, Wo, D, gs, gw, d_top, off, right, (int*)key);
    return (int)cudaGetLastError();
}
