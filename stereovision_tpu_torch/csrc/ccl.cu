// K3: speckle removal by connected-component labelling, one frame or a
// batch of frames a launch sequence.
//
// Replaces the Pallas kernel stereovision_tpu/ops/pallas/ccl_pl.py:82
// (_kernel with _segmented_min_sweep :51, its batched mode :84, :121
// through the _fixpoint custom_vmap rule :192-215; host loops _fixpoint
// :174, _converge :237, _banded_labels :260, _merge_bands :342,
// remove_small_segments :384).  It computes the same partition: valid
// pixels (D >= 0) joined to their 4-neighbours when |D - D_nb| <= thr in
// float32 (ccl_pl.py:435-448); every pixel of a component smaller than
// `speckle` pixels, and every invalid pixel (a singleton), becomes -10.
// Labels differ from the TPU kernel's (here: a union-find root, there: the
// component's minimum index), but only the partition reaches the output,
// which is therefore identical.  Plain version: ops/postprocess.py
// (remove_small_segments).
//
// What bounds it: bytes in the ideal (one f32 map in, one out: 3.7 MB at
// KITTI size); in practice the latency of dependent label reads while
// components are merged.  Design: block-local union-find with path
// compression (the scheme of Playne and Hawick's and of Allegretti et
// al.'s GPU labelling), four launches:
//   local   one block per 32 x 16 tile, one thread a pixel: the pixel
//           unites with its right and lower neighbour inside the tile on a
//           label array in shared memory (atomicMin hangs the larger root
//           under the smaller; find halves the path as it walks), then
//           writes the global index of its tile-local root; each root
//           zeroes its own size slot;
//   border  one thread for each neighbour pair that crosses a tile border
//           (the right column and bottom row of every tile) unites the two
//           in global memory, halving paths as it walks;
//   count   each pixel walks to its root, writes it into its own entry,
//           and counts itself with a warp-aggregated add: the lanes of a
//           warp that share a root add once (__match_any_sync), so the
//           large components' same-address atomics fall about 32-fold;
//   apply   threshold by the root's count.
// It replaced the design of the first port, a global union-find over
// every pixel without path compression plus a memset and an init launch:
// on the slanted ground of a street scene, one component of most of the
// frame, its chains grew long and every pixel counted into one address
// (1.59 ms a frame against a bound of 1 us, on an H100).  Now all chains
// inside a tile resolve in shared memory and only ~1/16 + 1/32 of the
// pixel pairs touch global labels.  A batch of B frames is one (B H, W)
// label buffer whose labels index the whole buffer (3.7 M at B = 8, KITTI
// size); tiles never span two frames and the border pass stops at each
// frame's last row, so roots, and the per-root sizes, never cross frames.
// Label reads in global memory bypass L1 (__ldcg), so a thread sees the
// roots that other SMs have just written.
//
// Banded (the sharded mode of ccl_pl.py:260-381 and :423-475, under a
// mesh with more than one 'tile' shard): each shard labels its own row
// stripe (svtt_speckle_stripe: local and border on the stripe, whose
// frames may be a view, then its labels moved to the frame's global
// linear indices, as _banded_labels adds band * Hb * Wp, so that every
// parent stays a smaller index than its child and no root points across
// a stripe); the stripes' label buffers, laid side by side, form the
// frame's forest, which svtt_speckle_merge completes on one device: the
// border pass restricted to the pixel pairs across stripe edges (the
// counterpart of _merge_bands), then count (sizes zeroed first: roots may
// lie in any stripe) and apply over the whole frame.  The partition is
// the whole-frame launch's.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 16;

__device__ __forceinline__ bool connected(float d, float n, float thr) {
    return d >= 0.f && n >= 0.f && fabsf(d - n) <= thr;
}

// Every parent is a smaller index than its child (links go larger ->
// smaller), and a halving store writes a grandparent, an ancestor in the
// same set: concurrent finds and unites keep every set whole.

__device__ __forceinline__ int find_shared(volatile int* S, int x) {
    while (true) {
        const int p = S[x];
        if (p == x) return x;
        const int gp = S[p];
        if (gp == p) return p;
        S[x] = gp;  // path halving
        x = gp;
    }
}

__device__ void unite_shared(int* S, int a, int b) {
    while (true) {
        a = find_shared(S, a);
        b = find_shared(S, b);
        if (a == b) return;
        if (a > b) {
            const int t = a;
            a = b;
            b = t;
        }
        const int old = atomicMin(S + b, a);
        if (old == b) return;  // b was a root and now hangs under a
        b = old;               // b was re-parented meanwhile: unite a, old
    }
}

__device__ __forceinline__ int find_global(int* L, int x) {
    while (true) {
        const int p = __ldcg(L + x);
        if (p == x) return x;
        const int gp = __ldcg(L + p);
        if (gp == p) return p;
        __stcg(L + x, gp);  // path halving
        x = gp;
    }
}

__device__ void unite_global(int* L, int a, int b) {
    while (true) {
        a = find_global(L, a);
        b = find_global(L, b);
        if (a == b) return;
        if (a > b) {
            const int t = a;
            a = b;
            b = t;
        }
        const int old = atomicMin(L + b, a);
        if (old == b) return;
        b = old;
    }
}

// Block (32, 16) on tile (blockIdx.x, blockIdx.y) of frame blockIdx.z;
// D's frames lie fstride floats apart, L's H W; size may be null (not
// zeroed).
__global__ void ccl_local(const float* __restrict__ D, int H, int W,
                          long long fstride, float thr, int* __restrict__ L,
                          int* __restrict__ size) {
    __shared__ int S[kTileH * kTileW];
    __shared__ float Ds[kTileH * kTileW];
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int t = ty * kTileW + tx;
    const int u0 = blockIdx.x * kTileW, v0 = blockIdx.y * kTileH;
    const int u = u0 + tx, v = v0 + ty;
    const bool in = u < W && v < H;
    const size_t row0 = (size_t)blockIdx.z * H + v0;  // tile's first row
    const size_t i = (row0 + ty) * W + u;
    const float d =
        in ? D[blockIdx.z * fstride + (size_t)(v0 + ty) * W + u] : -1.f;
    S[t] = t;
    Ds[t] = d;
    __syncthreads();
    if (in) {
        if (tx + 1 < kTileW && u + 1 < W && connected(d, Ds[t + 1], thr))
            unite_shared(S, t, t + 1);
        if (ty + 1 < kTileH && v + 1 < H &&
            connected(d, Ds[t + kTileW], thr))
            unite_shared(S, t, t + kTileW);
    }
    __syncthreads();
    if (!in) return;
    const int r = find_shared(S, t);
    L[i] = (int)((row0 + r / kTileW) * W + u0 + r % kTileW);
    if (r == t && size) size[i] = 0;
}

// One thread an edge across a tile border, per frame: first the bottom
// rows of all tile rows but the frame's last (W edges each), then the
// right columns of all tile columns but the last (H edges each).  D's
// frames lie fstride floats apart, L's H W.
__global__ void ccl_border(const float* __restrict__ D, int frames, int H,
                           int W, long long fstride, float thr, int* L) {
    const int tiles_y = (H + kTileH - 1) / kTileH;
    const int tiles_x = (W + kTileW - 1) / kTileW;
    const long long horiz = (long long)(tiles_y - 1) * W;
    const long long per_frame = horiz + (long long)H * (tiles_x - 1);
    const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= per_frame * frames) return;
    const long long b = k / per_frame, e = k % per_frame;
    int v, u, step;
    if (e < horiz) {
        v = (int)(e / W + 1) * kTileH - 1;
        u = (int)(e % W);
        step = W;
    } else {
        const long long c = e - horiz;
        v = (int)(c / (tiles_x - 1));
        u = (int)(c % (tiles_x - 1) + 1) * kTileW - 1;
        step = 1;
    }
    const int i = (int)((b * H + v) * W + u);
    const size_t di = b * fstride + (size_t)v * W + u;
    if (connected(D[di], D[di + step], thr)) unite_global(L, i, i + step);
}

// A stripe's forest, labelled by the stripe's own linear indices, moved to
// the batch's: entry j = (b H + v) W + u of frame b of the stripe (H rows)
// becomes ((frame0 + b) Hf + row0 + v) W + u in a batch of frames of Hf
// rows, whose rows from row0 of frames from frame0 on the stripe holds.
// The map is increasing, so parents stay smaller than their children.
__global__ void ccl_globalize(int n, int H, int W, int Hf, int row0,
                              int frame0, int* L) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int j = L[i];
    const int per = H * W;
    L[i] = ((frame0 + j / per) * Hf + row0) * W + j % per;
}

// One thread a pixel pair across a stripe edge: for each frame, each edge
// row e = k * rows (0 < e < H) and column u, pixel (e - 1, u) with (e, u).
__global__ void ccl_merge(const float* __restrict__ D, int frames, int H,
                          int W, int rows, int edges, float thr, int* L) {
    const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (k >= (long long)frames * edges * W) return;
    const long long b = k / ((long long)edges * W);
    const int e = (int)(k / W % edges + 1) * rows;
    const int u = (int)(k % W);
    const int i = (int)((b * H + e - 1) * W + u);
    if (connected(D[i], D[i + W], thr)) unite_global(L, i, i + W);
}

// The forest is final here.  Each pixel compresses its own entry only: a
// halving store into another pixel's entry could land after that pixel
// wrote its root there, and leave it on a non-root ancestor.
__global__ void ccl_count(int n, int* L, int* size) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const unsigned active = __ballot_sync(0xffffffffu, i < n);
    if (i >= n) return;
    int r = i, p = __ldcg(L + i);
    while (p != r) {
        r = p;
        p = __ldcg(L + r);
    }
    L[i] = r;
    const unsigned same = __match_any_sync(active, r);
    if ((threadIdx.x & 31) == __ffs(same) - 1)
        atomicAdd(size + r, __popc(same));
}

__global__ void ccl_apply(const float* __restrict__ D,
                          const int* __restrict__ L,
                          const int* __restrict__ size, int n, int speckle,
                          float* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) out[i] = size[L[i]] < speckle ? -10.f : D[i];
}

}  // namespace

// D, out: `frames` H x W maps; labels, size: (frames*H*W,) int32 scratch,
// neither needs initialising.
extern "C" int svtt_speckle(const void* D, int frames, int H, int W,
                            float thr, int speckle, void* labels, void* size,
                            void* out, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const int n = frames * H * W;
    const int tiles_y = (H + kTileH - 1) / kTileH;
    const int tiles_x = (W + kTileW - 1) / kTileW;
    const long long edges = (long long)frames *
        ((long long)(tiles_y - 1) * W + (long long)H * (tiles_x - 1));
    int* L = (int*)labels;
    ccl_local<<<dim3(tiles_x, tiles_y, frames), dim3(kTileW, kTileH), 0,
                s>>>((const float*)D, H, W, (long long)H * W, thr, L,
                     (int*)size);
    if (edges > 0)
        ccl_border<<<(unsigned)((edges + 255) / 256), 256, 0, s>>>(
            (const float*)D, frames, H, W, (long long)H * W, thr, L);
    const int flat = (n + 255) / 256;
    ccl_count<<<flat, 256, 0, s>>>(n, L, (int*)size);
    ccl_apply<<<flat, 256, 0, s>>>((const float*)D, L, (const int*)size, n,
                                   speckle, (float*)out);
    return (int)cudaGetLastError();
}

// A row stripe of `frames` maps: rows [row0, row0 + H) of frames frame0,
// frame0 + 1, ... of a batch of frames of Hf rows, the stripe's frames
// fstride floats apart in D.  labels: (frames H W,) int32, the stripe's
// forest in the batch's global linear indices (see ccl_globalize); no
// sizes.
extern "C" int svtt_speckle_stripe(const void* D, int frames, int H, int W,
                                   long long fstride, float thr, int Hf,
                                   int row0, int frame0, void* labels,
                                   void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const int n = frames * H * W;
    if (n == 0) return (int)cudaSuccess;
    const int tiles_y = (H + kTileH - 1) / kTileH;
    const int tiles_x = (W + kTileW - 1) / kTileW;
    const long long edges = (long long)frames *
        ((long long)(tiles_y - 1) * W + (long long)H * (tiles_x - 1));
    int* L = (int*)labels;
    ccl_local<<<dim3(tiles_x, tiles_y, frames), dim3(kTileW, kTileH), 0,
                s>>>((const float*)D, H, W, fstride, thr, L, nullptr);
    if (edges > 0)
        ccl_border<<<(unsigned)((edges + 255) / 256), 256, 0, s>>>(
            (const float*)D, frames, H, W, fstride, thr, L);
    ccl_globalize<<<(n + 255) / 256, 256, 0, s>>>(n, H, W, Hf, row0, frame0,
                                                  L);
    return (int)cudaGetLastError();
}

// D, out: `frames` H x W maps (contiguous); labels: the forests of the
// stripes of `rows` rows each (the last may be shorter), laid side by side
// as (frames H W,) int32 global indices; size: (frames H W,) int32
// scratch.  Unites across the stripe edges, then counts and applies.
extern "C" int svtt_speckle_merge(const void* D, int frames, int H, int W,
                                  int rows, float thr, int speckle,
                                  void* labels, void* size, void* out,
                                  void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const int n = frames * H * W;
    if (n == 0) return (int)cudaSuccess;
    int* L = (int*)labels;
    const int edges = rows > 0 ? (H - 1) / rows : 0;
    const long long pairs = (long long)frames * edges * W;
    if (pairs > 0)
        ccl_merge<<<(unsigned)((pairs + 255) / 256), 256, 0, s>>>(
            (const float*)D, frames, H, W, rows, edges, thr, L);
    cudaError_t e = cudaMemsetAsync(size, 0, sizeof(int) * (size_t)n, s);
    if (e != cudaSuccess) return (int)e;
    const int flat = (n + 255) / 256;
    ccl_count<<<flat, 256, 0, s>>>(n, L, (int*)size);
    ccl_apply<<<flat, 256, 0, s>>>((const float*)D, L, (const int*)size, n,
                                   speckle, (float*)out);
    return (int)cudaGetLastError();
}
