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
// KITTI size); in practice the dependent pointer chasing of the merge.
// Design: union-find label equivalence in four launches — init (every
// pixel its own root), merge (each pixel unites with its right and lower
// neighbour: atomicMin hangs the larger root under the smaller, retried
// until it lands on a root), resolve (each pixel finds its root, writes it
// back and counts itself into a per-root histogram with atomicAdd), apply
// (threshold by the root's count).  Kernel boundaries are the only global
// barriers it needs, where the TPU kernel iterated directional min-sweeps
// to a fixpoint (~40 rounds on KITTI frames).  Parent reads bypass L1
// (__ldcg), so a thread sees the roots other SMs have just written.  A
// batch of B frames is one (B H, W) label buffer whose labels index the
// whole buffer (3.7 M at B = 8, KITTI size); no merge crosses a frame's
// last row, so roots, and the per-root sizes, never cross frames.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int find_root(const int* L, int x) {
    int p = __ldcg(L + x);
    while (p != x) {
        x = p;
        p = __ldcg(L + x);
    }
    return x;
}

__device__ void unite(int* L, int a, int b) {
    while (true) {
        a = find_root(L, a);
        b = find_root(L, b);
        if (a == b) return;
        if (a > b) {
            const int t = a;
            a = b;
            b = t;
        }
        const int old = atomicMin(L + b, a);
        if (old == b) return;  // b was a root and now hangs under a
        b = old;               // b was re-parented meanwhile: unite a, old
    }
}

__device__ __forceinline__ bool connected(float d, float n, float thr) {
    return d >= 0.f && n >= 0.f && fabsf(d - n) <= thr;
}

__global__ void ccl_init(int n, int* __restrict__ L) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) L[i] = i;
}

// blockIdx.y = b H + v: row v of frame b.
__global__ void ccl_merge(const float* __restrict__ D, int H, int W,
                          float thr, int* L) {
    const int u = blockIdx.x * blockDim.x + threadIdx.x;
    const int v = blockIdx.y % H;
    if (u >= W) return;
    const int i = blockIdx.y * W + u;
    const float d = D[i];
    if (u + 1 < W && connected(d, D[i + 1], thr)) unite(L, i, i + 1);
    if (v + 1 < H && connected(d, D[i + W], thr)) unite(L, i, i + W);
}

__global__ void ccl_resolve(int n, int* L, int* __restrict__ size) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int r = find_root(L, i);
    L[i] = r;  // a shortcut to the same root: safe under concurrent finds
    atomicAdd(size + r, 1);
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
// size zeroed by the caller.
extern "C" int svtt_speckle(const void* D, int frames, int H, int W,
                            float thr, int speckle, void* labels, void* size,
                            void* out, void* stream) {
    const cudaStream_t s = (cudaStream_t)stream;
    const int n = frames * H * W;
    const int flat = (n + 255) / 256;
    int* L = (int*)labels;
    ccl_init<<<flat, 256, 0, s>>>(n, L);
    ccl_merge<<<dim3((W + 127) / 128, frames * H), 128, 0, s>>>(
        (const float*)D, H, W, thr, L);
    ccl_resolve<<<flat, 256, 0, s>>>(n, L, (int*)size);
    ccl_apply<<<flat, 256, 0, s>>>((const float*)D, L, (const int*)size, n,
                                   speckle, (float*)out);
    return (int)cudaGetLastError();
}
