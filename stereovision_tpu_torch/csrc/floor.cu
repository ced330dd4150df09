// Two kernels that measure the launch floor beside the port's kernels
// (chip_smoke.py): an empty one, whose launch costs what any launch from
// this library costs, and a one-thread spin that holds the stream for a
// given time, so that launches queued behind it run back to back on the
// card however slowly the host issues them.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

__global__ void spin_kernel(long long ns) {
    long long t0, t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
    do {
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    } while (t - t0 < ns);
}

}  // namespace

extern "C" int svtt_empty(void* stream) {
    empty_kernel<<<1, 1, 0, (cudaStream_t)stream>>>();
    return (int)cudaGetLastError();
}

extern "C" int svtt_spin(long long ns, void* stream) {
    spin_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(ns);
    return (int)cudaGetLastError();
}
