// The occupancy query every kernel library exports beside its launch,
// <name>_ctas_per_sm(bm, smem): how many CTAs of the bm instance the
// card fits on one SM with `smem` bytes of dynamic shared memory, as
// cudaOccupancyMaxActiveBlocksPerMultiprocessor reports it.
#pragma once

#include <cuda_runtime.h>

namespace occupancy {

// -1 on a CUDA error.  Above the default 48 KB the kernel's dynamic
// shared memory limit is raised to `smem` first, as its launch does.
template <typename Kernel>
int ctas_per_sm(Kernel kernel, int threads, int smem) {
    if (smem > 48 * 1024
        && cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem) != cudaSuccess)
        return -1;
    int n = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                      smem) != cudaSuccess)
        return -1;
    return n;
}

}  // namespace occupancy
