// K7: the SDDMM, out[p] = sum_d dY[rows[p], d] * X[cols[p], d].
//
// Replaces the TPU kernel src/repro/kernels/sddmm.py :: sddmm (_kernel):
// the structure-restricted gradient of SpMM with respect to the nonzero
// values.  The sum over d runs in lane tiles of dt = the widest halving
// of 512 that divides d_pad; each tile's sum is formed, then added to
// the pair's total in tile order, as the reference's fori_loop does.
//
// What bounds it on an H100 is bytes.  Each pair does 2*d_pad flops on
// 8*d_pad gathered bytes, far below the fp32 rate's balance, and for a
// large X the X row of most pairs misses the 50 MB L2, so the honest
// floor is about one X row per pair over 3.35 TB/s (every operand once
// is the lower bound printed beside it).  The design gives each pair one
// warp: the lanes stride the row with 4-byte loads (each step one
// coalesced 128-byte read, four per row at d_pad = 128), each lane sums
// its products with FMAs, and a __shfl_xor_sync butterfly adds the 32
// partial sums, as K5's score reduction does.  A body with 16-byte
// loads ran slower on an H100 (56 registers against 40) and was
// dropped; this one serves every width.  Pairs stay in CSR order, so
// the warps of one CTA mostly share a dY row, which the cache serves
// after the first read.
#include <cuda_runtime.h>

#include "occupancy.cuh"

namespace {

constexpr int kWarps = 8;    // pairs per CTA, one warp each

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
    return v;
}

__global__ void __launch_bounds__(kWarps * 32)
sddmm_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
             const float* __restrict__ dy, const float* __restrict__ x,
             float* __restrict__ out, long long nnz_pad, int d_pad, int dt) {
    const long long p = static_cast<long long>(blockIdx.x) * kWarps
                        + threadIdx.x / 32;
    if (p >= nnz_pad) return;    // uniform across the warp
    const int lane = threadIdx.x % 32;
    const float* a = dy + static_cast<long long>(__ldg(rows + p)) * d_pad;
    const float* b = x + static_cast<long long>(__ldg(cols + p)) * d_pad;
    float acc = 0.f;
    for (int t0 = 0; t0 < d_pad; t0 += dt) {
        float part = 0.f;
        for (int j = lane; j < dt; j += 32)
            part = fmaf(__ldg(a + t0 + j), __ldg(b + t0 + j), part);
        acc += warp_sum(part);
    }
    if (lane == 0) out[p] = acc;
}

}  // namespace

// All pointers are device pointers, stream is a cudaStream_t.  Returns
// the launch's error code.
extern "C" int sddmm_launch(const void* rows, const void* cols,
                            const void* dy, const void* x, void* out,
                            long long nnz_pad, int d_pad, int dt,
                            void* stream) {
    const dim3 grid(static_cast<unsigned>((nnz_pad + kWarps - 1) / kWarps));
    const dim3 block(kWarps * 32);
    sddmm_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(rows), static_cast<const int*>(cols),
        static_cast<const float*>(dy), static_cast<const float*>(x),
        static_cast<float*>(out), nnz_pad, d_pad, dt);
    return static_cast<int>(cudaGetLastError());
}

// CTAs that fit on one SM, as the card reports it (one instance: bm and
// smem are there for the common signature; the kernel takes no dynamic
// shared memory); -1 on a CUDA error.
extern "C" int sddmm_ctas_per_sm(int bm, int smem) {
    (void)bm;
    (void)smem;
    return occupancy::ctas_per_sm(sddmm_kernel, kWarps * 32, 0);
}
