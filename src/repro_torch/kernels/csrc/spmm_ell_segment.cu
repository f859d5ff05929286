// K9: one ELL segment, Y_seg (R_pad, d_pad) = segment · X.
//
// Replaces the TPU kernel src/repro/kernels/spmm_csr.py ::
// spmm_ell_segment (_kernel), the single-segment micro-oracle: row r of
// the segment sums vals[r, l] * X[cols[r, l]] over its L padded slots.
// The reference bakes L into each compiled kernel; here it is a launch
// argument.  One CTA per (bm-row block, 128-column tile), one output
// column per thread, the bm accumulators in registers: K1's VPU trip
// (spmm_trips.cuh) over a descriptor table that is implicit — block i
// starts at slot i*bm*L, and its rows' slots are slot-parallel in the
// two streams.  So the sums, with their two roundings per step, are
// K1's, and what bounds it is K1's: bytes, one gathered X row per slot.
#include "spmm_trips.cuh"
#include "occupancy.cuh"

namespace {

template <int BM>
__global__ void __launch_bounds__(spmm::kColTile)
spmm_ell_segment_kernel(const int* __restrict__ cols,
                        const float* __restrict__ vals,
                        const float* __restrict__ x, float* __restrict__ y,
                        int L, int d_pad) {
    const int col = blockIdx.y * spmm::kColTile + threadIdx.x;
    if (col >= d_pad) return;
    const int off = blockIdx.x * BM * L;
    float acc[BM];
    spmm::vpu_trips<BM>(acc, off, off, L, cols, vals, x, col, d_pad);
    spmm::store_rows<BM>(y, blockIdx.x, acc, col, d_pad);
}

}  // namespace

// row_blocks = R_pad / bm; all pointers are device pointers, stream is a
// cudaStream_t.  Returns the launch's error code.
extern "C" int spmm_ell_segment_launch(const void* cols, const void* vals,
                                       const void* x, void* y,
                                       int row_blocks, int bm, int L,
                                       int d_pad, void* stream) {
    const dim3 grid(row_blocks, (d_pad + spmm::kColTile - 1) / spmm::kColTile);
    const dim3 block(spmm::kColTile);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(BM)                                                          \
    spmm_ell_segment_kernel<BM><<<grid, block, 0, s>>>(                     \
        static_cast<const int*>(cols), static_cast<const float*>(vals),     \
        static_cast<const float*>(x), static_cast<float*>(y), L, d_pad)
    SPMM_DISPATCH_BM(bm, LAUNCH)
#undef LAUNCH
    return static_cast<int>(cudaGetLastError());
}

// CTAs of the bm instance that fit on one SM with `smem` bytes of
// dynamic shared memory, as the card reports it; -1 on a CUDA error.
extern "C" int spmm_ell_segment_ctas_per_sm(int bm, int smem) {
#define QUERY(BM) \
    return occupancy::ctas_per_sm(spmm_ell_segment_kernel<BM>, spmm::kColTile, smem)
    SPMM_DISPATCH_BM(bm, QUERY)
#undef QUERY
}
