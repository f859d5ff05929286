// K1: the fused multi-segment ELL SpMM, Y_ws = plan · X, in one launch.
//
// Replaces the TPU kernel src/repro/kernels/spmm_ell_fused.py ::
// spmm_ell_fused (_kernel, resident staging).  What bounds it on an
// H100 is bytes: every slot gathers a whole X row (d_pad floats) that,
// for a graph with a large X, mostly misses the 50 MB L2, so the time is
// about S * d_pad * 4 bytes over the 3.35 TB/s of HBM.  The design
// answers with the cheapest form of that traffic: one thread per output
// column makes each gathered row one coalesced 512-byte read per CTA,
// the bm rows of a descriptor issue their loads back to back (bm
// independent chains in flight per thread), and the accumulators never
// leave registers, so the output is written once.  Staging the slot
// stream through shared memory (GE-SpMM's row caching) and the
// double-buffered K3 variant are later work.
#include "spmm_trips.cuh"

namespace {

template <int BM>
__global__ void __launch_bounds__(spmm::kColTile)
spmm_ell_fused_kernel(const int* __restrict__ blk_off,
                      const int* __restrict__ blk_L,
                      const int* __restrict__ cols,
                      const float* __restrict__ vals,
                      const float* __restrict__ x, float* __restrict__ y,
                      int mw, int d_pad) {
    const int col = blockIdx.y * spmm::kColTile + threadIdx.x;
    if (col >= d_pad) return;
    for (int w = 0; w < mw; ++w) {
        const long long b = static_cast<long long>(blockIdx.x) * mw + w;
        const int off = __ldg(blk_off + b);
        float acc[BM];
        // the ELL column stream is slot-parallel: coff == off
        spmm::vpu_trips<BM>(acc, off, off, __ldg(blk_L + b), cols, vals, x,
                            col, d_pad);
        spmm::store_rows<BM>(y, b, acc, col, d_pad);
    }
}

}  // namespace

// num_trips = num_blocks / mw merged trips; all pointers are device
// pointers, stream is a cudaStream_t.  Returns the launch's error code.
extern "C" int spmm_ell_fused_launch(
        const void* blk_off, const void* blk_L, const void* cols,
        const void* vals, const void* x, void* y, int num_trips, int bm,
        int mw, int d_pad, void* stream) {
    const dim3 grid(num_trips, (d_pad + spmm::kColTile - 1) / spmm::kColTile);
    const dim3 block(spmm::kColTile);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(BM)                                                          \
    spmm_ell_fused_kernel<BM><<<grid, block, 0, s>>>(                       \
        static_cast<const int*>(blk_off), static_cast<const int*>(blk_L),   \
        static_cast<const int*>(cols), static_cast<const float*>(vals),     \
        static_cast<const float*>(x), static_cast<float*>(y), mw, d_pad)
    SPMM_DISPATCH_BM(bm, LAUNCH)
#undef LAUNCH
    return static_cast<int>(cudaGetLastError());
}
