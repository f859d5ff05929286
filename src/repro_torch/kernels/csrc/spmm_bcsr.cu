// K10: the pre-fusion block-CSR SpMM, Y (n_brows*bm, d_pad) = A_blk · X.
//
// Replaces the TPU kernel src/repro/kernels/spmm_bcsr.py :: spmm_bcsr
// (_kernel), the pre-fusion MXU micro-oracle.  Every block-row holds
// kmax (bm x bk) blocks, padded with zero blocks at block-column 0; the
// reference's innermost grid axis walks them into a resident output
// tile.  Here one CTA per (block-row, 128-column tile) walks its kmax
// steps in order with K2's block trip (spmm_trips.cuh): block-row i is
// an MXU descriptor at value offset i*kmax*bm*bk and column offset
// i*kmax.  A zero padding block adds +0.0 to each row, so where the
// block order agrees, K10 equals K2 bit for bit.
//
// What bounds it on an H100 is bytes, as for K2: 2*bm flops per X value
// loaded, and neighbouring block-rows share X panels through L2.  The
// products and sums are fp32 with K2's roundings (__fmul_rn/__fadd_rn):
// no TF32 and no tensor cores, as the reference computes fp32 x fp32 ->
// fp32 and Hopper's tensor cores have no IEEE fp32 mode.
#include "spmm_trips.cuh"
#include "occupancy.cuh"

namespace {

template <int BM>
__global__ void __launch_bounds__(spmm::kColTile)
spmm_bcsr_kernel(const int* __restrict__ bcols,
                 const float* __restrict__ vals,
                 const float* __restrict__ x, float* __restrict__ y, int bk,
                 int kmax, int d_pad) {
    const int col = blockIdx.y * spmm::kColTile + threadIdx.x;
    if (col >= d_pad) return;
    const int i = blockIdx.x;
    float acc[BM];
    spmm::mxu_trips<BM>(acc, i * kmax * BM * bk, i * kmax, kmax, bk, bcols,
                        vals, x, col, d_pad);
    spmm::store_rows<BM>(y, i, acc, col, d_pad);
}

}  // namespace

// All pointers are device pointers, stream is a cudaStream_t.  Returns
// the launch's error code.
extern "C" int spmm_bcsr_launch(const void* bcols, const void* vals,
                                const void* x, void* y, int n_brows, int bm,
                                int bk, int kmax, int d_pad, void* stream) {
    const dim3 grid(n_brows, (d_pad + spmm::kColTile - 1) / spmm::kColTile);
    const dim3 block(spmm::kColTile);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(BM)                                                          \
    spmm_bcsr_kernel<BM><<<grid, block, 0, s>>>(                            \
        static_cast<const int*>(bcols), static_cast<const float*>(vals),    \
        static_cast<const float*>(x), static_cast<float*>(y), bk, kmax,     \
        d_pad)
    SPMM_DISPATCH_BM(bm, LAUNCH)
#undef LAUNCH
    return static_cast<int>(cudaGetLastError());
}

// CTAs of the bm instance that fit on one SM with `smem` bytes of
// dynamic shared memory, as the card reports it; -1 on a CUDA error.
extern "C" int spmm_bcsr_ctas_per_sm(int bm, int smem) {
#define QUERY(BM) \
    return occupancy::ctas_per_sm(spmm_bcsr_kernel<BM>, spmm::kColTile, smem)
    SPMM_DISPATCH_BM(bm, QUERY)
#undef QUERY
}
