// K10: the pre-fusion block-CSR SpMM, Y (n_brows*bm, d_pad) = A_blk · X.
//
// Replaces the TPU kernel src/repro/kernels/spmm_bcsr.py :: spmm_bcsr
// (_kernel), the pre-fusion MXU micro-oracle.  Every block-row holds
// kmax (bm x bk) blocks, padded with zero blocks at block-column 0; the
// reference's innermost grid axis walks them into a resident output
// tile.  Block-row i is one MXU descriptor at value offset i*kmax*bm*bk
// and column offset i*kmax, and K2's block step does the work, so a zero
// padding block adds +0.0 to each row and, where the block order agrees,
// K10 equals K2 bit for bit.
//
// What bounds it on an H100 is bytes, as for K2: 2*bm flops per X value
// loaded, and neighbouring block-rows share X panels through L2.  The
// wrapper picks one of two routes (kernels/spmm_bcsr.py::ring_route):
//
// - d_pad a multiple of 128 and the ring within a CTA's shared memory:
//   K2's warp-specialised CTA (spmm_gather_ring.cuh) with the BlockRows
//   source, the descriptor table computed from the block-row's index (no
//   table in memory).  Persistent CTAs walk block-rows; the producer warp
//   copies each stage's X panels (16 bytes a lane; max(1, 8 / bk) block
//   steps a stage) and its value panels, transposed, into a four-stage
//   ring ahead of four consumer warps, which run K2's MXU step on each.
// - Otherwise: one CTA per (block-row, 128-column tile) walks its kmax
//   steps with K2's block trip (spmm_trips.cuh), each X panel value
//   loaded once per thread from global memory; below 128 columns the
//   CTA is cut to whole warps of the width (`threads`).
//
// The products and sums are fp32 with K2's roundings (__fmul_rn/
// __fadd_rn): no TF32 and no tensor cores, as the reference computes
// fp32 x fp32 -> fp32 and Hopper's tensor cores have no IEEE fp32 mode.
#include "occupancy.cuh"
#include "spmm_gather_ring.cuh"

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

// All pointers are device pointers, stream is a cudaStream_t.  threads
// == 0 takes the gather ring (d_pad a multiple of 128, x on a 16-byte
// boundary); otherwise the one-CTA-a-block-row body in CTAs of `threads`
// threads (a multiple of 32 up to 128 that covers d_pad when below 128).
// Returns the launch's error code.
extern "C" int spmm_bcsr_launch(const void* bcols, const void* vals,
                                const void* x, void* y, int n_brows, int bm,
                                int bk, int kmax, int d_pad, int threads,
                                void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (threads == 0) {
        if (d_pad % spmm::kColTile) return cudaErrorInvalidValue;
        spmm_staged::Params p{};
        p.cols = static_cast<const int*>(bcols);
        p.vals = static_cast<const float*>(vals);
        p.x = static_cast<const float*>(x);
        p.y = static_cast<float*>(y);
        p.num_trips = n_brows;
        p.mw = 1;
        p.bk = bk;
        p.kc = kmax;
        p.d_pad = d_pad;
#define RING(BM)                                                         \
        return static_cast<int>(                                         \
            spmm_ring::launch<BM, true, spmm_ring::BlockRows>(p, s))
        SPMM_DISPATCH_BM(bm, RING)
#undef RING
    }
    if (threads < 0 || threads > spmm::kColTile || threads % 32
        || (threads < spmm::kColTile && d_pad > threads))
        return cudaErrorInvalidValue;
    const dim3 grid(n_brows, (d_pad + spmm::kColTile - 1) / spmm::kColTile);
#define LAUNCH(BM)                                                          \
    spmm_bcsr_kernel<BM><<<grid, threads, 0, s>>>(                          \
        static_cast<const int*>(bcols), static_cast<const float*>(vals),    \
        static_cast<const float*>(x), static_cast<float*>(y), bk, kmax,     \
        d_pad)
    SPMM_DISPATCH_BM(bm, LAUNCH)
#undef LAUNCH
    return static_cast<int>(cudaGetLastError());
}

// CTAs of the ring's bm instance that fit on one SM with `smem` bytes of
// dynamic shared memory (kernels/spmm_bcsr.py::ring_bytes), as the
// launch asks the card; -1 on a CUDA error.
extern "C" int spmm_bcsr_ctas_per_sm(int bm, int smem) {
#define QUERY(BM)                                                          \
    return occupancy::ctas_per_sm(                                         \
        spmm_ring::gather_kernel<BM, true, spmm_ring::BlockRows>,          \
        spmm_ring::kThreads, smem)
    SPMM_DISPATCH_BM(bm, QUERY)
#undef QUERY
}

// The same for the one-CTA-a-block-row body's bm instance in CTAs of
// `threads` threads, with no shared memory.
extern "C" int spmm_bcsr_narrow_ctas_per_sm(int bm, int threads) {
#define QUERY(BM) \
    return occupancy::ctas_per_sm(spmm_bcsr_kernel<BM>, threads, 0)
    SPMM_DISPATCH_BM(bm, QUERY)
#undef QUERY
}
