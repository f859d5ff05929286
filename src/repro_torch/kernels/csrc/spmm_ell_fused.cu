// K1: the fused multi-segment ELL SpMM, Y_ws = plan · X, in one launch.
//
// Replaces the TPU kernel src/repro/kernels/spmm_ell_fused.py ::
// spmm_ell_fused (_kernel, resident staging).  What bounds it on an
// H100 is bytes: every slot gathers a whole X row (d_pad floats) that,
// for a graph with a large X, mostly misses the 50 MB L2, so the time is
// about S * d_pad * 4 bytes over the 3.35 TB/s of HBM.  The wrapper picks
// one of two routes by the width (kernels/spmm_ell_fused.py::ring_route):
//
// - Planned widths (d_pad a multiple of 128, all that compile_spmm
//   emits): the warp-specialised gather ring of K2/K3/K4/K9
//   (spmm_gather_ring.cuh) with K1's own descriptor source, EllStages.
//   Persistent CTAs of four consumer warps and one producer warp walk the
//   merged trips; the producer copies each stage's X row segments and
//   values (at least 8 rows, so bm = 1 keeps 8 gathers a stage in
//   flight) into a four-stage ring, its column entries loaded a stage
//   ahead, and the consumers add the steps from shared memory alone.
// - Every other width (direct calls): one thread per output column, so
//   a gathered row is one coalesced read per CTA, the bm rows of a
//   descriptor issuing their loads back to back.  Up to kNarrowThreads
//   columns one CTA of whole warps of the width takes a trip's every
//   column (the `threads` argument), so no warp of it idles and a trip's
//   slots are read once; wider, CTAs of 128 threads take a column tile
//   each.
//
// Both routes add acc = __fadd_rn(acc, __fmul_rn(v, x)) in slot order,
// so a row's sum is the same bit for bit on either route, in K3 and in
// the plain version.
#include "occupancy.cuh"
#include "spmm_gather_ring.cuh"

namespace {

// the widest CTA of the one-thread-a-column body
// (kernels/spmm_ell_fused.py::NARROW_MAX_THREADS)
constexpr int kNarrowThreads = 256;

template <int BM>
__global__ void __launch_bounds__(kNarrowThreads)
spmm_ell_fused_kernel(const int* __restrict__ blk_off,
                      const int* __restrict__ blk_L,
                      const int* __restrict__ cols,
                      const float* __restrict__ vals,
                      const float* __restrict__ x, float* __restrict__ y,
                      int mw, int d_pad) {
    const int col = blockIdx.y * blockDim.x + threadIdx.x;
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
// pointers, stream is a cudaStream_t.  threads == 0 takes the gather
// ring (d_pad a multiple of 128, x on a 16-byte boundary); otherwise the
// one-thread-a-column body in CTAs of `threads` threads (a multiple of
// 32 up to kNarrowThreads), each taking the next `threads` columns.
// Returns the launch's error code.
extern "C" int spmm_ell_fused_launch(
        const void* blk_off, const void* blk_L, const void* cols,
        const void* vals, const void* x, void* y, int num_trips, int bm,
        int mw, int d_pad, int threads, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (threads == 0) {
        if (d_pad % spmm::kColTile) return cudaErrorInvalidValue;
        spmm_staged::Params p{};
        p.off = static_cast<const int*>(blk_off);
        p.coff = p.off;
        p.L = static_cast<const int*>(blk_L);
        p.cols = static_cast<const int*>(cols);
        p.vals = static_cast<const float*>(vals);
        p.x = static_cast<const float*>(x);
        p.y = static_cast<float*>(y);
        p.num_trips = num_trips;
        p.mw = mw;
        p.d_pad = d_pad;
#define RING(BM)                                                         \
        p.bk = spmm_ring::ell_rows(BM);                                  \
        return static_cast<int>(                                         \
            spmm_ring::launch<BM, false, spmm_ring::EllStages>(p, s))
        SPMM_DISPATCH_BM(bm, RING)
#undef RING
    }
    if (threads < 0 || threads > kNarrowThreads || threads % 32)
        return cudaErrorInvalidValue;
    const dim3 grid(num_trips, (d_pad + threads - 1) / threads);
#define LAUNCH(BM)                                                          \
    spmm_ell_fused_kernel<BM><<<grid, threads, 0, s>>>(                     \
        static_cast<const int*>(blk_off), static_cast<const int*>(blk_L),   \
        static_cast<const int*>(cols), static_cast<const float*>(vals),     \
        static_cast<const float*>(x), static_cast<float*>(y), mw, d_pad)
    SPMM_DISPATCH_BM(bm, LAUNCH)
#undef LAUNCH
    return static_cast<int>(cudaGetLastError());
}

// CTAs of the ring's bm instance that fit on one SM with `smem` bytes of
// dynamic shared memory (kernels/spmm_ell_fused.py::resident_ring_bytes),
// as the launch asks the card; -1 on a CUDA error.
extern "C" int spmm_ell_fused_ctas_per_sm(int bm, int smem) {
#define QUERY(BM)                                                          \
    return occupancy::ctas_per_sm(                                         \
        spmm_ring::gather_kernel<BM, false, spmm_ring::EllStages>,         \
        spmm_ring::kThreads, smem)
    SPMM_DISPATCH_BM(bm, QUERY)
#undef QUERY
}

// The same for the one-thread-a-column body's bm instance in CTAs of
// `threads` threads, with no shared memory.
extern "C" int spmm_ell_fused_narrow_ctas_per_sm(int bm, int threads) {
#define QUERY(BM) \
    return occupancy::ctas_per_sm(spmm_ell_fused_kernel<BM>, threads, 0)
    SPMM_DISPATCH_BM(bm, QUERY)
#undef QUERY
}
