// K3: the staged fused multi-segment ELL SpMM, Y_ws = plan · X, in one
// launch, bit-identical to K1.
//
// Replaces the TPU kernel src/repro/kernels/spmm_ell_fused.py ::
// spmm_ell_fused_staged (_staged_kernel, staging="dma").  There each
// trip's [off, off + span) slot and column windows are DMA'd from HBM
// into one of two VMEM/SMEM buffers while the previous trip computes.
// Here persistent warp-specialised CTAs walk the merged trips: a
// producer warp fills a three-slot shared-memory ring of windows with
// cp.async.bulk copies and gathers every step's bm X-row segments into
// a four-stage X ring, each slot and stage handed over on its own
// full/empty mbarrier pair, while four consumer warps add the steps in
// K1's order (spmm_gather_ring.cuh has the rings and the roles;
// spmm_staged.cuh the aligned window copies and the chunked walk of a
// window larger than a slot).
//
// What bounds it on an H100 is bytes, as for K1: every nonzero gathers a
// 512-byte X row segment, most of which miss the 50 MB L2.  The X ring
// keeps three steps of gathers in flight per CTA whatever the consumers
// are doing, where K1 has one step's loads per thread in flight and
// relies on a full grid of independent CTAs.
#include "occupancy.cuh"
#include "spmm_gather_ring.cuh"

// num_trips = num_blocks / mw merged trips; all pointers are device
// pointers, stream is a cudaStream_t; cap and ch come from
// kernels/spmm_ell_fused.py::staging_geometry.  Returns the launch's
// error code.
extern "C" int spmm_ell_fused_staged_launch(
        const void* blk_off, const void* blk_L, const void* cols,
        const void* vals, const void* x, void* y, int num_trips, int bm,
        int mw, int d_pad, int cap, int ch, void* stream) {
    spmm_staged::Params p{};
    p.tag = nullptr;
    p.off = static_cast<const int*>(blk_off);
    p.coff = p.off;      // the ELL column stream is slot-parallel
    p.L = static_cast<const int*>(blk_L);
    p.cols = static_cast<const int*>(cols);
    p.vals = static_cast<const float*>(vals);
    p.x = static_cast<const float*>(x);
    p.y = static_cast<float*>(y);
    p.num_trips = num_trips;
    p.mw = mw;
    p.bk = 1;
    p.d_pad = d_pad;
    p.cap = cap;
    p.ch = ch;
    p.kc = 1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(BM) return static_cast<int>(spmm_ring::launch<BM, false>(p, s))
    SPMM_DISPATCH_BM(bm, LAUNCH)
#undef LAUNCH
}

// CTAs of the bm instance that fit on one SM with `smem` bytes of
// dynamic shared memory (kernels/spmm_ell_fused.py::ring_bytes), as the
// launch asks the card; -1 on a CUDA error.
extern "C" int spmm_ell_fused_staged_ctas_per_sm(int bm, int smem) {
#define QUERY(BM)                                                         \
    return occupancy::ctas_per_sm(spmm_ring::gather_kernel<BM, false>,  \
                                  spmm_ring::kThreads, smem)
    SPMM_DISPATCH_BM(bm, QUERY)
#undef QUERY
}
