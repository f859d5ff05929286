// K4: the staged fused mixed VPU/MXU SpMM, Y_ws = plan · X, in one
// launch, bit-identical to K2.
//
// Replaces the TPU kernel src/repro/kernels/spmm_bcsr_fused.py ::
// spmm_bcsr_fused_staged (_staged_kernel, staging="dma").  There all
// three streams leave VMEM: each trip's slot and column windows are
// double-buffered from HBM, and X is streamed per step — the bm gathered
// rows of a VPU step and the (bk, dt) panel of an MXU step, one step
// ahead.  Here persistent warp-specialised CTAs walk the merged trips: a
// producer warp fills a three-slot shared-memory ring of windows with
// cp.async.bulk copies and copies every step's X rows (bm gathered row
// segments, or the bk rows of an MXU panel) into a four-stage X ring,
// three steps ahead across descriptor and trip boundaries, each slot and
// stage handed over on its own full/empty mbarrier pair; four consumer
// warps compute (spmm_gather_ring.cuh has the rings and the roles,
// spmm_staged.cuh the aligned window copies and the chunked walk of a
// window larger than a slot).
//
// What bounds it on an H100 is bytes, as for K2.  The arithmetic is
// K2's (per MXU step t = a·xp summed over the panel's rows in order,
// then acc += t; per VPU step acc += v*x, each with __fmul_rn/__fadd_rn)
// in full fp32, so the output matches K2 bit for bit.  The tag branch is
// per descriptor, uniform across the CTA.
#include "occupancy.cuh"
#include "spmm_gather_ring.cuh"

// num_trips = num_blocks / mw merged trips; all pointers are device
// pointers, stream is a cudaStream_t; cap, ch and kc come from
// kernels/spmm_ell_fused.py::staging_geometry.  Returns the launch's
// error code.
extern "C" int spmm_bcsr_fused_staged_launch(
        const void* blk_tag, const void* blk_off, const void* blk_coff,
        const void* blk_L, const void* cols, const void* vals,
        const void* x, void* y, int num_trips, int bm, int bk, int mw,
        int d_pad, int cap, int ch, int kc, void* stream) {
    spmm_staged::Params p{};
    p.tag = static_cast<const int*>(blk_tag);
    p.off = static_cast<const int*>(blk_off);
    p.coff = static_cast<const int*>(blk_coff);
    p.L = static_cast<const int*>(blk_L);
    p.cols = static_cast<const int*>(cols);
    p.vals = static_cast<const float*>(vals);
    p.x = static_cast<const float*>(x);
    p.y = static_cast<float*>(y);
    p.num_trips = num_trips;
    p.mw = mw;
    p.bk = bk;
    p.d_pad = d_pad;
    p.cap = cap;
    p.ch = ch;
    p.kc = kc;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(BM) return static_cast<int>(spmm_ring::launch<BM, true>(p, s))
    SPMM_DISPATCH_BM(bm, LAUNCH)
#undef LAUNCH
}

// CTAs of the bm instance that fit on one SM with `smem` bytes of
// dynamic shared memory (kernels/spmm_ell_fused.py::ring_bytes), as the
// launch asks the card; -1 on a CUDA error.
extern "C" int spmm_bcsr_fused_staged_ctas_per_sm(int bm, int smem) {
#define QUERY(BM)                                                         \
    return occupancy::ctas_per_sm(spmm_ring::gather_kernel<BM, true>,  \
                                  spmm_ring::kThreads, smem)
    SPMM_DISPATCH_BM(bm, QUERY)
#undef QUERY
}
