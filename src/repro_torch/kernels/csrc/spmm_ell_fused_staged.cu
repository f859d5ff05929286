// K3: the staged fused multi-segment ELL SpMM, Y_ws = plan · X, in one
// launch, bit-identical to K1.
//
// Replaces the TPU kernel src/repro/kernels/spmm_ell_fused.py ::
// spmm_ell_fused_staged (_staged_kernel, staging="dma").  There each
// trip's [off, off + span) slot and column windows are DMA'd from HBM
// into one of two VMEM/SMEM buffers while the previous trip computes.
// Here persistent CTAs walk the merged trips, and thread 0 fills a
// two-slot shared-memory ring with cp.async.bulk copies completing on an
// mbarrier per slot, the next trip's windows in flight while the current
// one computes (spmm_staged.cuh has the ring, the aligned copies and the
// chunked walk of a window larger than a slot).
//
// What bounds it on an H100 is bytes, as for K1: every slot gathers a
// whole X row, most of which miss the 50 MB L2.  The ring moves the
// descriptor's value and column reads off the gather's critical path:
// they arrive as one or two large copies per trip instead of 2*bm
// broadcast loads per step, so each step issues only its bm X-row loads.
// X stays in device memory, read with one coalesced load per row per
// CTA, as the reference keeps its X panel resident in this kernel.
#include "spmm_staged.cuh"

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
#define LAUNCH(BM) return static_cast<int>(spmm_staged::launch<BM, false>(p, s))
    SPMM_DISPATCH_BM(bm, LAUNCH)
#undef LAUNCH
}
