// K2: the fused mixed VPU/MXU SpMM, Y_ws = plan · X, in one launch.
//
// Replaces the TPU kernel src/repro/kernels/spmm_bcsr_fused.py ::
// spmm_bcsr_fused (_kernel, resident staging).  Each descriptor is
// tagged: tag 0 runs K1's gather-FMA trips with the column entries at
// coff + r*L + nz; tag 1 runs L block steps, each a (bm x bk) value
// panel times the (bk x 128) X panel of block-column cols[coff + k].
//
// What bounds it on an H100 is bytes: on a uniform random graph every
// nonzero gathers a 512-byte X row segment that misses the 50 MB L2; on
// a block-structured matrix the X panels of neighbouring block-rows
// overlap, so L2 serves most re-reads and the floor is X once, the value
// panels once and the output once over 3.35 TB/s.  The design is K4's
// warp-specialised CTA (spmm_gather_ring.cuh) with the Resident
// descriptor source: persistent CTAs of four consumer warps and one
// producer warp walk the merged trips g, g + gridDim.x, ...; the producer
// reads each step's column indices from global memory and copies the
// step's X rows (bm gathered row segments, or the bk rows of an MXU
// panel) into a four-stage X ring with 16-byte cp.async.ca per lane, and
// an MXU step's bm x bk value panel after them (4-byte copies: a panel
// starts anywhere in the stream), running ahead across descriptor and
// trip boundaries; the consumers read the descriptor tables and a VPU
// step's values from global memory (loaded before they wait) and add
// acc = __fadd_rn(acc, __fmul_rn(v, x)) (an MXU step: t = a·xp over the
// panel's rows in order, then acc += t), so the output equals K4's and
// the plain version's bit for bit.  There is no slot ring and no
// chunked walk: the streams stay where they lie.  The block product is
// plain fp32 work, each product and sum rounded on its own (the
// reference computes fp32 x fp32 -> fp32, spmm_bcsr_fused.py:94-97, and
// Hopper's tensor cores have no IEEE fp32 mode).  The tag branch is
// per descriptor, uniform across the CTA.
#include "occupancy.cuh"
#include "spmm_gather_ring.cuh"

// num_trips = num_blocks / mw merged trips; all pointers are device
// pointers, stream is a cudaStream_t; d_pad is a multiple of 128 and x
// starts on a 16-byte boundary.  Returns the launch's error code.
extern "C" int spmm_bcsr_fused_launch(
        const void* blk_tag, const void* blk_off, const void* blk_coff,
        const void* blk_L, const void* cols, const void* vals,
        const void* x, void* y, int num_trips, int bm, int bk, int mw,
        int d_pad, void* stream) {
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
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(BM)                                                       \
    return static_cast<int>(                                             \
        spmm_ring::launch<BM, true, spmm_ring::Resident>(p, s))
    SPMM_DISPATCH_BM(bm, LAUNCH)
#undef LAUNCH
}

// CTAs of the bm instance that fit on one SM with `smem` bytes of
// dynamic shared memory (kernels/spmm_bcsr_fused.py::ring_bytes), as
// the launch asks the card; -1 on a CUDA error.
extern "C" int spmm_bcsr_fused_ctas_per_sm(int bm, int smem) {
#define QUERY(BM)                                                          \
    return occupancy::ctas_per_sm(                                         \
        spmm_ring::gather_kernel<BM, true, spmm_ring::Resident>,           \
        spmm_ring::kThreads, smem)
    SPMM_DISPATCH_BM(bm, QUERY)
#undef QUERY
}
