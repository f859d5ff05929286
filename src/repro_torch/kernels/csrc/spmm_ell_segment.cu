// K9: one ELL segment, Y_seg (R_pad, d_pad) = segment · X.
//
// Replaces the TPU kernel src/repro/kernels/spmm_csr.py ::
// spmm_ell_segment (_kernel), the single-segment micro-oracle: row r of
// the segment sums vals[r, l] * X[cols[r, l]] over its L padded slots.
// The reference bakes L into each compiled kernel; here it is a launch
// argument.
//
// What bounds it on an H100 is bytes, as for K1: on a uniform random
// graph every slot gathers a 512-byte X row segment that misses the 50
// MB L2.  The design is K2's warp-specialised CTA (spmm_gather_ring.cuh,
// MIXED = false, the Resident descriptor source): persistent CTAs of four
// consumer warps and one producer warp walk the segment's row blocks, the
// producer copying each step's bm gathered X row segments into a
// four-stage ring with 16-byte cp.async.ca, the consumers adding acc =
// __fadd_rn(acc, __fmul_rn(v, x)) in K1's order.  The descriptor table is
// the segment's implicit one, written out by the wrapper (block i at slot
// i*bm*L, L steps, coff == off: kernels/spmm_csr.py::segment_tables), so
// the ring's header and K2/K3/K4's instances stay as they are, and each
// row's sum, with its two roundings a step, is K1's bit for bit.  The
// ring takes whole 128-column tiles and X on a 16-byte boundary; the
// wrapper pads an unplanned width and aligns X (aligned16).
#include "occupancy.cuh"
#include "spmm_gather_ring.cuh"

// row_blocks = R_pad / bm; off and L are the segment's descriptor table
// (row_blocks entries each); all pointers are device pointers, stream is
// a cudaStream_t; d_pad is a multiple of 128 and x starts on a 16-byte
// boundary.  Returns the launch's error code.
extern "C" int spmm_ell_segment_launch(const void* off, const void* L,
                                       const void* cols, const void* vals,
                                       const void* x, void* y,
                                       int row_blocks, int bm, int d_pad,
                                       void* stream) {
    spmm_staged::Params p{};
    p.off = static_cast<const int*>(off);
    p.coff = static_cast<const int*>(off);
    p.L = static_cast<const int*>(L);
    p.cols = static_cast<const int*>(cols);
    p.vals = static_cast<const float*>(vals);
    p.x = static_cast<const float*>(x);
    p.y = static_cast<float*>(y);
    p.num_trips = row_blocks;
    p.mw = 1;
    p.bk = 0;           // no MXU steps: a stage is bm rows, no panel
    p.d_pad = d_pad;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(BM)                                                       \
    return static_cast<int>(                                             \
        spmm_ring::launch<BM, false, spmm_ring::Resident>(p, s))
    SPMM_DISPATCH_BM(bm, LAUNCH)
#undef LAUNCH
}

// CTAs of the bm instance that fit on one SM with `smem` bytes of
// dynamic shared memory (kernels/spmm_bcsr_fused.py::ring_bytes at bk =
// 0), as the launch asks the card; -1 on a CUDA error.
extern "C" int spmm_ell_segment_ctas_per_sm(int bm, int smem) {
#define QUERY(BM)                                                          \
    return occupancy::ctas_per_sm(                                         \
        spmm_ring::gather_kernel<BM, false, spmm_ring::Resident>,          \
        spmm_ring::kThreads, smem)
    SPMM_DISPATCH_BM(bm, QUERY)
#undef QUERY
}
