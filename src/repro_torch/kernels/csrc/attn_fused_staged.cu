// K6: the staged fused sparse-attention sandwich, bit-identical to K5.
//
// Replaces the TPU kernel src/repro/kernels/attn_fused.py ::
// attn_fused_staged (_staged_kernel, staging="dma").  There each merged
// trip's weight and column windows [off, off + span) / [coff, coff +
// cspan) are DMA'd from HBM into a two-slot ring while the previous trip
// computes, and Q, K and V stay resident; streaming K/V panels is the
// reference's own noted follow-up (attn_fused.py:33-39).
//
// This file holds K6's launch: the warp-specialised CTA of attn_ring.cuh
// with its Windows source, whose producer warp walks spmm_staged.cuh's
// items and fills a two-slot ring of weight/column windows with
// cp.async.bulk (a trip whose windows fit a slot is one item, a larger
// one is walked member by member in chunks that keep every row's order),
// and gathers every MXU step's K and V panels into a ring of stages
// ahead of four consumer warps.  What bounds it (operations, in practice
// the latency of a step), the design and the order of its roundings are
// in attn_ring.cuh.  The carry of a member lives across its chunks and
// its rows are stored after the last one, so the output equals K5's,
// which runs the same CTA with its resident source.
#include "attn_ring.cuh"
#include "occupancy.cuh"

namespace {

using namespace attn_ring;

template <int BM>
__global__ void __launch_bounds__(kThreads, kMinCtas)
attn_fused_staged_kernel(const Params p, const attn::Operands o, int* next_trip) {
    extern __shared__ __align__(128) unsigned char smem[];
    const Geo g = geometry(BM, o.bk, o.dh_pad);
    const int slot = p.cap + 4;
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
    Item* items = reinterpret_cast<Item*>(bar + kBarriers);
    float* vslot = reinterpret_cast<float*>(smem + 8 * kBarriers + kWinSlots * kItemBytes);
    int* cslot = reinterpret_cast<int*>(vslot + kWinSlots * slot);
    float* kv = reinterpret_cast<float*>(cslot + kWinSlots * slot);
    float* q_s = kv + static_cast<size_t>(g.stages) * g.stage;
    float* p_s = q_s + BM * g.qstride;
    float* r_s = p_s + 2 * BM * g.pw;
    float* l_s = r_s + 2 * BM * g.pw;
    const Ctx<BM, Windows> cx{{p}, o, g, bar, items, next_trip, vslot, cslot, kv,
                              q_s, p_s, r_s, l_s, slot};
    run_cta(cx);
}

}  // namespace

// num_trips = num_blocks / mw merged trips; all pointers are device
// pointers on 16-byte boundaries, stream is a cudaStream_t; dh_pad is a
// multiple of 32, dv_pad of 128; cap, ch and kc come from
// kernels/spmm_ell_fused.py::staging_geometry; next_trip is one int32
// per column tile, zero (the trip counters of the persistent CTAs).
// Returns the launch's error code.
extern "C" int attn_fused_staged_launch(
        const void* blk_tag, const void* blk_off, const void* blk_coff,
        const void* blk_L, const void* cols, const void* vals, const void* q,
        const void* k, const void* v, void* y, int num_trips, int bm, int bk,
        int mw, int dh_pad, int dv_pad, int cap, int ch, int kc, void* next_trip,
        void* stream) {
    Params p{};
    p.tag = static_cast<const int*>(blk_tag);
    p.off = static_cast<const int*>(blk_off);
    p.coff = static_cast<const int*>(blk_coff);
    p.L = static_cast<const int*>(blk_L);
    p.cols = static_cast<const int*>(cols);
    p.vals = static_cast<const float*>(vals);
    p.x = nullptr;       // the staged walk only; Q, K and V are in `o`
    p.y = nullptr;
    p.num_trips = num_trips;
    p.mw = mw;
    p.bk = bk;
    p.d_pad = dv_pad;
    p.cap = cap;
    p.ch = ch;
    p.kc = kc;
    const attn::Operands o{static_cast<const float*>(q), static_cast<const float*>(k),
                           static_cast<const float*>(v), static_cast<float*>(y), bk,
                           dh_pad, dv_pad};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(BM)                                                                   \
    return static_cast<int>(launch(attn_fused_staged_kernel<BM>,                     \
                                   attn_ring_bytes(cap, BM, bk, dh_pad), num_trips,  \
                                   dv_pad / attn::kColTile, s, p, o,                 \
                                   static_cast<int*>(next_trip)))
    ATTN_DISPATCH_BM(bm, LAUNCH)
#undef LAUNCH
}

// CTAs of the bm instance that fit on one SM with `smem` bytes of
// dynamic shared memory (kernels/attn_fused.py::ring_bytes), as the
// launch asks the card; -1 on a CUDA error.
extern "C" int attn_fused_staged_ctas_per_sm(int bm, int smem) {
#define QUERY(BM) \
    return occupancy::ctas_per_sm(attn_fused_staged_kernel<BM>, kThreads, smem)
    ATTN_DISPATCH_BM(bm, QUERY)
#undef QUERY
}
