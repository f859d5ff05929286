// K5: the fused sparse-attention sandwich, Y_ws = softmax(mask ⊙ Q·Kᵀ)·V,
// in one launch over the descriptor stream (resident operands).
//
// Replaces the TPU kernel src/repro/kernels/attn_fused.py :: attn_fused
// (_kernel, _softmax_trip).  Per descriptor: VPU trips (tag 0) score one
// K row per block row per step and fold it into the running softmax;
// MXU trips (tag 1) score a (bm x bk) block against the K panel of
// block-column cols[coff + k], fold it with one rescale per block step,
// and add the (bm x bk)·(bk x 128) product with the V panel.  The output
// is acc / l, zero for a row whose weights are all zero.
//
// What bounds it on an H100: operations (2*dh flops of score and 2*dv of
// S·V per nonzero, fp32 outside the tensor cores), in practice the
// latency of a step.  K5 is K6's warp-specialised CTA (attn_ring.cuh)
// with the Resident descriptor source: persistent CTAs of four consumer
// warps and one producer warp take whole merged trips one at a time from
// a counter and walk them member by member, reading the descriptor
// tables and the weight and column streams where they lie in global
// memory (no window slot, no chunk); the producer gathers every MXU
// step's K and V panels and its weight panel into a ring of stages, the
// consumers score each group of steps in one to four lanes a pair and
// fold in the reference's order.  The ring is K6's at its stage count
// where it fits a CTA, with fewer stages where it does not, and with
// none (LEAN: Q, K and V read in place) at head widths where not even
// one stage fits, so every instance the first K5 (one warp a row)
// took runs here; resident_geometry chooses, and
// kernels/attn_fused.py::resident_geometry mirrors it.
//
// K5 and K6 run one CTA body, so on the card K5 is no longer an
// independent oracle for K6.  They are held to their plain versions
// (attn_fused_plain, attn_fused_staged_plain; chip_smoke.py's
// attention-kernel phase), to the parent tree's K5 bit for bit
// (chip_smoke.py --ab-parent), and on the CPU, through those plain
// versions, to the reference (tests/test_torch_attn.py).
#include "attn_ring.cuh"
#include "occupancy.cuh"

namespace {

using namespace attn_ring;

template <int BM, bool LEAN>
__global__ void __launch_bounds__(kThreads, kMinCtas)
attn_fused_kernel(const Params p, const attn::Operands o, const Geo g, int* next_trip) {
    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
    Item* items = reinterpret_cast<Item*>(bar + kBarriers);
    float* kv = reinterpret_cast<float*>(smem + 8 * kBarriers + kWinSlots * kItemBytes);
    float* q_s = kv + static_cast<size_t>(g.stages) * g.stage;
    float* p_s = q_s + (LEAN ? 0 : BM * g.qstride);
    float* r_s = p_s + 2 * BM * g.pw;
    float* l_s = r_s + 2 * BM * g.pw;
    const Ctx<BM, Resident<LEAN>> cx{{p}, o, g, bar, items, next_trip, nullptr, nullptr,
                                     kv, q_s, p_s, r_s, l_s, 0};
    run_cta(cx);
}

}  // namespace

// num_trips = num_blocks / mw merged trips; all pointers are device
// pointers, stream is a cudaStream_t; q, k and v start on 16-byte
// boundaries, dh_pad is a multiple of 32 (q and k zero-padded to it),
// dv_pad a multiple of 128; next_trip is one int32 per column tile,
// zero (the trip counters of the persistent CTAs).  Returns the launch's
// error code.
extern "C" int attn_fused_launch(
        const void* blk_tag, const void* blk_off, const void* blk_coff,
        const void* blk_L, const void* cols, const void* vals, const void* q,
        const void* k, const void* v, void* y, int num_trips, int bm, int bk,
        int mw, int dh_pad, int dv_pad, void* next_trip, void* stream) {
    Params p{};
    p.tag = static_cast<const int*>(blk_tag);
    p.off = static_cast<const int*>(blk_off);
    p.coff = static_cast<const int*>(blk_coff);
    p.L = static_cast<const int*>(blk_L);
    p.cols = static_cast<const int*>(cols);
    p.vals = static_cast<const float*>(vals);
    p.num_trips = num_trips;
    p.mw = mw;
    p.bk = bk;
    p.d_pad = dv_pad;
    const attn::Operands o{static_cast<const float*>(q), static_cast<const float*>(k),
                           static_cast<const float*>(v), static_cast<float*>(y), bk,
                           dh_pad, dv_pad};
    const Geo g = resident_geometry(bm, bk, dh_pad);
    const size_t smem = resident_bytes(g, bm);
    const int tiles = dv_pad / attn::kColTile;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    int* counter = static_cast<int*>(next_trip);
#define LAUNCH(BM)                                                                   \
    return static_cast<int>(                                                         \
        g.stages > 0                                                                 \
            ? launch(attn_fused_kernel<BM, false>, smem, num_trips, tiles, s, p, o,  \
                     g, counter)                                                     \
            : launch(attn_fused_kernel<BM, true>, smem, num_trips, tiles, s, p, o,   \
                     g, counter))
    ATTN_DISPATCH_BM(bm, LAUNCH)
#undef LAUNCH
}

// CTAs of the bm instance with a ring that fit on one SM with `smem`
// bytes of dynamic shared memory (kernels/attn_fused.py::
// resident_ring_bytes), as the launch asks the card; -1 on a CUDA error.
extern "C" int attn_fused_ctas_per_sm(int bm, int smem) {
#define QUERY(BM) \
    return occupancy::ctas_per_sm(attn_fused_kernel<BM, false>, kThreads, smem)
    ATTN_DISPATCH_BM(bm, QUERY)
#undef QUERY
}
