// K6: the staged fused sparse-attention sandwich, bit-identical to K5.
//
// Replaces the TPU kernel src/repro/kernels/attn_fused.py ::
// attn_fused_staged (_staged_kernel, staging="dma").  There each merged
// trip's weight and column windows [off, off + span) / [coff, coff +
// cspan) are DMA'd from HBM into a two-slot ring while the previous trip
// computes, and Q, K and V stay resident.  Here K3/K4's ring does the
// same (spmm_staged.cuh): persistent CTAs walk the merged trips, thread 0
// issues the next item's cp.async.bulk window copies onto one mbarrier
// per slot before the CTA waits for the current one, copies start at the
// 16-byte-aligned-down entry and the compute indexes with the remainder,
// and a trip whose window exceeds the slot is walked member by member in
// chunks (CH steps of every row of a VPU descriptor, KC block steps of an
// MXU one).  The (acc, m, l) carry of a member lives across its chunks
// and its rows are normalised and stored after the last one, so every
// row folds its nonzeros in K5's order and the output equals K5's.
//
// What bounds it on an H100 is operations, as for K5: the ring takes the
// weight and column reads off the steps' critical path; the Q block, K
// and V rows are read as in K5 (streaming K/V panels is the reference's
// own noted follow-up, attn_fused.py:33-39).
#include "attn_trips.cuh"
#include "spmm_staged.cuh"
#include "occupancy.cuh"

namespace {

using spmm_staged::Item;

// run item `it` from slot (vs, cs) on the CTA's carry
template <int BM>
__device__ __forceinline__ void compute(const spmm_staged::Staged<BM, true>& walk,
                                        const Item& it, const float* vs, const int* cs,
                                        attn::Cta<BM>& cta) {
    const spmm_staged::Params& p = walk.p;
    int vp[BM], cp[BM];
    if (it.w < 0) {
        const long long b0 = static_cast<long long>(it.g) * p.mw;
        const long long v0 = __ldg(p.off + b0);
        const long long c0 = __ldg(p.coff + b0);
        for (int w = 0; w < p.mw; ++w) {
            const long long b = b0 + w;
            const int L = __ldg(p.L + b);
            const int lv = spmm_staged::rem4(v0) + static_cast<int>(__ldg(p.off + b) - v0);
            const int lc = spmm_staged::rem4(c0) + static_cast<int>(__ldg(p.coff + b) - c0);
            cta.begin(b);
            if (walk.is_mxu(b)) {
                cta.mxu_steps(vs + lv, cs + lc, L);
            } else {
#pragma unroll
                for (int r = 0; r < BM; ++r) {
                    vp[r] = lv + r * L;
                    cp[r] = lc + r * L;
                }
                cta.vpu_steps(vs, cs, vp, cp, L);
            }
            cta.finish(b);
        }
        return;
    }
    const long long b = static_cast<long long>(it.g) * p.mw + it.w;
    const long long L = __ldg(p.L + b);
    const long long ob = __ldg(p.off + b);
    const long long cb = __ldg(p.coff + b);
    if (it.c == 0) cta.begin(b);
    if (walk.is_mxu(b)) {
        const long long k0 = static_cast<long long>(it.c) * p.kc;
        const int n = static_cast<int>(min(L, k0 + p.kc) - k0);
        cta.mxu_steps(vs + spmm_staged::rem4(ob + k0 * BM * p.bk),
                      cs + spmm_staged::rem4(cb + k0), n);
    } else {
        const long long n0 = static_cast<long long>(it.c) * p.ch;
        const int n = static_cast<int>(max(min(L, n0 + p.ch) - n0, 0LL));
#pragma unroll
        for (int r = 0; r < BM; ++r) {
            vp[r] = r * (p.ch + 4) + spmm_staged::rem4(ob + r * L + n0);
            cp[r] = r * (p.ch + 4) + spmm_staged::rem4(cb + r * L + n0);
        }
        cta.vpu_steps(vs, cs, vp, cp, n);
    }
    if (it.c + 1 == walk.member_chunks(b)) cta.finish(b);
}

template <int BM>
__global__ void __launch_bounds__(attn::kColTile)
attn_fused_staged_kernel(const spmm_staged::Params p, const attn::Operands o) {
    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
    const int slot = p.cap + 4;
    float* vslot = reinterpret_cast<float*>(smem + 16);
    int* cslot = reinterpret_cast<int*>(vslot + 2 * slot);
    float* scratch = reinterpret_cast<float*>(cslot + 2 * slot);
    const spmm_staged::Staged<BM, true> walk{p};
    attn::Cta<BM> cta(o, scratch);

    if (threadIdx.x == 0) {
        spmm_staged::mbar_init(&bar[0], 1);
        spmm_staged::mbar_init(&bar[1], 1);
        spmm_staged::mbar_fence_init();
    }
    __syncthreads();
    Item it = walk.trip_item(blockIdx.x);
    if (threadIdx.x == 0) walk.issue(it, vslot, cslot, &bar[0]);
    for (int i = 0; it.g >= 0; ++i) {
        const Item nxt = walk.next(it);
        const int s = i & 1, q = s ^ 1;
        // every thread is done with slot q (item i - 1) before it refills
        __syncthreads();
        if (threadIdx.x == 0 && nxt.g >= 0)
            walk.issue(nxt, vslot + q * slot, cslot + q * slot, &bar[q]);
        spmm_staged::mbar_wait(&bar[s], (i >> 1) & 1);
        compute<BM>(walk, it, vslot + s * slot, cslot + s * slot, cta);
        it = nxt;
    }
}

// dynamic shared memory of one CTA (kernels/attn_fused.py::ring_bytes
// computes the same): two mbarriers, the two-slot ring of weights and
// columns, then the attention scratch
size_t attn_ring_bytes(int cap, int bm, int bk, int dh_pad) {
    return 16u + 2u * 2u * (static_cast<size_t>(cap) + 4u) * 4u
           + static_cast<size_t>(attn::scratch_floats(bm, bk, dh_pad)) * 4u;
}

// persistent CTAs: as many per column tile as fit on the card at once,
// at most one per merged trip
template <int BM>
cudaError_t launch_staged(const spmm_staged::Params& p, const attn::Operands& o,
                          cudaStream_t stream) {
    const size_t smem = attn_ring_bytes(p.cap, BM, p.bk, o.dh_pad);
    auto kernel = attn_fused_staged_kernel<BM>;
    cudaError_t err = attn::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, attn::kColTile,
                                                        smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const int tiles = o.dv_pad / attn::kColTile;
    long long ctas = static_cast<long long>(sms) * per_sm / tiles;
    ctas = ctas < 1 ? 1 : (ctas > p.num_trips ? p.num_trips : ctas);
    kernel<<<dim3(static_cast<unsigned>(ctas), tiles), attn::kColTile, smem, stream>>>(p, o);
    return cudaGetLastError();
}

}  // namespace

// num_trips = num_blocks / mw merged trips; all pointers are device
// pointers, stream is a cudaStream_t; cap, ch and kc come from
// kernels/spmm_ell_fused.py::staging_geometry.  Returns the launch's
// error code.
extern "C" int attn_fused_staged_launch(
        const void* blk_tag, const void* blk_off, const void* blk_coff,
        const void* blk_L, const void* cols, const void* vals, const void* q,
        const void* k, const void* v, void* y, int num_trips, int bm, int bk,
        int mw, int dh_pad, int dv_pad, int cap, int ch, int kc, void* stream) {
    spmm_staged::Params p{};
    p.tag = static_cast<const int*>(blk_tag);
    p.off = static_cast<const int*>(blk_off);
    p.coff = static_cast<const int*>(blk_coff);
    p.L = static_cast<const int*>(blk_L);
    p.cols = static_cast<const int*>(cols);
    p.vals = static_cast<const float*>(vals);
    p.x = nullptr;       // the staged walk only; K/V are in `o`
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
#define LAUNCH(BM) return static_cast<int>(launch_staged<BM>(p, o, s))
    ATTN_DISPATCH_BM(bm, LAUNCH)
#undef LAUNCH
}

// CTAs of the bm instance that fit on one SM with `smem` bytes of
// dynamic shared memory, as the card reports it; -1 on a CUDA error.
extern "C" int attn_fused_staged_ctas_per_sm(int bm, int smem) {
#define QUERY(BM) \
    return occupancy::ctas_per_sm(attn_fused_staged_kernel<BM>, attn::kColTile, smem)
    ATTN_DISPATCH_BM(bm, QUERY)
#undef QUERY
}
