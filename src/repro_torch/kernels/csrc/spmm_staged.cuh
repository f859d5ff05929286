// The staged walk shared by the staged fused kernels: K3/K4
// (spmm_gather_ring.cuh, through spmm_ell_fused_staged.cu and
// spmm_bcsr_fused_staged.cu) and K6 (attn_fused_staged.cu).
//
// Work.  Persistent CTAs: blockIdx.x walks merged trips g, g + gridDim.x,
// ..., for one 128-column tile (blockIdx.y).  A trip whose slot and
// column windows both fit a ring slot (the planner's blk_span/blk_cspan,
// recomputed here from blk_L and the tags) is ONE item: its members run
// one after another from the slot, each with fresh accumulators and its
// own store, exactly as in K1/K2.  A larger trip is walked member by
// member in chunks (items): a VPU descriptor in ranges of CH steps, each
// row's segment [r*L + n0, r*L + n1) copied to its own CH + 4 entry row
// of the slot; an MXU descriptor in ranges of KC block steps.  The
// accumulators live across a member's chunks and the rows are stored
// after its last, so every row is summed in the order of K1/K2.
//
// The windows.  A slot holds C + 4 value entries and C + 4 column
// entries, filled by cp.async.bulk (the Hopper bulk copy engine) and
// completed on the slot's mbarrier with a transaction count (issue()).
// A bulk copy needs a 16-byte-aligned source and a size in 16-byte
// units, and the windows start anywhere, so each copy starts at the
// aligned-down entry and the compute indexes with the remainder; the
// planner's tail padding of max_span entries keeps the rounded-up end
// inside the stream.
#pragma once

#include <cstdint>

#include "spmm_trips.cuh"

namespace spmm_staged {

struct Params {
    const int* tag;      // K4/K6 only
    const int* off;
    const int* coff;     // == off for K3
    const int* L;
    const int* cols;
    const float* vals;
    const float* x;
    float* y;
    int num_trips, mw, bk, d_pad;
    int cap;             // C: slot capacity in entries (multiple of 4)
    int ch;              // VPU chunk: steps per row segment (multiple of 4)
    int kc;              // MXU chunk: block steps
};

// one unit of staged work: a whole trip (w < 0), or chunk c of member w
struct Item {
    int g, w, c, span, cspan;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.b32 %0, 1, 0, p;\n\t}"
            : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    } while (!done);
}

// bulk copy of `bytes` (a multiple of 16) from global to shared memory,
// completing on `bar`'s transaction count
__device__ __forceinline__ void bulk_g2s(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// bytes a copy of entries [src, src + len) moves from its aligned start
__device__ __forceinline__ uint32_t window_bytes(long long src, long long len) {
    if (len <= 0) return 0;
    return static_cast<uint32_t>((((src + len + 3) & ~3LL) - (src & ~3LL)) * 4);
}

template <typename T>
__device__ __forceinline__ void copy_window(T* dst, const T* stream,
                                            long long src, long long len,
                                            uint64_t* bar) {
    if (len <= 0) return;
    bulk_g2s(dst, stream + (src & ~3LL), window_bytes(src, len), bar);
}

__device__ __forceinline__ int rem4(long long v) {
    return static_cast<int>(v & 3);
}

template <int BM, bool MIXED>
struct Staged {
    const Params p;

    __device__ bool is_mxu(long long b) const {
        return MIXED && __ldg(p.tag + b) != 0;
    }

    __device__ int member_chunks(long long b) const {
        const int L = __ldg(p.L + b);
        if (L == 0) return 1;
        const int step = is_mxu(b) ? p.kc : p.ch;
        return (L + step - 1) / step;
    }

    // the first item of trip g: the whole trip when both windows fit
    __device__ Item trip_item(int g) const {
        long long span = 0, cspan = 0;
        for (int w = 0; w < p.mw; ++w) {
            const long long b = static_cast<long long>(g) * p.mw + w;
            const long long L = __ldg(p.L + b);
            if (is_mxu(b)) {
                span += L * BM * p.bk;
                cspan += L;
            } else {
                span += L * BM;
                cspan += L * BM;
            }
        }
        if (span <= p.cap && cspan <= p.cap)
            return Item{g, -1, 0, static_cast<int>(span),
                        static_cast<int>(cspan)};
        return Item{g, 0, 0, 0, 0};
    }

    __device__ Item next(const Item& it) const {
        if (it.w >= 0) {
            const long long b = static_cast<long long>(it.g) * p.mw + it.w;
            if (it.c + 1 < member_chunks(b))
                return Item{it.g, it.w, it.c + 1, 0, 0};
            if (it.w + 1 < p.mw) return Item{it.g, it.w + 1, 0, 0, 0};
        }
        const int g = it.g + gridDim.x;
        if (g >= p.num_trips) return Item{-1, 0, 0, 0, 0};
        return trip_item(g);
    }

    // one thread: start item `it`'s window copies into slot (vs, cs)
    __device__ void issue(const Item& it, float* vs, int* cs,
                          uint64_t* bar) const {
        if (it.w < 0) {
            const long long b0 = static_cast<long long>(it.g) * p.mw;
            const long long v0 = __ldg(p.off + b0);
            const long long c0 = __ldg(p.coff + b0);
            mbar_arrive_expect_tx(bar, window_bytes(v0, it.span)
                                       + window_bytes(c0, it.cspan));
            copy_window(vs, p.vals, v0, it.span, bar);
            copy_window(cs, p.cols, c0, it.cspan, bar);
            return;
        }
        const long long b = static_cast<long long>(it.g) * p.mw + it.w;
        const long long L = __ldg(p.L + b);
        const long long ob = __ldg(p.off + b);
        const long long cb = __ldg(p.coff + b);
        if (is_mxu(b)) {
            const long long k0 = static_cast<long long>(it.c) * p.kc;
            const long long n = min(L, k0 + p.kc) - k0;
            const long long step = static_cast<long long>(BM) * p.bk;
            mbar_arrive_expect_tx(bar, window_bytes(ob + k0 * step, n * step)
                                       + window_bytes(cb + k0, n));
            copy_window(vs, p.vals, ob + k0 * step, n * step, bar);
            copy_window(cs, p.cols, cb + k0, n, bar);
            return;
        }
        const long long n0 = static_cast<long long>(it.c) * p.ch;
        const long long n = max(min(L, n0 + p.ch) - n0, 0LL);
        uint32_t bytes = 0;
        for (int r = 0; r < BM; ++r)
            bytes += window_bytes(ob + r * L + n0, n)
                     + window_bytes(cb + r * L + n0, n);
        mbar_arrive_expect_tx(bar, bytes);
        for (int r = 0; r < BM; ++r) {
            copy_window(vs + r * (p.ch + 4), p.vals, ob + r * L + n0, n, bar);
            copy_window(cs + r * (p.ch + 4), p.cols, cb + r * L + n0, n, bar);
        }
    }
};

}  // namespace spmm_staged
