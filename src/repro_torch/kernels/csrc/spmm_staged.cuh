// The staged fused SpMM kernels K3 (spmm_ell_fused_staged.cu) and K4
// (spmm_bcsr_fused_staged.cu): one kernel template, STAGED_X = false for
// K3 (all VPU descriptors, X read straight from device memory) and true
// for K4 (tagged descriptors, X through shared memory as well).
//
// Work.  Persistent CTAs: blockIdx.x walks merged trips g, g + gridDim.x,
// ..., for one 128-column tile (blockIdx.y); each thread owns one column.
// A trip whose slot and column windows both fit a ring slot (the planner's
// blk_span/blk_cspan, recomputed here from blk_L and the tags) is ONE
// item: its members run one after another from the slot, each with fresh
// accumulators and its own store, exactly as in K1/K2.  A larger trip is
// walked member by member in chunks (items): a VPU descriptor in ranges
// of CH steps, each row's segment [r*L + n0, r*L + n1) copied to its own
// CH + 4 entry row of the slot; an MXU descriptor in ranges of KC block
// steps.  The accumulators live across a member's chunks and the rows are
// stored after its last, so every row is summed in the order of K1/K2.
//
// The ring.  Two slots, each C + 4 value entries and C + 4 column
// entries, filled by cp.async.bulk (the Hopper bulk copy engine) and
// completed on one mbarrier per slot with a transaction count.  Thread 0
// issues item i + 1's copies into the other slot before the CTA waits
// for item i and computes it; a __syncthreads at the top of each item
// keeps a slot from being refilled while it is read.  A bulk copy needs a
// 16-byte-aligned source and a size in 16-byte units, and the windows
// start anywhere, so each copy starts at the aligned-down entry and the
// compute indexes with the remainder; the planner's tail padding of
// max_span entries keeps the rounded-up end inside the stream.
//
// X in K4.  Each step's X rows (bm gathered rows on a VPU step, bk panel
// rows on an MXU step) go through an X ring of kXStages buffers in shared
// memory, kXStages - 1 steps ahead of the compute (the reference's
// xgbuf/xpbuf).  Each thread copies its own column of every row with a
// 4-byte cp.async (the access pattern of K2's loads: a warp reads 128
// contiguous bytes of a row, through L1) and reads back only what it
// copied, so cp.async.wait_group alone orders the ring and it needs no
// barrier.  (Whole rows copied in 16-byte pieces by one warp, with a
// barrier a step, ran the VPU trips ~6x slower than K2 on an H100.)
// These copies complete through cp.async groups and the window copies
// through the mbarriers, so the two pipelines do not wait on each other.
#pragma once

#include <cstdint>

#include "spmm_trips.cuh"

namespace spmm_staged {

constexpr int kXStages = 4;   // X ring buffers (K4)

struct Params {
    const int* tag;      // K4 only
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

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
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

template <int BM, bool STAGED_X>
struct Staged {
    const Params p;

    __device__ bool is_mxu(long long b) const {
        return STAGED_X && __ldg(p.tag + b) != 0;
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

    // thread 0: start item `it`'s window copies into slot (vs, cs)
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

    // this thread's column of VPU step s's bm X rows into an X buffer
    __device__ void stage_vpu_x(float* xb, const int* cs, const int (&cp)[BM],
                                int s, int col) const {
#pragma unroll
        for (int r = 0; r < BM; ++r) {
            const long long k = cs[cp[r] + s];
            cp_async4(xb + r * spmm::kColTile + threadIdx.x,
                      p.x + k * p.d_pad + col);
        }
    }

    // this thread's column of block-column bc's bk X panel rows
    __device__ void stage_mxu_x(float* xb, int bc, int col) const {
        const float* xp = p.x + static_cast<long long>(bc) * p.bk * p.d_pad
                          + col;
        for (int c = 0; c < p.bk; ++c)
            cp_async4(xb + c * spmm::kColTile + threadIdx.x,
                      xp + static_cast<long long>(c) * p.d_pad);
    }

    // steps [0, n) of a VPU descriptor: row r's slot for step s is
    // vs[vp[r] + s], its column entry cs[cp[r] + s]
    __device__ void vpu_steps(float (&acc)[BM], const float* vs,
                              const int* cs, const int (&vp)[BM],
                              const int (&cp)[BM], int n, float* xring,
                              int col) const {
        if (!STAGED_X) {
            for (int s = 0; s < n; ++s) {
#pragma unroll
                for (int r = 0; r < BM; ++r) {
                    const long long k = cs[cp[r] + s];
                    const float xv = __ldg(p.x + k * p.d_pad + col);
                    acc[r] = __fadd_rn(acc[r], __fmul_rn(vs[vp[r] + s], xv));
                }
            }
            return;
        }
        x_pipeline(n, xring,
                   [&](int q, float* xb) { stage_vpu_x(xb, cs, cp, q, col); },
                   [&](int q, const float* xb) {
                       xb += threadIdx.x;
#pragma unroll
                       for (int r = 0; r < BM; ++r)
                           acc[r] = __fadd_rn(acc[r],
                                              __fmul_rn(vs[vp[r] + q],
                                                        xb[r * spmm::kColTile]));
                   });
    }

    // block steps [0, n) of an MXU descriptor: step k's (bm x bk) value
    // panel at va[k*bm*bk], its block-column cs[k]; per step t = a·xp in
    // K2's order, then acc += t
    __device__ void mxu_steps(float (&acc)[BM], const float* va,
                              const int* cs, int n, float* xring,
                              int col) const {
        x_pipeline(n, xring,
                   [&](int k, float* xb) { stage_mxu_x(xb, cs[k], col); },
                   [&](int k, const float* xb) {
                       const float* a = va + static_cast<long long>(k) * BM * p.bk;
                       xb += threadIdx.x;
                       float t[BM];
                       spmm::zero(t);
                       for (int c = 0; c < p.bk; ++c) {
                           const float xv = xb[c * spmm::kColTile];
#pragma unroll
                           for (int r = 0; r < BM; ++r)
                               t[r] = __fadd_rn(t[r], __fmul_rn(a[r * p.bk + c], xv));
                       }
#pragma unroll
                       for (int r = 0; r < BM; ++r)
                           acc[r] = __fadd_rn(acc[r], t[r]);
                   });
    }

    // steps [0, n) through this thread's entries of the X ring:
    // stage(q, buf) starts step q's copies into a buffer, compute(q, buf)
    // runs step q from it.  At step s the ring holds steps s .. s +
    // kXStages - 2, and step s + kXStages - 1 refills step s - 1's buffer,
    // which this thread has finished reading.  Every step commits one
    // group, empty or not, so wait_group counts steps.
    template <typename Stage, typename Compute>
    __device__ void x_pipeline(int n, float* xring, Stage stage,
                               Compute compute) const {
        const int xlen = max(BM, p.bk) * spmm::kColTile;
        for (int q = 0; q < kXStages - 1; ++q) {
            if (q < n) stage(q, xring + q * xlen);
            cp_async_commit();
        }
        for (int s = 0; s < n; ++s) {
            cp_async_wait<kXStages - 2>();
            const int q = s + kXStages - 1;
            if (q < n) stage(q, xring + (q % kXStages) * xlen);
            cp_async_commit();
            compute(s, xring + (s % kXStages) * xlen);
        }
    }

    // run item `it` from slot (vs, cs); acc carries a member's rows
    // across its chunks
    __device__ void compute(const Item& it, const float* vs, const int* cs,
                            float (&acc)[BM], float* xring,
                            int col) const {
        int vp[BM], cp[BM];
        if (it.w < 0) {
            const long long b0 = static_cast<long long>(it.g) * p.mw;
            const long long v0 = __ldg(p.off + b0);
            const long long c0 = __ldg(p.coff + b0);
            for (int w = 0; w < p.mw; ++w) {
                const long long b = b0 + w;
                const int L = __ldg(p.L + b);
                // the member's first slot and column entry in the slot
                const int lv = rem4(v0) + static_cast<int>(__ldg(p.off + b) - v0);
                const int lc = rem4(c0) + static_cast<int>(__ldg(p.coff + b) - c0);
                spmm::zero(acc);
                if (is_mxu(b)) {
                    mxu_steps(acc, vs + lv, cs + lc, L, xring, col);
                } else {
#pragma unroll
                    for (int r = 0; r < BM; ++r) {
                        vp[r] = lv + r * L;
                        cp[r] = lc + r * L;
                    }
                    vpu_steps(acc, vs, cs, vp, cp, L, xring, col);
                }
                spmm::store_rows<BM>(p.y, b, acc, col, p.d_pad);
            }
            return;
        }
        const long long b = static_cast<long long>(it.g) * p.mw + it.w;
        const long long L = __ldg(p.L + b);
        const long long ob = __ldg(p.off + b);
        const long long cb = __ldg(p.coff + b);
        if (it.c == 0) spmm::zero(acc);
        if (is_mxu(b)) {
            const long long k0 = static_cast<long long>(it.c) * p.kc;
            const int n = static_cast<int>(min(L, k0 + p.kc) - k0);
            mxu_steps(acc, vs + rem4(ob + k0 * BM * p.bk), cs + rem4(cb + k0),
                      n, xring, col);
        } else {
            const long long n0 = static_cast<long long>(it.c) * p.ch;
            const int n = static_cast<int>(max(min(L, n0 + p.ch) - n0, 0LL));
#pragma unroll
            for (int r = 0; r < BM; ++r) {
                vp[r] = r * (p.ch + 4) + rem4(ob + r * L + n0);
                cp[r] = r * (p.ch + 4) + rem4(cb + r * L + n0);
            }
            vpu_steps(acc, vs, cs, vp, cp, n, xring, col);
        }
        if (it.c + 1 == member_chunks(b))
            spmm::store_rows<BM>(p.y, b, acc, col, p.d_pad);
    }
};

template <int BM, bool STAGED_X>
__global__ void __launch_bounds__(spmm::kColTile)
staged_kernel(const Params p) {
    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
    const int slot = p.cap + 4;
    float* vslot = reinterpret_cast<float*>(smem + 16);
    int* cslot = reinterpret_cast<int*>(vslot + 2 * slot);
    float* xring = reinterpret_cast<float*>(cslot + 2 * slot);
    const int col = blockIdx.y * spmm::kColTile + threadIdx.x;
    const Staged<BM, STAGED_X> st{p};

    if (threadIdx.x == 0) {
        mbar_init(&bar[0], 1);
        mbar_init(&bar[1], 1);
        mbar_fence_init();
    }
    __syncthreads();
    Item it = st.trip_item(blockIdx.x);
    if (threadIdx.x == 0) st.issue(it, vslot, cslot, &bar[0]);
    float acc[BM];
    spmm::zero(acc);
    for (int i = 0; it.g >= 0; ++i) {
        const Item nxt = st.next(it);
        const int s = i & 1, o = s ^ 1;
        // every thread is done with slot o (item i - 1) before it refills
        __syncthreads();
        if (threadIdx.x == 0 && nxt.g >= 0)
            st.issue(nxt, vslot + o * slot, cslot + o * slot, &bar[o]);
        mbar_wait(&bar[s], (i >> 1) & 1);
        st.compute(it, vslot + s * slot, cslot + s * slot, acc, xring, col);
        it = nxt;
    }
}

// Dynamic shared memory of one CTA; kernels/spmm_ell_fused.py::ring_bytes
// computes the same.
inline size_t ring_bytes(int cap, int bm, int bk, bool staged_x) {
    const size_t x_ring = staged_x
        ? static_cast<size_t>(kXStages) * (bm > bk ? bm : bk)
              * spmm::kColTile * 4u
        : 0u;
    return 16u + 2u * 2u * (static_cast<size_t>(cap) + 4u) * 4u + x_ring;
}

// Launch with persistent CTAs: as many per column tile as fit on the
// card at once, at most one per merged trip.
template <int BM, bool STAGED_X>
cudaError_t launch(const Params& p, cudaStream_t stream) {
    const size_t smem = ring_bytes(p.cap, BM, p.bk, STAGED_X);
    auto kernel = staged_kernel<BM, STAGED_X>;
    cudaError_t err;
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return err;
    }
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, spmm::kColTile, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const int tiles = p.d_pad / spmm::kColTile;
    long long ctas = static_cast<long long>(sms) * per_sm / tiles;
    ctas = ctas < 1 ? 1 : (ctas > p.num_trips ? p.num_trips : ctas);
    kernel<<<dim3(static_cast<unsigned>(ctas), tiles), spmm::kColTile, smem,
             stream>>>(p);
    return cudaGetLastError();
}

}  // namespace spmm_staged
