// The warp-specialised fused SpMM kernels K3 (spmm_ell_fused_staged.cu),
// K4 (spmm_bcsr_fused_staged.cu), K2 (spmm_bcsr_fused.cu) and K1
// (spmm_ell_fused.cu, at planned widths), and the micro-oracles K9
// (spmm_ell_segment.cu) and K10 (spmm_bcsr.cu, at planned widths): one
// kernel template, MIXED = false for K3, K9 and K1 (all VPU descriptors,
// coff == off) and true for K4, K2 and K10 (MXU block steps too), and a
// descriptor source: FromSlots for the staged K3/K4 (the slot ring and
// chunked walk below), Resident for K2 and K9, which reads the descriptor
// tables and the value and column streams where they lie in global
// memory and walks whole trips, member by member, with no slot ring;
// and, with stages of several steps whose values ride in the stage,
// EllStages for K1 and BlockRows for K10 (an implicit table of
// block-rows).  All sources feed the same X ring.
//
// Work.  Persistent CTAs walk merged trips g, g + gridDim.x, ... for one
// 128-column tile (blockIdx.y), in spmm_staged.cuh's items: a trip whose
// windows fit a slot is one item, a larger one is walked member by
// member in chunks that keep every row's order of summation.  A CTA is
// four consumer warps, one output column per thread with a descriptor's
// bm fp32 accumulators in registers, and one producer warp that moves
// every byte the consumers read into shared memory ahead of them.
//
// The slot ring.  kSlots slots of C + 4 value and C + 4 column entries,
// each with a full and an empty mbarrier.  Lane 0 of the producer fills
// item i + 1's slot with spmm_staged.cuh's cp.async.bulk window copies
// (aligned-down starts, completion by transaction count on the slot's
// full barrier) before it stages item i's X rows; the consumers arrive on
// the slot's empty barrier when they finish the item.
//
// The X ring.  kXStages stages of max(bm, bk) rows of one column tile (4
// KB at bm = 8), each with a full and an empty mbarrier.  For a VPU step
// the producer reads the step's bm column indices from the slot and
// copies X row k_r's 512-byte segment into stage row r; for an MXU step
// it copies the bk rows of the step's X panel.  Each lane copies 16
// bytes of every row with cp.async.ca (one warp instruction a row) and
// then arrives on the stage's full barrier with
// cp.async.mbarrier.arrive.noinc, which fires when its copies have
// landed, so the barrier completes when the whole stage is in.  The
// producer runs up to kXStages - 1 steps ahead of the consumers, across
// member, item and trip boundaries.  The consumers wait on full, add
// acc[r] = __fadd_rn(acc[r], __fmul_rn(v, xs[r][t])) (an MXU step: t =
// a·xp over the panel's rows in order, then acc += t) in K1/K2's order,
// and arrive on empty.  The only CTA-wide barrier is the one after the
// barriers' initialisation: nothing in the walk waits for the whole CTA.
//
// What bounds it on an H100 is bytes: on a uniform random graph every
// nonzero gathers one 512-byte X row segment that misses the 50 MB L2.
// Three stages in flight per CTA (12 KB at bm = 8) and six to eight
// 26 KB CTAs per SM keep 72-96 KB of gathers in flight per SM, over the
// ~25 KB that 3.35 TB/s needs at ~1 us of loaded latency (Little's law);
// the consumers spend no instruction on the copies.  Measured on an H100
// (PERF.md): more stages cost CTAs and ran slower; the L2-only copy
// (cp.async.cg) and one 512-byte cp.async.bulk a row both ran the
// gathers several times slower than cp.async.ca.  (An earlier K4 had
// whole rows copied in 16-byte pieces by one warp too, but with a
// __syncthreads at every step and a two-step ring, and ran VPU trips ~6x
// slower than K2; here no step waits for the CTA.)
#pragma once

#include <cstdint>

#include "spmm_staged.cuh"

namespace spmm_ring {

using spmm_staged::Item;
using spmm_staged::Params;
using spmm_staged::mbar_wait;

constexpr int kConsumers = spmm::kColTile;     // one thread per output column
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;      // plus the producer warp
constexpr int kSlots = 3;                      // window slots
constexpr int kXStages = 4;                    // X ring stages
// full and empty barriers of every slot and stage
constexpr int kBarriers = 2 * kSlots + 2 * kXStages;

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                 :: "r"(spmm_staged::smem_u32(bar)) : "memory");
}

// 16 bytes from global to shared memory, cached in L1 (.ca)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16;"
                 :: "r"(spmm_staged::smem_u32(dst)), "l"(src) : "memory");
}

// 4 bytes from global to shared memory, cached in L1 (.ca)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
                 :: "r"(spmm_staged::smem_u32(dst)), "l"(src) : "memory");
}

// arrive on `bar` once every earlier cp.async of this thread has landed;
// the barrier's expected count includes this arrival
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
                 :: "r"(spmm_staged::smem_u32(bar)) : "memory");
}

// wait until every cp.async of this thread has landed
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_all;" ::: "memory");
}

// Dynamic shared memory of one CTA with the slot source;
// kernels/spmm_ell_fused.py::ring_bytes computes the same.
inline size_t ring_bytes(int cap, int bm, int bk) {
    return 8u * kBarriers + 2u * kSlots * (static_cast<size_t>(cap) + 4u) * 4u
           + static_cast<size_t>(kXStages) * (bm > bk ? bm : bk)
                 * spmm::kColTile * 4u;
}

// The resident source's: the barriers and the X ring, each stage with
// room for an MXU step's value panel, no slots
// (kernels/spmm_bcsr_fused.py::ring_bytes computes the same).
inline size_t resident_ring_bytes(int bm, int bk) {
    const size_t stage = static_cast<size_t>(bm > bk ? bm : bk) * spmm::kColTile
                         + (static_cast<size_t>(bm) * bk + 3) / 4 * 4;
    return 8u * kBarriers + kXStages * stage * 4u;
}

template <int BM, bool MIXED, class Src> struct Ring;

// A step's BM entries of a slot, read where they are used.
template <class T, int BM>
struct SlotEntries {
    const T* base;
    const int (&at)[BM];
    int s;
    __device__ T operator[](int r) const { return base[at[r] + s]; }
};

// An MXU step's block-column entry of a slot, read where it is used.
struct SlotEntry {
    const int* base;
    int k;
    __device__ operator int() const { return base[k]; }
};

// A step's BM entries of a global stream, loaded as it is read.
template <class T, int BM>
struct Loaded {
    T v[BM];
    __device__ T operator[](int r) const { return v[r]; }
};

// Descriptor sources (see the top of this file).  Each says where a
// step's column indices, values and MXU value panel come from, how
// both roles walk the CTA's trips, and how much shared memory a CTA
// takes; Ring, Producer and Consumer are the same for both.
//
// FromSlots (K3/K4): windows in the slot ring, items of the chunked walk.
struct FromSlots {
    __device__ static int slot_entries(int cap) { return cap + 4; }
    __device__ static int panel_floats(int, int) { return 0; }
    static size_t smem(int cap, int bm, int bk) {
        return ring_bytes(cap, bm, bk);
    }

    template <int BM>
    __device__ static SlotEntries<int, BM> columns(
            const int* cs, const int (&cp)[BM], int s) {
        return {cs, cp, s};
    }
    __device__ static SlotEntry column(const int* cs, int k) {
        return {cs, k};
    }
    template <int BM>
    __device__ static SlotEntries<float, BM> values(
            const float* vs, const int (&vp)[BM], int s) {
        return {vs, vp, s};
    }
    // the panel stays in the slot
    template <class R>
    __device__ static void stage_panel(const R&, uint32_t, const float*,
                                       int) {}
    template <class R>
    __device__ static const float* panel(const R&, uint32_t,
                                         const float* va) {
        return va;
    }

    // Item `it` from slot (vs, cs), member by member: role.begin(first
    // chunk), then its steps through role.vpu (row r's slot for step s
    // at vs[vp[r] + s], its column entry at cs[cp[r] + s]) or role.mxu
    // (step k's value panel at va[k*bm*bk], its block-column cs[k]),
    // then role.end(descriptor, last chunk).
    template <int BM, bool MIXED, class Role>
    __device__ static void run(const Ring<BM, MIXED, FromSlots>& ring,
                               const Item& it, const float* vs,
                               const int* cs, Role& role) {
        const Params& p = ring.walk.p;
        int vp[BM], cp[BM];
        if (it.w < 0) {
            const long long b0 = static_cast<long long>(it.g) * p.mw;
            const long long v0 = __ldg(p.off + b0);
            const long long c0 = __ldg(p.coff + b0);
            for (int w = 0; w < p.mw; ++w) {
                const long long b = b0 + w;
                const int L = __ldg(p.L + b);
                // the member's first slot and column entry in the slot
                const int lv = spmm_staged::rem4(v0)
                               + static_cast<int>(__ldg(p.off + b) - v0);
                const int lc = spmm_staged::rem4(c0)
                               + static_cast<int>(__ldg(p.coff + b) - c0);
                role.begin(true);
                if (ring.walk.is_mxu(b)) {
                    role.mxu(vs + lv, cs + lc, L);
                } else {
#pragma unroll
                    for (int r = 0; r < BM; ++r) {
                        vp[r] = lv + r * L;
                        cp[r] = lc + r * L;
                    }
                    role.vpu(vs, cs, vp, cp, L);
                }
                role.end(b, true);
            }
            return;
        }
        const long long b = static_cast<long long>(it.g) * p.mw + it.w;
        const long long L = __ldg(p.L + b);
        const long long ob = __ldg(p.off + b);
        const long long cb = __ldg(p.coff + b);
        role.begin(it.c == 0);
        if (ring.walk.is_mxu(b)) {
            const long long k0 = static_cast<long long>(it.c) * p.kc;
            const int n = static_cast<int>(min(L, k0 + p.kc) - k0);
            role.mxu(vs + spmm_staged::rem4(ob + k0 * BM * p.bk),
                     cs + spmm_staged::rem4(cb + k0), n);
        } else {
            const long long n0 = static_cast<long long>(it.c) * p.ch;
            const int n = static_cast<int>(max(min(L, n0 + p.ch) - n0, 0LL));
#pragma unroll
            for (int r = 0; r < BM; ++r) {
                vp[r] = r * (p.ch + 4) + spmm_staged::rem4(ob + r * L + n0);
                cp[r] = r * (p.ch + 4) + spmm_staged::rem4(cb + r * L + n0);
            }
            role.vpu(vs, cs, vp, cp, n);
        }
        role.end(b, it.c + 1 == ring.walk.member_chunks(b));
    }

    template <int BM, bool MIXED, class Role>
    __device__ static void produce(const Ring<BM, MIXED, FromSlots>& ring,
                                   Role& role) {
        const int lane = threadIdx.x & 31;
        Item it = ring.walk.trip_item(blockIdx.x);
        if (lane == 0)
            ring.walk.issue(it, ring.vs(0), ring.cs(0), ring.slot_full(0));
        int i = 0;
        for (;; ++i) {
            // item i + 1's windows go in flight before item i's X rows
            const Item nxt = ring.walk.next(it);
            if (nxt.g >= 0) {
                mbar_wait(ring.slot_empty(i + 1),
                          (((i + 1) / kSlots) & 1) ^ 1);
                if (lane == 0)
                    ring.walk.issue(nxt, ring.vs(i + 1), ring.cs(i + 1),
                                    ring.slot_full(i + 1));
            }
            mbar_wait(ring.slot_full(i), (i / kSlots) & 1);
            run(ring, it, ring.vs(i), ring.cs(i), role);
            if (nxt.g < 0) break;
            it = nxt;
        }
        // leave once the consumers have finished the last item, so that
        // no copy of this warp is in flight when it exits
        mbar_wait(ring.slot_empty(i), (i / kSlots) & 1);
    }

    template <int BM, bool MIXED, class Role>
    __device__ static void consume(const Ring<BM, MIXED, FromSlots>& ring,
                                   Role& role) {
        Item it = ring.walk.trip_item(blockIdx.x);
        for (int i = 0; it.g >= 0; ++i) {
            mbar_wait(ring.slot_full(i), (i / kSlots) & 1);
            run(ring, it, ring.vs(i), ring.cs(i), role);
            __syncwarp();
            if ((threadIdx.x & 31) == 0) mbar_arrive(ring.slot_empty(i));
            it = ring.walk.next(it);
        }
    }
};

// Resident (K2, K9): the descriptor tables and the value and column streams
// where they lie in global memory, whole trips, no slots (their
// barriers stay unused).  A step's columns and values are loaded before
// the role waits for its stage; the producer copies an MXU step's value
// panel into the stage after its X rows.
struct Resident {
    __device__ static int slot_entries(int) { return 0; }
    // an MXU step's value panel, rounded up to whole 16-byte units
    __device__ static int panel_floats(int bm, int bk) {
        return (bm * bk + 3) / 4 * 4;
    }
    static size_t smem(int, int bm, int bk) {
        return resident_ring_bytes(bm, bk);
    }

    template <int BM>
    __device__ static Loaded<int, BM> columns(
            const int* cols, const int (&cp)[BM], int s) {
        Loaded<int, BM> k;
#pragma unroll
        for (int r = 0; r < BM; ++r) k.v[r] = __ldg(cols + cp[r] + s);
        return k;
    }
    __device__ static int column(const int* cols, int k) {
        return __ldg(cols + k);
    }
    template <int BM>
    __device__ static Loaded<float, BM> values(
            const float* vals, const int (&vp)[BM], int s) {
        Loaded<float, BM> v;
#pragma unroll
        for (int r = 0; r < BM; ++r) v.v[r] = __ldg(vals + vp[r] + s);
        return v;
    }
    // where stage q keeps its MXU step's value panel: after the X rows
    template <class R>
    __device__ static float* panel(const R& ring, uint32_t q,
                                   const float* = nullptr) {
        const int bk = ring.walk.p.bk;
        return ring.xs(q) + (R::kBM > bk ? R::kBM : bk) * spmm::kColTile;
    }
    // 4 bytes a copy: a panel starts anywhere in the stream
    template <class R>
    __device__ static void stage_panel(const R& ring, uint32_t q,
                                       const float* a, int lane) {
        float* ab = panel(ring, q);
        for (int i = lane; i < R::kBM * ring.walk.p.bk; i += 32)
            cp_async4(ab + i, a + i);
    }

    // The CTA's trips g, g + gridDim.x, ..., member by member, each a
    // whole descriptor (role.vpu/mxu get the streams themselves, row r's
    // first slot at vp[r], its first column entry at cp[r]).
    template <int BM, bool MIXED, class Role>
    __device__ static void run(const Ring<BM, MIXED, Resident>& ring,
                               Role& role) {
        const Params& p = ring.walk.p;
        int vp[BM], cp[BM];
        for (int g = blockIdx.x; g < p.num_trips; g += gridDim.x) {
            for (int w = 0; w < p.mw; ++w) {
                const long long b = static_cast<long long>(g) * p.mw + w;
                const int off = __ldg(p.off + b);
                const int coff = __ldg(p.coff + b);
                const int L = __ldg(p.L + b);
                role.begin(true);
                if (ring.walk.is_mxu(b)) {
                    role.mxu(p.vals + off, p.cols + coff, L);
                } else {
#pragma unroll
                    for (int r = 0; r < BM; ++r) {
                        vp[r] = off + r * L;
                        cp[r] = coff + r * L;
                    }
                    role.vpu(p.vals, p.cols, vp, cp, L);
                }
                role.end(b, true);
            }
        }
    }

    template <int BM, bool MIXED, class Role>
    __device__ static void produce(const Ring<BM, MIXED, Resident>& ring,
                                   Role& role) {
        run(ring, role);
        // no copy of this warp is in flight when it exits
        cp_async_wait_all();
    }

    template <int BM, bool MIXED, class Role>
    __device__ static void consume(const Ring<BM, MIXED, Resident>& ring,
                                   Role& role) {
        run(ring, role);
    }
};

// EllStages (K1): the resident ELL plan (VPU descriptors only, coff ==
// off) where it lies in global memory, whole trips, and stages of
// ell_rows(bm) = max(kStageRows, bm) rows: S = rows / bm consecutive steps
// of one descriptor, so a row block of bm = 1 keeps as many X rows in
// flight a stage as bm = 8.  Lane i of the producer holds step i / bm,
// row i % bm of a stage: it loads that slot's column entry one stage
// ahead (one warp load a stage), and when the stage is free every lane
// copies its 16 bytes of each of the stage's X rows (the column entry
// broadcast by a shuffle) and lane i the slot's value (4 bytes, after
// the rows), then arrives on the stage's full barrier.  The consumers
// add the stage's steps in order, every operand from shared memory, so
// each row is summed in K1's order.  The launch sets p.bk to the stage's
// rows, which sizes the stage (rows of X, then their values).
constexpr int kStageRows = 8;

__host__ __device__ constexpr int ell_rows(int bm) {
    return bm > kStageRows ? bm : kStageRows;
}

// kernels/spmm_ell_fused.py::resident_ring_bytes computes the same
inline size_t ell_ring_bytes(int rows) {
    return 8u * kBarriers
           + kXStages * (static_cast<size_t>(rows) * spmm::kColTile
                         + (rows + 3) / 4 * 4) * 4u;
}

struct EllStages {
    // where the CTA's walk stands: steps [s0, s0 + S) of descriptor b
    struct Stage {
        long long b;
        int off, L, s0;
    };

    __device__ static int slot_entries(int) { return 0; }
    // a stage's values after its rows, in whole 16-byte units
    __device__ static int panel_floats(int, int rows) {
        return (rows + 3) / 4 * 4;
    }
    static size_t smem(int, int, int rows) { return ell_ring_bytes(rows); }

    // from st: the first stage that has steps, or false past the CTA's
    // last trip (its trips g, g + gridDim.x, ..., members in order)
    __device__ static bool seek(const Params& p, Stage& st) {
        const long long end = static_cast<long long>(p.num_trips) * p.mw;
        while (st.s0 >= st.L) {
            if (++st.b % p.mw == 0)
                st.b += static_cast<long long>(gridDim.x - 1) * p.mw;
            if (st.b >= end) return false;
            st.off = __ldg(p.off + st.b);
            st.L = __ldg(p.L + st.b);
            st.s0 = 0;
        }
        return true;
    }

    template <int BM, bool MIXED, class Role>
    __device__ static void produce(const Ring<BM, MIXED, EllStages>& ring,
                                   Role& role) {
        constexpr int R = ell_rows(BM);
        constexpr int S = R / BM;
        const Params& p = ring.walk.p;
        const long long d_pad = p.d_pad;
        const int r = role.lane % BM;
        const int j = role.lane / BM;
        // this lane's slot of stage st, or -1 (no such step or row)
        auto slot = [&](const Stage& st) {
            return role.lane < R && st.s0 + j < st.L
                       ? st.off + r * st.L + st.s0 + j : -1;
        };
        Stage cur{static_cast<long long>(blockIdx.x) * p.mw, 0, 0, 0};
        bool more = cur.b < static_cast<long long>(p.num_trips) * p.mw;
        if (more) {
            cur.off = __ldg(p.off + cur.b);
            cur.L = __ldg(p.L + cur.b);
            more = seek(p, cur);
        }
        int at = more ? slot(cur) : -1;
        int k = at >= 0 ? __ldg(p.cols + at) : 0;
        while (more) {
            Stage nxt = cur;
            nxt.s0 += S;
            const bool more_nxt = seek(p, nxt);
            const int at_nxt = more_nxt ? slot(nxt) : -1;
            const int k_nxt = at_nxt >= 0 ? __ldg(p.cols + at_nxt) : 0;
            const int rows = min(S, cur.L - cur.s0) * BM;
            float* xb = role.acquire();
#pragma unroll
            for (int i = 0; i < R; ++i) {
                const int ki = __shfl_sync(0xffffffffu, k, i);
                if (i < rows)
                    cp_async16(xb + i * spmm::kColTile, role.x + ki * d_pad);
            }
            if (at >= 0)
                cp_async4(ring.xs(role.q) + R * spmm::kColTile + role.lane,
                          p.vals + at);
            role.commit();
            cur = nxt;
            more = more_nxt;
            at = at_nxt;
            k = k_nxt;
        }
        // no copy of this warp is in flight when it exits
        cp_async_wait_all();
    }

    template <int BM, bool MIXED, class Role>
    __device__ static void consume(const Ring<BM, MIXED, EllStages>& ring,
                                   Role& role) {
        constexpr int R = ell_rows(BM);
        constexpr int S = R / BM;
        const Params& p = ring.walk.p;
        for (int g = blockIdx.x; g < p.num_trips; g += gridDim.x) {
            for (int w = 0; w < p.mw; ++w) {
                const long long b = static_cast<long long>(g) * p.mw + w;
                const int L = __ldg(p.L + b);
                role.begin(true);
                for (int s0 = 0; s0 < L; s0 += S) {
                    const int n = min(S, L - s0);
                    const float* xb = role.acquire();
                    const float* vs = ring.xs(role.q) + R * spmm::kColTile;
#pragma unroll
                    for (int s = 0; s < S; ++s) {
                        if (s < n) {
#pragma unroll
                            for (int i = 0; i < BM; ++i)
                                role.acc[i] = __fadd_rn(
                                    role.acc[i],
                                    __fmul_rn(vs[s * BM + i],
                                              xb[(s * BM + i)
                                                 * spmm::kColTile]));
                        }
                    }
                    role.release();
                }
                role.end(b, true);
            }
        }
    }
};

// BM consecutive floats of shared memory into registers, in 16-byte
// loads where BM % 4 == 0 (src then on a 16-byte boundary), else 8 or 4
template <int BM>
__device__ __forceinline__ void load_row(float (&w)[BM], const float* src) {
    if constexpr (BM % 4 == 0) {
#pragma unroll
        for (int k = 0; k < BM / 4; ++k) {
            const float4 q = reinterpret_cast<const float4*>(src)[k];
            w[4 * k] = q.x;
            w[4 * k + 1] = q.y;
            w[4 * k + 2] = q.z;
            w[4 * k + 3] = q.w;
        }
    } else if constexpr (BM == 2) {
        const float2 q = *reinterpret_cast<const float2*>(src);
        w[0] = q.x;
        w[1] = q.y;
    } else {
        w[0] = src[0];
    }
}

// BlockRows (K10): a BCSR matrix padded to its global kmax, block-row i
// one MXU descriptor with an implicit table: value panels from i*kmax*
// bm*bk, block-columns from i*kmax, kmax steps (p.kc holds kmax; the
// table pointers stay unset).  A stage holds block_steps(bk) = max(1,
// kStageRows / bk) consecutive steps of one block-row, so a small bk keeps
// as many X rows in flight a stage as bk = 8: their bk-row X panels, then
// their value panels.  The producer's lane s loads step s's block-column
// one stage ahead; every lane copies 16 bytes of each X row and 4-byte
// pieces of the value panels, each step's (bm, bk) panel stored
// transposed, (bk, bm), so that a consumer reads the bm values it needs
// for one X row in bm / 4 16-byte loads (measured on an H100, PERF.md:
// the consumers' shared-memory loads, not the copies, set the pace on a
// banded matrix, and this ran every bm and bk tried faster than K2's
// one-step stages).  The consumers run K2's MXU step on each (t = a·xp
// over the panel's rows in order, then acc += t), so the sums are K2's,
// bit for bit.
__host__ __device__ constexpr int block_steps(int bk) {
    return bk < kStageRows ? kStageRows / bk : 1;
}

// a stage's floats: its X rows of one column tile, then its value panels
// in whole 16-byte units (kernels/spmm_bcsr.py::ring_geometry)
__host__ __device__ constexpr int block_stage_floats(int bm, int bk) {
    return block_steps(bk) * bk * spmm::kColTile
           + (block_steps(bk) * bm * bk + 3) / 4 * 4;
}

struct BlockRows {
    __device__ static int slot_entries(int) { return 0; }
    // what a stage holds beyond the max(bm, bk) X rows gather_kernel
    // counts (fewer where the stage's rows are fewer than bm)
    __device__ static int panel_floats(int bm, int bk) {
        return block_stage_floats(bm, bk)
               - (bm > bk ? bm : bk) * spmm::kColTile;
    }
    static size_t smem(int, int bm, int bk) {
        return 8u * kBarriers
               + kXStages * static_cast<size_t>(block_stage_floats(bm, bk))
                     * 4u;
    }

    template <int BM, bool MIXED, class Role>
    __device__ static void produce(const Ring<BM, MIXED, BlockRows>& ring,
                                   Role& role) {
        const Params& p = ring.walk.p;
        const int bk = p.bk;
        const int kmax = p.kc;
        const int S = block_steps(bk);
        const long long d_pad = p.d_pad;
        const long long step = static_cast<long long>(BM) * bk;
        // this lane's block-column of stage (i, s0): step s0 + lane
        auto column = [&](int i, int s0) {
            return i < p.num_trips && role.lane < S && s0 + role.lane < kmax
                       ? __ldg(p.cols + static_cast<long long>(i) * kmax
                               + s0 + role.lane)
                       : 0;
        };
        int i = blockIdx.x;
        int s0 = 0;
        int bc = column(i, s0);
        while (i < p.num_trips) {
            int i_nxt = i;
            int s0_nxt = s0 + S;
            if (s0_nxt >= kmax) {
                i_nxt += gridDim.x;
                s0_nxt = 0;
            }
            const int bc_nxt = column(i_nxt, s0_nxt);
            const int n = min(S, kmax - s0);
            float* xb = role.acquire();
            for (int s = 0; s < n; ++s) {
                const long long row0 =
                    static_cast<long long>(__shfl_sync(0xffffffffu, bc, s))
                    * bk;
                for (int c = 0; c < bk; ++c)
                    cp_async16(xb + (s * bk + c) * spmm::kColTile,
                               role.x + (row0 + c) * d_pad);
            }
            float* panel = ring.xs(role.q) + S * bk * spmm::kColTile;
            const float* a =
                p.vals + (static_cast<long long>(i) * kmax + s0) * step;
            const int floats = static_cast<int>(n * step);
            // each step's (bm, bk) panel stored transposed, (bk, bm)
            const int per = BM * bk;
            for (int e = role.lane; e < floats; e += 32) {
                const int s = e / per;
                const int rem = e - s * per;
                const int r = rem / bk;
                const int c = rem - r * bk;
                cp_async4(panel + s * per + c * BM + r, a + e);
            }
            role.commit();
            i = i_nxt;
            s0 = s0_nxt;
            bc = bc_nxt;
        }
        // no copy of this warp is in flight when it exits
        cp_async_wait_all();
    }

    template <int BM, bool MIXED, class Role>
    __device__ static void consume(const Ring<BM, MIXED, BlockRows>& ring,
                                   Role& role) {
        const Params& p = ring.walk.p;
        const int bk = p.bk;
        const int kmax = p.kc;
        const int S = block_steps(bk);
        for (int i = blockIdx.x; i < p.num_trips; i += gridDim.x) {
            role.begin(true);
            for (int s0 = 0; s0 < kmax; s0 += S) {
                const int n = min(S, kmax - s0);
                const float* xb = role.acquire();
                const float* panel =
                    ring.xs(role.q) + S * bk * spmm::kColTile;
                for (int s = 0; s < n; ++s) {
                    const float* a = panel + s * BM * bk;
                    const float* xs = xb + s * bk * spmm::kColTile;
                    float t[BM];
                    spmm::zero(t);
                    for (int c = 0; c < bk; ++c) {
                        const float xv = xs[c * spmm::kColTile];
                        float w[BM];
                        load_row<BM>(w, a + c * BM);
#pragma unroll
                        for (int r = 0; r < BM; ++r)
                            t[r] = __fadd_rn(t[r], __fmul_rn(w[r], xv));
                    }
#pragma unroll
                    for (int r = 0; r < BM; ++r)
                        role.acc[r] = __fadd_rn(role.acc[r], t[r]);
                }
                role.release();
            }
            role.end(i, true);
        }
    }
};

// The CTA's shared memory and the walk both roles follow.  Use u of
// slot i % kSlots is u = i / kSlots (of stage q % kXStages, q /
// kXStages): a full barrier completes phase u when use u's data is in,
// an empty one when use u has been read.
template <int BM, bool MIXED, class Src = FromSlots>
struct Ring {
    static constexpr int kBM = BM;
    const spmm_staged::Staged<BM, MIXED> walk;
    uint64_t* bar;
    float* vslot;
    int* cslot;
    float* xring;
    int slot;           // entries per slot: C + 4
    int xlen;           // floats per X stage

    __device__ uint64_t* slot_full(int i) const { return bar + i % kSlots; }
    __device__ uint64_t* slot_empty(int i) const {
        return bar + kSlots + i % kSlots;
    }
    __device__ uint64_t* x_full(uint32_t q) const {
        return bar + 2 * kSlots + q % kXStages;
    }
    __device__ uint64_t* x_empty(uint32_t q) const {
        return bar + 2 * kSlots + kXStages + q % kXStages;
    }
    __device__ float* vs(int i) const { return vslot + (i % kSlots) * slot; }
    __device__ int* cs(int i) const { return cslot + (i % kSlots) * slot; }
    __device__ float* xs(uint32_t q) const {
        return xring + (q % kXStages) * xlen;
    }
};

// The producer warp's steps: every lane copies its 16 bytes of each of
// the step's rows into the next free stage.
template <int BM, bool MIXED, class Src = FromSlots>
struct Producer {
    const Ring<BM, MIXED, Src>& ring;
    const float* x;     // X at this tile's first column and this lane's 4
    int lane;
    uint32_t q;         // steps staged so far

    __device__ float* acquire() const {
        mbar_wait(ring.x_empty(q), ((q / kXStages) & 1) ^ 1);
        return ring.xs(q) + 4 * lane;
    }
    __device__ void commit() {
        cp_async_arrive(ring.x_full(q));
        ++q;
    }
    __device__ void begin(bool) {}
    __device__ void end(long long, bool) {}

    __device__ void vpu(const float*, const int* cs, const int (&)[BM],
                        const int (&cp)[BM], int n) {
        const long long d_pad = ring.walk.p.d_pad;
        for (int s = 0; s < n; ++s) {
            const auto k = Src::columns(cs, cp, s);
            float* xb = acquire();
#pragma unroll
            for (int r = 0; r < BM; ++r)
                cp_async16(xb + r * spmm::kColTile, x + k[r] * d_pad);
            commit();
        }
    }

    __device__ void mxu(const float* va, const int* cs, int n) {
        const Params& p = ring.walk.p;
        for (int k = 0; k < n; ++k) {
            const auto bc = Src::column(cs, k);
            float* xb = acquire();
            const float* xp = x + static_cast<long long>(bc) * p.bk * p.d_pad;
            for (int c = 0; c < p.bk; ++c)
                cp_async16(xb + c * spmm::kColTile,
                           xp + static_cast<long long>(c) * p.d_pad);
            Src::stage_panel(ring, q, va + static_cast<long long>(k) * BM * p.bk,
                             lane);
            commit();
        }
    }
};

// A consumer thread's steps: its column of each stage, in step order.
template <int BM, bool MIXED, class Src = FromSlots>
struct Consumer {
    const Ring<BM, MIXED, Src>& ring;
    int col;            // this thread's output column
    uint32_t q;         // steps taken so far
    float acc[BM];

    __device__ const float* acquire() const {
        mbar_wait(ring.x_full(q), (q / kXStages) & 1);
        return ring.xs(q) + threadIdx.x;
    }
    // this warp is done with the stage
    __device__ void release() {
        __syncwarp();
        if ((threadIdx.x & 31) == 0) mbar_arrive(ring.x_empty(q));
        ++q;
    }
    __device__ void begin(bool first) {
        if (first) spmm::zero(acc);
    }
    __device__ void end(long long b, bool last) {
        if (last) spmm::store_rows<BM>(ring.walk.p.y, b, acc, col,
                                       ring.walk.p.d_pad);
    }

    __device__ void vpu(const float* vs, const int*, const int (&vp)[BM],
                        const int (&)[BM], int n) {
        for (int s = 0; s < n; ++s) {
            const auto v = Src::values(vs, vp, s);
            const float* xb = acquire();
#pragma unroll
            for (int r = 0; r < BM; ++r)
                acc[r] = __fadd_rn(acc[r], __fmul_rn(v[r],
                                                     xb[r * spmm::kColTile]));
            release();
        }
    }

    // per step t = a·xp in K2's order, then acc += t
    __device__ void mxu(const float* va, const int*, int n) {
        const int bk = ring.walk.p.bk;
        for (int k = 0; k < n; ++k) {
            const float* xb = acquire();
            const float* a =
                Src::panel(ring, q, va + static_cast<long long>(k) * BM * bk);
            float t[BM];
            spmm::zero(t);
            for (int c = 0; c < bk; ++c) {
                const float xv = xb[c * spmm::kColTile];
#pragma unroll
                for (int r = 0; r < BM; ++r)
                    t[r] = __fadd_rn(t[r], __fmul_rn(a[r * bk + c], xv));
            }
#pragma unroll
            for (int r = 0; r < BM; ++r) acc[r] = __fadd_rn(acc[r], t[r]);
            release();
        }
    }
};

template <int BM, bool MIXED, class Src>
__device__ void produce(const Ring<BM, MIXED, Src>& ring) {
    const Params& p = ring.walk.p;
    const int lane = threadIdx.x & 31;
    Producer<BM, MIXED, Src> role{
        ring, p.x + blockIdx.y * spmm::kColTile + 4 * lane, lane, 0u};
    Src::produce(ring, role);
}

template <int BM, bool MIXED, class Src>
__device__ void consume(const Ring<BM, MIXED, Src>& ring) {
    Consumer<BM, MIXED, Src> role{
        ring, static_cast<int>(blockIdx.y) * spmm::kColTile
                  + static_cast<int>(threadIdx.x), 0u, {}};
    Src::consume(ring, role);
}

template <int BM, bool MIXED, class Src = FromSlots>
__global__ void __launch_bounds__(kThreads) gather_kernel(const Params p) {
    extern __shared__ __align__(128) unsigned char smem[];
    const int slot = Src::slot_entries(p.cap);
    uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
    float* vslot = reinterpret_cast<float*>(bar + kBarriers);
    int* cslot = reinterpret_cast<int*>(vslot + kSlots * slot);
    float* xring = reinterpret_cast<float*>(cslot + kSlots * slot);
    // a stage: max(bm, bk) X rows and the source's panel
    const int xlen = (BM > p.bk ? BM : p.bk) * spmm::kColTile
                     + Src::panel_floats(BM, p.bk);
    const Ring<BM, MIXED, Src> ring{{p}, bar, vslot, cslot, xring, slot, xlen};
    if (threadIdx.x == 0) {
        for (int k = 0; k < kSlots; ++k) {
            spmm_staged::mbar_init(ring.slot_full(k), 1);
            spmm_staged::mbar_init(ring.slot_empty(k), kConsumerWarps);
        }
        for (int j = 0; j < kXStages; ++j) {
            spmm_staged::mbar_init(ring.x_full(j), 32);
            spmm_staged::mbar_init(ring.x_empty(j), kConsumerWarps);
        }
        spmm_staged::mbar_fence_init();
    }
    __syncthreads();
    if (threadIdx.x >= kConsumers)
        produce(ring);
    else
        consume(ring);
}

// Launch with persistent CTAs: as many per column tile as fit on the
// card at once, at most one per merged trip.
template <int BM, bool MIXED, class Src = FromSlots>
cudaError_t launch(const Params& p, cudaStream_t stream) {
    const size_t smem = Src::smem(p.cap, BM, p.bk);
    auto kernel = gather_kernel<BM, MIXED, Src>;
    // this launch's ring, whatever an earlier launch with another window
    // set
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const int tiles = p.d_pad / spmm::kColTile;
    long long ctas = static_cast<long long>(sms) * per_sm / tiles;
    ctas = ctas < 1 ? 1 : (ctas > p.num_trips ? p.num_trips : ctas);
    kernel<<<dim3(static_cast<unsigned>(ctas), tiles), kThreads, smem,
             stream>>>(p);
    return cudaGetLastError();
}

}  // namespace spmm_ring
