// The warp-specialised CTA of the fused sparse-attention kernels K5
// (attn_fused.cu, resident) and K6 (attn_fused_staged.cu, staged): one
// body, and a descriptor source that says where a trip's weights and
// columns come from, as spmm_gather_ring.cuh has FromSlots/Resident for
// the SpMM kernels.
//
// * Windows (K6): the producer walks spmm_staged.cuh's items (a trip
//   whose windows fit a slot, else chunks of one member) and fills a
//   two-slot ring of weight/column windows with cp.async.bulk, each slot
//   on a full/empty mbarrier pair with a record of its item.
// * Resident<LEAN> (K5): the descriptor tables and the weight and column
//   streams where they lie in global memory, whole merged trips member by
//   member, no window and no chunk; the two slots carry only the item
//   records (a bare arrival each).  The producer copies an MXU step's
//   (bm x bk) weight panel into the step's stage after its K and V rows
//   (4-byte cp.async: a panel starts anywhere in the stream), and the
//   consumers prefetch each VPU row's column and weight streams into L2
//   four groups ahead.  Where the ring does not fit a CTA at K6's stage
//   count, the launch halves the stages; where not even one stage fits
//   (head widths of thousands), LEAN takes Q, K and V and the weights
//   where they lie, with no ring and no Q block in shared memory
//   (resident_geometry).
//
// The work, and what bounds it.  Per nonzero, 2*dh flops of score and
// 2*dv of S·V in fp32 outside the tensor cores against 8 bytes of weight
// and column, so operations; in practice the latency of a step.  The
// carry makes every descriptor a chain (each step's max, rescale and fold
// wait for the step before) and a step's work is a few hundred dependent
// instructions per thread, so the CTA spreads each step's independent
// work over all its threads, cuts what a step waits for, and keeps
// several CTAs' chains on an SM:
//
// * Warp specialisation.  A CTA is four consumer warps (one output
//   column each of a 128-column tile of dv, the descriptor's bm
//   accumulators in registers) and one producer warp.  For every MXU
//   block step the producer gathers the step's bk-row K panel and the V
//   panel's rows of the CTA's column tile into a ring of stages, with
//   16-byte cp.async.ca per lane (spmm_gather_ring.cuh's cp_async16 and
//   cp_async_arrive): a stage is the panel's bk K rows at a stride of
//   dh_pad + 4 floats and as many V rows (and K5's weight panel), on a
//   full/empty mbarrier pair, 32 rows in all (4 stages at bk = 8, 16 at
//   bk = 1).  A VPU step's K and V rows are read in place, through L1, by
//   the consumers: gathered through the ring as well, they cost the
//   producer 16 copies a step and ran the all-VPU longformer plan
//   (pallas_ell) several times slower (PERF.md).
// * Trips handed out one at a time.  The persistent CTAs start on trips
//   0 .. gridDim.x - 1 and take each further trip from a counter
//   (atomicAdd by the producer, which records the item in its slot for
//   the consumers), so the CTAs that walk the mask's long global-row
//   trips take no share of the rest.
// * Scores in few lanes.  A group of M MXU steps spreads its M x bm x bk
//   (step, row, column) pairs over the 128 consumer threads, a group of
//   S VPU steps its S x bm (step, row) pairs; each pair's score z = q·k
//   is computed by T = 1, 2 or 4 neighbouring threads that hold 32 / T
//   of the 32 lane partials of a warp-wide score (lane l: fmaf over j =
//   l, l + 32, ... from 0), and a butterfly's tree (pairs l, l ^ 16,
//   then l ^ 8, ...) runs across those threads by shuffles and then in
//   registers.  Q comes from shared memory (stride dh_pad + 4), K from
//   the stage or, for a VPU step, from global memory; the padded strides
//   put the rows a warp reads at once in distinct banks.
// * The carry.  The lanes of one row reduce across its columns (an MXU
//   step's max, and the sum of its weights in the butterfly's order,
//   with zeros in the lanes past bk: x + 0 = x) and scan across the
//   group's steps (the running max; fmaxf is exact in any order),
//   compute the rescale exp(m - m_new) and the weights p = w·exp(min(z -
//   m_new, 0)), and write them to shared memory; one thread a row then
//   carries the denominator l = l*rr + Σp in step order.
// * One consumer barrier per group.  The four consumer warps meet on a
//   named barrier (bar.sync 1, 128) once per group of steps, and fold:
//   acc = acc*rr + p·v per VPU step (the group's V values loaded before
//   its scores), acc = acc*rr + t with t = p0·v0 + p1·v1 + ... in column
//   order per MXU step.  Each warp then arrives on the stages' empty
//   barriers; the producer never waits for the CTA.
//
// The order of the fold and its roundings (the reference's,
// src/repro/kernels/attn_fused.py:65-124), which K5 and K6 share and
// which the first K5 (one warp a row) fixed: a VPU step folds one
// nonzero per row; an MXU step folds a block of bk columns at once (max
// over the block, one rescale); padding slots carry w = 0 and the finite
// mask value -1e30 keeps the first rescale exp(0).  The products and sums
// of the carry use __fmul_rn/__fadd_rn (no FMA contraction) and expf is
// the IEEE-accurate one (no fast math); the dot products are fp32 FFMA in
// the lane partials above, summed in the butterfly's order.  Tensor cores
// have no IEEE fp32 mode.  The carry of a member lives across its chunks
// (K6) and its rows are normalised (acc / l, 0 where l == 0) and stored
// after the last one, so K5 and K6 give the same bits on every instance.
// dh_pad is a multiple of 32 (whole rows of lane partials); K5's wrapper
// pads a ragged head width with zero columns, which leave every lane
// partial's value as it was.
#pragma once

#include <cstdint>

#include "attn_trips.cuh"
#include "spmm_gather_ring.cuh"

namespace attn_ring {

using spmm_staged::Item;
using spmm_staged::Params;
using spmm_staged::mbar_wait;
using spmm_ring::cp_async16;
using spmm_ring::cp_async4;
using spmm_ring::cp_async_arrive;
using spmm_ring::mbar_arrive;

constexpr int kConsumers = attn::kColTile;     // one output column each
constexpr int kConsumerWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;      // plus the producer warp
constexpr int kWinSlots = 2;                   // window (K6) or trip (K5) slots
constexpr int kKVRows = 32;                    // K/V ring rows: stages x rows
constexpr int kMaxStages = 16;
constexpr int kMaxT = 4;                       // threads per score
constexpr int kVpuPairs = 32;                  // (row, step) pairs a VPU group
constexpr int kMinCtas = 2;                    // CTAs per SM, for the registers
// full and empty barriers of every slot and stage
constexpr int kBarriers = 2 * kWinSlots + 2 * kMaxStages;
constexpr int kItemBytes = 32;                 // a slot's item record
constexpr int kMaxSmem = 232448;               // dynamic shared memory a CTA may use
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ inline int pow2_floor(int v) {
    int p = 1;
    while (2 * p <= v) p *= 2;
    return p;
}

__host__ __device__ inline int pow2_ceil(int v) {
    int p = 1;
    while (p < v) p *= 2;
    return p;
}

__host__ __device__ inline int log2i(int v) {
    int k = 0;
    while ((1 << (k + 1)) <= v) ++k;
    return k;
}

// The ring's geometry (kernels/attn_fused.py::kv_geometry computes K6's,
// resident_geometry K5's).
struct Geo {
    int rows;       // R = bk: K rows (and V rows) a stage
    int qstride;    // floats between K (and Q) rows: dh_pad + 4
    int stage;      // floats a stage, K rows then V rows, padded
    int stages;     // N, a power of two (K5 LEAN: 0)
    int sshift;     // log2 N
    int group;      // S: VPU steps a group, a power of two
    int mgroup;     // M: MXU steps a group, a power of two
    int pw;         // entries a row of the weight and rescale buffers
};

// S, M and pw with a ring of `stages` stages
__host__ __device__ inline void set_groups(Geo& g, int bm, int bk, int stages) {
    // kVpuPairs (row, step) pairs
    int s = kVpuPairs / bm;
    if (s < 1) s = 1;
    if (s > 32) s = 32;
    g.group = pow2_floor(s);
    // one (row, column) pair a thread, the M x G lanes of a row within a
    // warp, and the producer a group ahead
    const int G = pow2_ceil(bk);
    int mg = kConsumers / (bm * G);
    if (mg > 32 / G) mg = 32 / G;
    if (mg > stages / 2) mg = stages / 2;
    g.mgroup = pow2_floor(mg < 1 ? 1 : mg);
    // a row's weights: S VPU steps or M x bk block entries; its
    // rescales: S, or M and then M block sums
    int w = g.group > g.mgroup * bk ? g.group : g.mgroup * bk;
    if (w < 2 * g.mgroup) w = 2 * g.mgroup;
    g.pw = (w + 3) / 4 * 4;
}

// K6's geometry
__host__ __device__ inline Geo geometry(int bm, int bk, int dh_pad) {
    Geo g;
    g.rows = bk;
    g.qstride = dh_pad + 4;
    g.stage = g.rows * (g.qstride + attn::kColTile);
    // a stage starts 4 banks after the one before it
    g.stage += (36 - g.stage % 32) % 32;
    const int n = pow2_floor(kKVRows / g.rows > 0 ? kKVRows / g.rows : 1);
    g.stages = n < 2 ? 2 : (n > kMaxStages ? kMaxStages : n);
    g.sshift = log2i(g.stages);
    set_groups(g, bm, bk, g.stages);
    return g;
}

// threads per score: T in {1, 2, 4}, T x pairs within the consumers and
// T x row_lanes within a warp
__host__ __device__ inline int threads_per_score(int pairs, int row_lanes) {
    int t = 1;
    while (t < kMaxT && 2 * t * pairs <= kConsumers && 2 * t * row_lanes <= 32)
        t *= 2;
    return t;
}

// dynamic shared memory of one K6 CTA (kernels/attn_fused.py::ring_bytes
// computes the same): the barriers, the window slots' item records, the
// two window slots of C + 4 weights and C + 4 columns, the kv stages,
// the Q block at the K rows' stride, two halves of the weight and
// rescale buffers, and the denominators
inline size_t attn_ring_bytes(int cap, int bm, int bk, int dh_pad) {
    const Geo g = geometry(bm, bk, dh_pad);
    return 8u * kBarriers + kWinSlots * kItemBytes
           + 2u * kWinSlots * (static_cast<size_t>(cap) + 4u) * 4u
           + 4u * (static_cast<size_t>(g.stages) * g.stage
                   + static_cast<size_t>(bm) * g.qstride + 4u * bm * g.pw
                   + (bm + 3) / 4 * 4);
}

// dynamic shared memory of one K5 CTA with geometry g
// (kernels/attn_fused.py::resident_ring_bytes computes the same): K6's
// without the window slots, and without the Q block when LEAN
inline size_t resident_bytes(const Geo& g, int bm) {
    return 8u * kBarriers + kWinSlots * kItemBytes
           + 4u * (static_cast<size_t>(g.stages) * g.stage
                   + (g.stages > 0 ? static_cast<size_t>(bm) * g.qstride : 0u)
                   + 4u * bm * g.pw + (bm + 3) / 4 * 4);
}

// K5's geometry (kernels/attn_fused.py::resident_geometry computes the
// same): K6's ring with each stage also holding the step's weight panel,
// its stages halved (down to 1) until the CTA fits; if none fits, LEAN
// (stages = 0): Q rows and K/V panels read in place at a stride of dh_pad,
// the MXU groups bounded as by a 16-stage ring.
inline Geo resident_geometry(int bm, int bk, int dh_pad) {
    Geo g = geometry(bm, bk, dh_pad);
    g.stage = g.rows * (g.qstride + attn::kColTile) + (bm * bk + 3) / 4 * 4;
    g.stage += (36 - g.stage % 32) % 32;
    while (g.stages > 1 && resident_bytes(g, bm) > kMaxSmem) {
        g.stages /= 2;
        g.sshift = log2i(g.stages);
        set_groups(g, bm, bk, g.stages);
    }
    if (resident_bytes(g, bm) > kMaxSmem) {
        g.qstride = dh_pad;
        g.stage = 0;
        g.stages = 0;
        g.sshift = 0;
        set_groups(g, bm, bk, kMaxStages);
    }
    return g;
}

// What both roles see: the walk, the operands, the shared memory.
template <int BM, class Src>
struct Ctx {
    static constexpr int kBM = BM;
    const spmm_staged::Staged<BM, true> walk;
    const attn::Operands o;
    const Geo g;
    uint64_t* bar;
    Item* items;        // the item in each slot, g < 0: no more
    int* next_trip;     // trips handed out past the first gridDim.x
    float* vslot;
    int* cslot;
    float* kv;
    float* q_s;
    float* p_s;
    float* r_s;
    float* l_s;
    int slot;       // entries a window slot: C + 4 (K5: none)

    __device__ uint64_t* slot_full(int i) const { return bar + i % kWinSlots; }
    __device__ uint64_t* slot_empty(int i) const {
        return bar + kWinSlots + i % kWinSlots;
    }
    __device__ float* vs(int i) const { return vslot + (i % kWinSlots) * slot; }
    __device__ int* cs(int i) const { return cslot + (i % kWinSlots) * slot; }
    // use u = q / N of stage q % N: full completes phase u when its rows
    // are in, empty when the four consumer warps are done with them
    __device__ uint64_t* kv_full(uint32_t q) const {
        return bar + 2 * kWinSlots + (q & (g.stages - 1));
    }
    __device__ uint64_t* kv_empty(uint32_t q) const {
        return bar + 2 * kWinSlots + kMaxStages + (q & (g.stages - 1));
    }
    __device__ uint32_t phase(uint32_t q) const { return (q >> g.sshift) & 1; }
    __device__ float* stage(uint32_t q) const {
        return kv + static_cast<size_t>(q & (g.stages - 1)) * g.stage;
    }
};

// Item `it` from slot (vs, cs), member by member: role.begin(b, first
// chunk), then its steps through role.vpu (row r's weight for step s at
// vs[vp[r] + s], its K/V row cs[cp[r] + s]) or role.mxu (step k's
// weight panel at va[k*bm*bk], its block-column cs[k]), then
// role.end(b, last chunk).
template <int BM, class Role>
__device__ void run_item(const spmm_staged::Staged<BM, true>& walk,
                         const Item& it, const float* vs, const int* cs,
                         Role& role) {
    const Params& p = walk.p;
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
            role.begin(b, true);
            if (walk.is_mxu(b)) {
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
    role.begin(b, it.c == 0);
    if (walk.is_mxu(b)) {
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
    role.end(b, it.c + 1 == walk.member_chunks(b));
}

// Descriptor sources (see the top of this file).  Each says which item
// a CTA starts on and takes next, how the producer publishes it, how
// both roles walk it, where a step's entries and an MXU step's weight
// panel are read; Producer and Consumer are the same for both.
//
// Windows (K6): the window slots and the chunked walk.
struct Windows {
    static constexpr bool kLean = false;
    static constexpr bool kPrefetch = false;    // the slots are ahead

    // a slot entry
    template <class T>
    __device__ static T ld(const T* p) { return *p; }

    template <class C>
    __device__ static Item first(const C& cx, int g) {
        return cx.walk.trip_item(g);
    }

    // The producer warp's next item: the member's next chunk, the trip's
    // next member, or the next trip nobody has taken yet.  The trips are
    // handed out one at a time, so a CTA that walks a long trip (the
    // mask's global rows) takes no share of the others.
    template <class C>
    __device__ static Item next(const C& cx, const Item& it) {
        const Params& p = cx.walk.p;
        if (it.w >= 0) {
            const long long b = static_cast<long long>(it.g) * p.mw + it.w;
            if (it.c + 1 < cx.walk.member_chunks(b))
                return Item{it.g, it.w, it.c + 1, 0, 0};
            if (it.w + 1 < p.mw) return Item{it.g, it.w + 1, 0, 0, 0};
        }
        int g = 0;
        if ((threadIdx.x & 31) == 0)
            g = atomicAdd(cx.next_trip + blockIdx.y, 1) + gridDim.x;
        g = __shfl_sync(0xffffffffu, g, 0);
        if (g >= p.num_trips) return Item{-1, 0, 0, 0, 0};
        return cx.walk.trip_item(g);
    }

    // lane 0 of the producer: item `it` into slot i — its record, then
    // its window copies (or, past the last item, a bare arrival)
    template <class C>
    __device__ static void publish(const C& cx, int i, const Item& it) {
        cx.items[i % kWinSlots] = it;
        if (it.g >= 0)
            cx.walk.issue(it, cx.vs(i), cx.cs(i), cx.slot_full(i));
        else
            mbar_arrive(cx.slot_full(i));
    }

    template <class C, class Role>
    __device__ static void run(const C& cx, const Item& it, int i, Role& role) {
        run_item(cx.walk, it, cx.vs(i), cx.cs(i), role);
    }

    // an MXU step's weight: in the slot
    template <int BM, class C>
    __device__ static float weight(const C& cx, const float* va, uint32_t,
                                   int k, int r, int c) {
        const int bk = cx.o.bk;
        return va[static_cast<long long>(k) * BM * bk + r * bk + c];
    }
    template <int BM, class C>
    __device__ static void stage_panel(const C&, float*, const float*, int) {}
};

// Resident (K5): the tables and streams in global memory, whole trips.
template <bool LEAN>
struct Resident {
    static constexpr bool kLean = LEAN;
    // the VPU steps' streams into L2 ahead of their groups: on the
    // all-VPU longformer plan (pallas_ell) 4.81-4.83 ms against
    // 4.93-4.94 without (PERF.md)
    static constexpr bool kPrefetch = true;

    // a stream entry
    template <class T>
    __device__ static T ld(const T* p) { return __ldg(p); }

    template <class C>
    __device__ static Item first(const C&, int g) {
        return Item{g, -1, 0, 0, 0};
    }

    // the next trip nobody has taken yet, whole
    template <class C>
    __device__ static Item next(const C& cx, const Item&) {
        int g = 0;
        if ((threadIdx.x & 31) == 0)
            g = atomicAdd(cx.next_trip + blockIdx.y, 1) + gridDim.x;
        g = __shfl_sync(kFull, g, 0);
        return Item{g < cx.walk.p.num_trips ? g : -1, -1, 0, 0, 0};
    }

    // lane 0 of the producer: the record alone, nothing to copy
    template <class C>
    __device__ static void publish(const C& cx, int i, const Item& it) {
        cx.items[i % kWinSlots] = it;
        mbar_arrive(cx.slot_full(i));
    }

    // trip it.g, member by member, each a whole descriptor (role.vpu/mxu
    // get the streams themselves, row r's first weight at vp[r], its
    // first column entry at cp[r])
    template <class C, class Role>
    __device__ static void run(const C& cx, const Item& it, int, Role& role) {
        constexpr int BM = C::kBM;
        const Params& p = cx.walk.p;
        int vp[BM], cp[BM];
        for (int w = 0; w < p.mw; ++w) {
            const long long b = static_cast<long long>(it.g) * p.mw + w;
            const int off = __ldg(p.off + b);
            const int coff = __ldg(p.coff + b);
            const int L = __ldg(p.L + b);
            role.begin(b, true);
            if (cx.walk.is_mxu(b)) {
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

    // where a stage keeps its step's weight panel: after the K and V rows
    template <class C>
    __device__ static float* panel(const C& cx, float* st) {
        return st + cx.g.rows * (cx.g.qstride + attn::kColTile);
    }
    // an MXU step's weight: in its stage (LEAN: in the stream)
    template <int BM, class C>
    __device__ static float weight(const C& cx, const float* va, uint32_t qk,
                                   int k, int r, int c) {
        const int bk = cx.o.bk;
        if constexpr (LEAN)
            return __ldg(va + static_cast<long long>(k) * BM * bk + r * bk + c);
        else
            return panel(cx, cx.stage(qk))[r * bk + c];
    }
    // 4 bytes a copy: a panel starts anywhere in the stream
    template <int BM, class C>
    __device__ static void stage_panel(const C& cx, float* st, const float* a,
                                       int lane) {
        float* ab = panel(cx, st);
        for (int i = lane; i < BM * cx.o.bk; i += 32) cp_async4(ab + i, a + i);
    }
};

// The producer warp's steps: every lane copies its 16-byte pieces of
// each of the step's K and V rows into the next free stage.
template <int BM, class Src>
struct Producer {
    const Ctx<BM, Src>& cx;
    const float* v;     // V at this tile's first column and this lane's 4
    int lane;
    uint32_t q;         // steps staged so far

    __device__ float* acquire() const {
        mbar_wait(cx.kv_empty(q), cx.phase(q) ^ 1);
        return cx.stage(q);
    }
    __device__ void commit() {
        cp_async_arrive(cx.kv_full(q));
        ++q;
    }
    // K row kr into stage row i, and V row kr's column tile
    __device__ void row(float* st, int i, long long kr) const {
        const int dh_pad = cx.o.dh_pad;
        const float* ks = cx.o.k + kr * dh_pad;
        float* kd = st + i * cx.g.qstride;
        for (int u = 4 * lane; u < dh_pad; u += 128) cp_async16(kd + u, ks + u);
        cp_async16(st + cx.g.rows * cx.g.qstride + i * attn::kColTile + 4 * lane,
                   v + kr * cx.o.dv_pad);
    }
    __device__ void begin(long long, bool) {}
    __device__ void end(long long, bool) {}

    // a VPU step's K and V rows are read in place by the consumers
    __device__ void vpu(const float*, const int*, const int (&)[BM],
                        const int (&)[BM], int) {}

    __device__ void mxu(const float* va, const int* cs, int n) {
        if constexpr (Src::kLean) return;     // K/V read in place too
        const int bk = cx.o.bk;
        for (int k = 0; k < n; ++k) {
            float* st = acquire();
            const long long k0 = static_cast<long long>(Src::ld(cs + k)) * bk;
            for (int c = 0; c < bk; ++c) row(st, c, k0 + c);
            Src::template stage_panel<BM>(cx, st, va + static_cast<long long>(k) * BM * bk,
                                          lane);
            commit();
        }
    }
};

// q · k over dh_pad (a multiple of 32), summed as a warp's butterfly
// sums it: thread t of the T that share the score keeps lanes [t*W, t*W
// + W) of the 32 (W = 32 / T), each an fmaf chain over j = l, l + 32, ...
// from 0; the butterfly's stages 16, ..., W pair them with another
// thread's lanes (the same sum on both sides, as a + b == b + a), the
// stages below W run in registers.  Every one of the T threads returns z.
template <int T, bool GLOBAL_K>
__device__ __forceinline__ float score(const float* q, const float* k,
                                       int dh_pad, int t) {
    constexpr int W = 32 / T;
    float v[W];
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = 0.f;
    const float* qa = q + t * W;
    const float* ka = k + t * W;
    for (int b = 0; b < dh_pad; b += 32) {
#pragma unroll
        for (int u = 0; u < W; u += 4) {
            const float4 a = *reinterpret_cast<const float4*>(qa + b + u);
            const float4 c = GLOBAL_K ? __ldg(reinterpret_cast<const float4*>(ka + b + u))
                                      : *reinterpret_cast<const float4*>(ka + b + u);
            v[u] = fmaf(a.x, c.x, v[u]);
            v[u + 1] = fmaf(a.y, c.y, v[u + 1]);
            v[u + 2] = fmaf(a.z, c.z, v[u + 2]);
            v[u + 3] = fmaf(a.w, c.w, v[u + 3]);
        }
    }
#pragma unroll
    for (int h = 16; h >= W; h >>= 1) {
#pragma unroll
        for (int i = 0; i < W; ++i)
            v[i] = __fadd_rn(v[i], __shfl_xor_sync(kFull, v[i], h / W));
    }
#pragma unroll
    for (int h = W / 2; h > 0; h >>= 1) {
#pragma unroll
        for (int i = 0; i < h; ++i) v[i] = __fadd_rn(v[i], v[i + h]);
    }
    return v[0];
}

template <bool GLOBAL_K = false>
__device__ __forceinline__ float score_t(const float* q, const float* k,
                                         int dh_pad, int t, int T) {
    if (T == 1) return score<1, GLOBAL_K>(q, k, dh_pad, t);
    if (T == 2) return score<2, GLOBAL_K>(q, k, dh_pad, t);
    return score<4, GLOBAL_K>(q, k, dh_pad, t);
}

// a hint: the line at p into L2
__device__ __forceinline__ void prefetch_l2(const void* p) {
    asm volatile("prefetch.global.L2 [%0];" :: "l"(p));
}

// the four consumer warps meet; the producer does not take part
__device__ __forceinline__ void consumer_sync() {
    asm volatile("bar.sync 1, %0;" :: "n"(kConsumers) : "memory");
}

// A consumer thread's place in a score grid, fixed for the launch:
// thread t of the T that score row r against step s (a VPU group) or
// block column c (an MXU step).
struct Place {
    bool any;       // this thread's warp holds a pair of the grid
    int r, s, t;
    int k;          // an MXU group's step
};

// slot i of a grid of `pairs` pairs, `per` a row (powers of two), T
// threads a pair; `cols` pairs a step (MXU: per = M x cols)
__device__ inline Place place(int i, int pairs, int per, int T, int cols) {
    const int slot = i / T;
    const int in_row = slot % per;
    return Place{(i & ~31) / T < pairs, slot / per, in_row % cols, i % T,
                 in_row / cols};
}

// A consumer thread: its output column's bm accumulators, the running
// max of the rows it scores (the same in every lane of a row), and for
// thread r < bm the denominator of row r.
template <int BM, class Src>
struct Consumer {
    static constexpr int kPass = BM * 32 / kConsumers > 1 ? BM * 32 / kConsumers : 1;

    const Ctx<BM, Src>& cx;
    int tid, lane;
    int tv, tm;         // threads a score: VPU groups, MXU steps
    int passes;         // MXU grid passes
    Place pv;           // this thread in a VPU group's grid
    Place pm[kPass];    // ... and in an MXU step's, pass by pass
    uint32_t q;         // stages taken so far
    uint32_t grp;       // groups folded so far (which buffer half)
    float acc[BM];
    float m[kPass];
    float lrow;
    const float* qb;    // LEAN: the descriptor's Q block in global memory

    // row r of the descriptor's Q block
    __device__ const float* qrow(int r) const {
        if constexpr (Src::kLean)
            return qb + r * cx.g.qstride;
        else
            return cx.q_s + r * cx.g.qstride;
    }

    __device__ void begin(long long b, bool first) {
        if (!first) return;
        if constexpr (Src::kLean) {
            qb = cx.o.q + b * BM * cx.o.dh_pad;
        } else {
            // the descriptor's Q block at the K rows' stride
            const int dh4 = cx.o.dh_pad / 4;
            const float4* qb4 = reinterpret_cast<const float4*>(cx.o.q + b * BM * cx.o.dh_pad);
            for (int i = tid; i < BM * dh4; i += kConsumers) {
                const int r = i / dh4, u = i - r * dh4;
                *reinterpret_cast<float4*>(cx.q_s + r * cx.g.qstride + 4 * u) = __ldg(qb4 + i);
            }
        }
#pragma unroll
        for (int r = 0; r < BM; ++r) acc[r] = 0.f;
#pragma unroll
        for (int i = 0; i < kPass; ++i) m[i] = attn::kNeg;
        lrow = 0.f;
        consumer_sync();
    }

    // acc / l for descriptor b's rows (0 where l == 0), one store each
    __device__ void end(long long b, bool last) {
        if (!last) return;
        if (tid < BM) cx.l_s[tid] = lrow;
        consumer_sync();
        float* out = cx.o.y + b * BM * cx.o.dv_pad + blockIdx.y * attn::kColTile + tid;
#pragma unroll
        for (int r = 0; r < BM; ++r) {
            const float d = cx.l_s[r];
            out[static_cast<long long>(r) * cx.o.dv_pad] = __fdiv_rn(acc[r], d > 0.f ? d : 1.f);
        }
    }

    // this warp is done with stages [q, q + n)
    __device__ void release(int n) {
        __syncwarp();
        if (lane == 0)
            for (int j = 0; j < n; ++j) mbar_arrive(cx.kv_empty(q + j));
        q += n;
    }

    // VPU steps [0, n) in groups of S: row r's weight for step s at
    // vs[vp[r] + s], its K/V row cs[cp[r] + s]
    __device__ void vpu(const float* vs, const int* cs, const int (&vp)[BM],
                        const int (&cp)[BM], int n) {
        for (int s0 = 0; s0 < n; s0 += cx.g.group) {
            if constexpr (Src::kPrefetch) {
                // row tid's column and weight entries four groups on
                // into L2, ahead of the groups that read them
                if (tid < BM) {
                    const int ahead = min(s0 + 4 * cx.g.group, n - 1);
                    prefetch_l2(cs + (attn::pick(cp, tid) + ahead));
                    prefetch_l2(vs + (attn::pick(vp, tid) + ahead));
                }
            }
            vpu_group(vs, cs, vp, cp, s0, min(cx.g.group, n - s0));
        }
    }

    // the V values of steps [j0, j0 + 4) of every row for this thread's
    // column (a step past ng repeats the last)
    __device__ void load_v(float (&vv)[BM][4], const int* cs, const int (&cp)[BM],
                           int s0, int j0, int ng) const {
        const float* vg = cx.o.v + blockIdx.y * attn::kColTile + tid;
        const int n4 = ng - j0;
#pragma unroll
        for (int r = 0; r < BM; ++r)
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const int j = j0 + (u < n4 ? u : n4 - 1);
                vv[r][u] = __ldg(vg + static_cast<long long>(Src::ld(cs + (cp[r] + s0 + j)))
                                          * cx.o.dv_pad);
            }
    }

    __device__ void vpu_group(const float* vs, const int* cs, const int (&vp)[BM],
                              const int (&cp)[BM], int s0, int ng) {
        const int S = cx.g.group, T = tv, pw = cx.g.pw;
        float* ps = cx.p_s + (grp & 1) * BM * pw;
        float* rs = cx.r_s + (grp & 1) * BM * pw;
        // the first four steps' V values go in flight before the scores
        float vv[BM][4];
        load_v(vv, cs, cp, s0, 0, ng);
        // thread (r, s, t) scores row r of step s0 + s
        if (pv.any) {
            const int r = pv.r, s = pv.s, t = pv.t;
            const bool live = r < BM && s < ng;
            const int rr = live ? r : 0, ss = live ? s : 0;
            const long long kr = Src::ld(cs + (attn::pick(cp, rr) + s0 + ss));
            const float z = score_t<true>(qrow(rr), cx.o.k + kr * cx.o.dh_pad,
                                          cx.o.dh_pad, t, T);
            const float w = live ? Src::ld(vs + (attn::pick(vp, rr) + s0 + ss)) : 0.f;
            // the running max over the group's steps: the S x T lanes of
            // row r, step s at lanes s*T + t
            const int seg = S * T;
            float zm = (live && w > 0.f) ? z : attn::kNeg;
            for (int d = 1; d < S; d <<= 1) {
                const float y = __shfl_up_sync(kFull, zm, d * T, seg);
                if (s >= d) zm = fmaxf(zm, y);
            }
            const float mn = fmaxf(m[0], zm);
            float mp = __shfl_up_sync(kFull, mn, T, seg);
            if (s == 0) mp = m[0];
            const float rsc = expf(__fsub_rn(mp, mn));
            const float p = __fmul_rn(w, expf(fminf(__fsub_rn(z, mn), 0.f)));
            if (live && t == 0) {
                ps[r * pw + s] = p;
                rs[r * pw + s] = rsc;
            }
            m[0] = __shfl_sync(kFull, mn, (ng - 1) * T, seg);
        }
        consumer_sync();
        // four steps at a time: the V values of all the steps' rows are
        // loaded first (one round trip), then each row's weights and
        // rescales in one 16-byte read each, the steps folded in order
        for (int j0 = 0; j0 < ng; j0 += 4) {
            const int n4 = ng - j0;
            if (j0) load_v(vv, cs, cp, s0, j0, ng);
#pragma unroll
            for (int r = 0; r < BM; ++r) {
                const float4 p4 = *reinterpret_cast<const float4*>(ps + r * pw + j0);
                const float4 r4 = *reinterpret_cast<const float4*>(rs + r * pw + j0);
                acc[r] = __fadd_rn(__fmul_rn(acc[r], r4.x), __fmul_rn(p4.x, vv[r][0]));
                if (n4 > 1)
                    acc[r] = __fadd_rn(__fmul_rn(acc[r], r4.y), __fmul_rn(p4.y, vv[r][1]));
                if (n4 > 2)
                    acc[r] = __fadd_rn(__fmul_rn(acc[r], r4.z), __fmul_rn(p4.z, vv[r][2]));
                if (n4 > 3)
                    acc[r] = __fadd_rn(__fmul_rn(acc[r], r4.w), __fmul_rn(p4.w, vv[r][3]));
            }
        }
        if (tid < BM)
            for (int j = 0; j < ng; ++j)
                lrow = __fadd_rn(__fmul_rn(lrow, rs[tid * pw + j]), ps[tid * pw + j]);
        ++grp;
    }

    // MXU block steps [0, n) in groups of M: step k's (bm x bk) weight
    // panel at va[k*bm*bk] (K5: in stage q + k), its K/V rows in stage
    // q + k (LEAN: those of block-column cs[k], in place)
    __device__ void mxu(const float* va, const int* cs, int n) {
        for (int k0 = 0; k0 < n; k0 += cx.g.mgroup)
            mxu_group(va + static_cast<long long>(k0) * BM * cx.o.bk, cs + k0,
                      min(cx.g.mgroup, n - k0));
    }

    __device__ void mxu_group(const float* va, const int* cs, int ng) {
        const int bk = cx.o.bk, G = pow2_ceil(bk), M = cx.g.mgroup, T = tm;
        const int pw = cx.g.pw;
        float* ps = cx.p_s + (grp & 1) * BM * pw;
        float* rs = cx.r_s + (grp & 1) * BM * pw;
        if constexpr (!Src::kLean)
            for (int k = 0; k < ng; ++k) mbar_wait(cx.kv_full(q + k), cx.phase(q + k));
#pragma unroll
        for (int i = 0; i < kPass; ++i) {
            // thread (r, k, c, t) of pass i scores row r of step k
            // against block column c
            if (i >= passes || !pm[i].any) break;
            const int r = pm[i].r, c = pm[i].s, t = pm[i].t, k = pm[i].k;
            const bool row = r < BM && k < ng;
            const bool live = row && c < bk;
            const int rr = row ? r : 0, kk = row ? k : 0, cc = live ? c : 0;
            const float w = live ? Src::template weight<BM>(cx, va, q + k, k, r, c) : 0.f;
            const float* kp;
            if constexpr (Src::kLean)
                kp = cx.o.k + (static_cast<long long>(Src::ld(cs + kk)) * bk + cc)
                                  * cx.o.dh_pad;
            else
                kp = cx.stage(q + kk) + cc * cx.g.qstride;
            const float z = score_t<Src::kLean>(qrow(rr), kp, cx.o.dh_pad, t, T);
            // a step's G x T lanes: block column c at lanes c*T + t; a
            // row's M steps one after another
            float zm = (live && w > 0.f) ? z : attn::kNeg;
            for (int d = G / 2; d > 0; d >>= 1)
                zm = fmaxf(zm, __shfl_xor_sync(kFull, zm, d * T));
            // the running max over the group's steps
            const int seg = M * G * T;
            for (int d = 1; d < M; d <<= 1) {
                const float y = __shfl_up_sync(kFull, zm, d * G * T, seg);
                if (k >= d) zm = fmaxf(zm, y);
            }
            const float mn = fmaxf(m[i], zm);
            float mp = __shfl_up_sync(kFull, mn, G * T, seg);
            if (k == 0) mp = m[i];
            const float rsc = expf(__fsub_rn(mp, mn));
            const float p = live ? __fmul_rn(w, expf(fminf(__fsub_rn(z, mn), 0.f))) : 0.f;
            // a warp sum over 32 lanes, zero past bk: the stages that
            // pair a lane below G with one above add +0
            float sum = G < 32 ? __fadd_rn(p, 0.f) : p;
            for (int d = G / 2; d > 0; d >>= 1)
                sum = __fadd_rn(sum, __shfl_xor_sync(kFull, sum, d * T));
            m[i] = __shfl_sync(kFull, mn, (ng - 1) * G * T, seg);
            if (live && t == 0) ps[r * pw + k * bk + c] = p;
            if (row && c == 0 && t == 0) {
                rs[r * pw + k] = rsc;
                rs[r * pw + M + k] = sum;
            }
        }
        consumer_sync();
        // V row c of the step at vr[c * vstride]
        const int vstride = Src::kLean ? cx.o.dv_pad : attn::kColTile;
        for (int k = 0; k < ng; ++k) {
            const float* vr;
            if constexpr (Src::kLean)
                vr = cx.o.v + static_cast<long long>(Src::ld(cs + k)) * bk * cx.o.dv_pad
                     + blockIdx.y * attn::kColTile + tid;
            else
                vr = cx.stage(q + k) + cx.g.rows * cx.g.qstride + tid;
            const float* pk = ps + k * bk;
            float tr[BM];
            if (bk % 4 == 0) {
                // four block columns at a time: each row's weights in
                // one 16-byte read, t summed in column order
                for (int c = 0; c < bk; c += 4) {
                    const float v0 = vr[c * vstride];
                    const float v1 = vr[(c + 1) * vstride];
                    const float v2 = vr[(c + 2) * vstride];
                    const float v3 = vr[(c + 3) * vstride];
#pragma unroll
                    for (int r = 0; r < BM; ++r) {
                        const float4 p4 = *reinterpret_cast<const float4*>(pk + r * pw + c);
                        const float pv0 = __fmul_rn(p4.x, v0);
                        float t = c == 0 ? pv0 : __fadd_rn(tr[r], pv0);
                        t = __fadd_rn(t, __fmul_rn(p4.y, v1));
                        t = __fadd_rn(t, __fmul_rn(p4.z, v2));
                        tr[r] = __fadd_rn(t, __fmul_rn(p4.w, v3));
                    }
                }
            } else {
                for (int c = 0; c < bk; ++c) {
                    const float vc = vr[c * vstride];
#pragma unroll
                    for (int r = 0; r < BM; ++r) {
                        const float pv0 = __fmul_rn(pk[r * pw + c], vc);
                        tr[r] = c == 0 ? pv0 : __fadd_rn(tr[r], pv0);
                    }
                }
            }
#pragma unroll
            for (int r = 0; r < BM; ++r)
                acc[r] = __fadd_rn(__fmul_rn(acc[r], rs[r * pw + k]), tr[r]);
        }
        if (tid < BM)
            for (int k = 0; k < ng; ++k)
                lrow = __fadd_rn(__fmul_rn(lrow, rs[tid * pw + k]), rs[tid * pw + M + k]);
        if constexpr (!Src::kLean) release(ng);
        ++grp;
    }
};

template <int BM, class Src>
__device__ void produce(const Ctx<BM, Src>& cx) {
    const int lane = threadIdx.x & 31;
    Producer<BM, Src> role{cx, cx.o.v + blockIdx.y * attn::kColTile + 4 * lane, lane, 0u};
    Item it = Src::first(cx, blockIdx.x);
    if (lane == 0) Src::publish(cx, 0, it);
    int i = 0;
    for (;; ++i) {
        // item i + 1 (or the end) goes in flight before item i's K/V rows
        const Item nxt = Src::next(cx, it);
        mbar_wait(cx.slot_empty(i + 1), (((i + 1) / kWinSlots) & 1) ^ 1);
        if (lane == 0) Src::publish(cx, i + 1, nxt);
        mbar_wait(cx.slot_full(i), (i / kWinSlots) & 1);
        Src::run(cx, it, i, role);
        if (nxt.g < 0) break;
        it = nxt;
    }
    // leave once the consumers have finished the last item, so that no
    // copy of this warp is in flight when it exits
    mbar_wait(cx.slot_empty(i), (i / kWinSlots) & 1);
}

template <int BM, class Src>
__device__ void consume(const Ctx<BM, Src>& cx) {
    const int tid = threadIdx.x;
    const int S = cx.g.group, G = pow2_ceil(cx.o.bk), M = cx.g.mgroup;
    Consumer<BM, Src> role{cx, tid, tid & 31};
    role.tv = threads_per_score(BM * S, S);
    role.tm = threads_per_score(BM * M * G, M * G);
    role.passes = (BM * M * G * role.tm + kConsumers - 1) / kConsumers;
    role.pv = place(tid, BM * S, S, role.tv, S);
#pragma unroll
    for (int i = 0; i < Consumer<BM, Src>::kPass; ++i)
        role.pm[i] = place(tid + i * kConsumers, BM * M * G, M * G, role.tm, G);
    role.q = 0u;
    role.grp = 0u;
    for (int i = 0;; ++i) {
        mbar_wait(cx.slot_full(i), (i / kWinSlots) & 1);
        const Item it = cx.items[i % kWinSlots];
        if (it.g < 0) break;
        Src::run(cx, it, i, role);
        __syncwarp();
        if ((tid & 31) == 0) mbar_arrive(cx.slot_empty(i));
    }
}

// The CTA: its barriers, then the producer warp and the consumer warps.
template <int BM, class Src>
__device__ void run_cta(const Ctx<BM, Src>& cx) {
    if (threadIdx.x == 0) {
        for (int k = 0; k < kWinSlots; ++k) {
            spmm_staged::mbar_init(cx.slot_full(k), 1);
            spmm_staged::mbar_init(cx.slot_empty(k), kConsumerWarps);
        }
        for (int j = 0; j < cx.g.stages; ++j) {
            spmm_staged::mbar_init(cx.kv_full(j), 32);
            spmm_staged::mbar_init(cx.kv_empty(j), kConsumerWarps);
        }
        spmm_staged::mbar_fence_init();
    }
    __syncthreads();
    if (threadIdx.x >= kConsumers)
        produce(cx);
    else
        consume(cx);
}

// Launch `kernel` with persistent CTAs: as many per column tile as fit on
// the card at once, at most one per merged trip.
template <class Kernel, class... Args>
cudaError_t launch(Kernel kernel, size_t smem, int num_trips, int tiles,
                   cudaStream_t stream, Args... args) {
    // this launch's shared memory, whatever an earlier launch set
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    long long ctas = static_cast<long long>(sms) * per_sm / tiles;
    ctas = ctas < 1 ? 1 : (ctas > num_trips ? num_trips : ctas);
    kernel<<<dim3(static_cast<unsigned>(ctas), tiles), kThreads, smem, stream>>>(args...);
    return cudaGetLastError();
}

}  // namespace attn_ring
