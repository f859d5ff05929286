// K7: the SDDMM, out[p] = sum_d dY[rows[p], d] * X[cols[p], d].
//
// Replaces the TPU kernel src/repro/kernels/sddmm.py :: sddmm (_kernel):
// the structure-restricted gradient of SpMM with respect to the nonzero
// values.  The sum over d runs in lane tiles of dt = kernel_lane_tile
// (d_pad); each tile's sum is formed, then added to the pair's total in
// tile order, as the reference's fori_loop does.
//
// What bounds it on an H100 is bytes.  Each pair does 2*d_pad flops on
// 8*d_pad gathered bytes, far below the fp32 rate's balance, and for a
// large X the X row of most pairs misses the 50 MB L2, so the honest
// floor is about one X row per pair over 3.35 TB/s (every operand once
// is the lower bound printed beside it).
//
// The sums.  Lane l of a warp owns the tile's elements l, l + 32, ...
// (below dt), folds its products into one partial with an fmaf chain in
// that order, and the warp adds the 32 partials in a __shfl_xor_sync
// butterfly (16, 8, 4, 2, 1), so every lane holds the tile's sum; the
// pair's total is 0 + the tile sums in tile order.  Every sum below is
// formed from the same two operands at the same point of that tree, so
// the output is bit for bit the one-warp-a-pair kernel it replaced.
//
// The work.  Persistent CTAs (as many as fit on the card, from
// sddmm_ctas_per_sm) of kWarps independent warps walk runs of 32
// consecutive pairs, run r, r + (all warps), ...; each lane keeps one
// pair's total.  A warp's steps are (run, tile, group): a group is the
// kGroup pairs whose X slices fill one stage (4 KB; 8 KB for 512-wide
// tiles) of the warp's own kStages-stage ring in shared memory.  The
// warp copies step i + kStages - 1's X slices with cp.async (16 bytes a
// lane where X and d_pad allow it, else 4) before it reads step i's,
// so kStages - 1 steps of gathers are in flight at any time, across
// group, tile and run boundaries; cp.async.wait_group and __syncwarp
// hand a stage from the copies to the reads and back.  A lane keeps its
// dY elements in registers while consecutive pairs share a row (CSR
// order: one load a row change, not a pair).  Each lane reads its own
// elements of a stage (conflict-free), and the 32 partials of a run's 32
// pairs are added in one transposed butterfly: at level s a lane sends
// one half of its partials to lane l ^ s and adds its partner's partial
// of each pair it keeps, 31 shuffles for 32 pairs where a warp a pair
// spent 160 (the same two partials meet at each level as in the plain
// butterfly, and a sum of two floats does not depend on their order).
// With kGroups = 32 / kGroup steps a tile, the levels 16 down to kGroups
// run on each step's kGroup pairs as the step is read, leaving one
// partial a step; the levels kGroups / 2 down to 1 run on the tile's
// kGroups such partials, and lane l ends with the tile sum of pair (l %
// kGroups) * kGroup + l / kGroups.  A run's 32 totals leave in one
// coalesced store.  Run indices are loaded a run ahead by both the
// copying and the reading side.
#include <cstdint>

#include <cuda_runtime.h>

#include "occupancy.cuh"

namespace {

constexpr int kWarps = 8;               // warps per CTA, each on its own
constexpr int kRun = 32;                // pairs a warp takes at a time
constexpr int kStages = 2;              // X stages a warp
constexpr unsigned kFull = 0xffffffffu;

// Floats of a stage: 4 KB, 8 KB at NJ = 16 (four 512-wide slices, not
// two).  On an H100 two stages ran faster than three or more, larger
// stages below NJ = 16 ran slower, and two slices a step ran the
// 512-wide tiles slower than four.
__host__ __device__ constexpr int stage_floats(int nj) {
    return nj == 16 ? 2048 : 1024;
}

// dynamic shared memory of one CTA of the NJ instance
constexpr int smem_bytes(int nj) {
    return kWarps * kStages * stage_floats(nj) * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// BYTES from global to shared memory: 16 through L2 only (.cg: an X row
// is not read again, and on an H100 this ran the 512-wide tiles faster
// than .ca), 4 cached in L1 as well (.ca, the only form 4 bytes take)
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
    if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                     :: "r"(smem_u32(dst)), "l"(src) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2;"
                     :: "r"(smem_u32(dst)), "l"(src), "n"(BYTES) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// every copy group of this thread but the newest N has landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// The butterfly's levels lane ^ (s * SCALE), s = N/2, ..., 1, on N
// partials a lane: v[i] is this lane's partial of the i-th of N pairs;
// at level s the lanes with bit s * SCALE set keep pairs i + s, the
// others pairs i (i < s), and each adds its partner's partial of the
// pair it keeps.  v[0] ends as the sum of the pair whose index bits are
// this lane's bits s * SCALE.
template <int N, int SCALE>
__device__ __forceinline__ void transposed_levels(float (&v)[N], int lane) {
#pragma unroll
    for (int s = N / 2; s > 0; s >>= 1) {
        const bool upper = (lane & (s * SCALE)) != 0;
#pragma unroll
        for (int i = 0; i < s; ++i) {
            const float send = upper ? v[i] : v[i + s];
            const float keep = upper ? v[i + s] : v[i];
            v[i] = keep + __shfl_xor_sync(kFull, send, s * SCALE);
        }
    }
}

// A walk over the warp's steps (run, tile, group), with the lane's index
// of each run (a row or a column) loaded a run ahead.
struct Steps {
    const int* idx;     // rows or cols
    long long nnz_pad, runs, stride;
    long long run;      // the current run
    int tiles, groups;  // per run, per tile
    int t, g;           // the current tile and group
    int cur, next;      // the lane's index of this run and the next

    __device__ int load(long long r, int lane) const {
        const long long p = r * kRun + lane;
        return r < runs && p < nnz_pad ? __ldg(idx + p) : 0;
    }
    __device__ void start(long long first, int lane) {
        run = first;
        t = g = 0;
        cur = load(run, lane);
        next = load(run + stride, lane);
    }
    __device__ void advance(int lane) {
        if (++g < groups) return;
        g = 0;
        if (++t < tiles) return;
        t = 0;
        run += stride;
        cur = next;
        next = load(run + stride, lane);
    }
};

// NJ = elements a lane holds of a tile at most (dt <= 32 * NJ), one of
// 1, 2, 4, 8, 16; VEC: 16-byte copies (X on a 16-byte boundary, d_pad a
// multiple of 4), else 4-byte ones.
template <int NJ, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
sddmm_kernel(const int* __restrict__ rows, const int* __restrict__ cols,
             const float* __restrict__ dy, const float* __restrict__ x,
             float* __restrict__ out, long long nnz_pad, int d_pad, int dt) {
    constexpr int kSlice = 32 * NJ;     // floats of a pair's slice
    constexpr int kStageFloats = stage_floats(NJ);
    // pairs a step (a stage's worth, at most a run) and steps a tile
    constexpr int kGroup = kStageFloats / kSlice < kRun
                               ? kStageFloats / kSlice : kRun;
    constexpr int kGroups = kRun / kGroup;
    extern __shared__ __align__(16) float ring[];
    const int lane = threadIdx.x % 32;
    float* stages = ring + (threadIdx.x / 32) * kStages * kStageFloats;
    const int have = dt > lane ? (dt - lane + 31) / 32 : 0;
    const long long runs = (nnz_pad + kRun - 1) / kRun;
    const long long stride = static_cast<long long>(gridDim.x) * kWarps;
    const long long first = static_cast<long long>(blockIdx.x) * kWarps
                            + threadIdx.x / 32;
    if (first >= runs) return;          // uniform across the warp
    const int tiles = d_pad / dt;
    const long long steps =
        (runs - first + stride - 1) / stride * tiles * kGroups;

    Steps copy{cols, nnz_pad, runs, stride, 0, tiles, kGroups, 0, 0, 0, 0};
    Steps read{rows, nnz_pad, runs, stride, 0, tiles, kGroups, 0, 0, 0, 0};
    copy.start(first, lane);
    read.start(first, lane);

    // the X slices of copy's current step into stage i, then one group
    auto fetch = [&](long long i) {
        if (i < steps) {
            float* st = stages + (i % kStages) * kStageFloats;
            const int t0 = copy.t * dt;
#pragma unroll
            for (int q = 0; q < kGroup; ++q) {
                const int c = __shfl_sync(kFull, copy.cur,
                                          copy.g * kGroup + q);
                const float* src = x + static_cast<long long>(c) * d_pad + t0;
                float* dst = st + q * kSlice;
                if (VEC) {
                    for (int k = 4 * lane; k < dt; k += 128)
                        cp_async<16>(dst + k, src + k);
                } else {
#pragma unroll
                    for (int j = 0; j < NJ; ++j)
                        if (j < have) cp_async<4>(dst + lane + 32 * j,
                                                  src + lane + 32 * j);
                }
            }
            copy.advance(lane);
        }
        cp_async_commit();
    };

    for (int i = 0; i < kStages - 1; ++i) fetch(i);
    float w[kGroups] = {};              // one partial per step of a tile
    float a[NJ] = {};
    int held = -1;                      // the row whose dY a[] holds
    int held_t = -1;                    // and its tile
    float acc = 0.f;
    for (long long i = 0; i < steps; ++i) {
        fetch(i + kStages - 1);
        cp_async_wait<kStages - 1>();
        __syncwarp();
        const float* st = stages + (i % kStages) * kStageFloats;
        const int t0 = read.t * dt;
        float u[kGroup];
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
            const int r = __shfl_sync(kFull, read.cur, read.g * kGroup + q);
            if (r != held || read.t != held_t) {   // uniform across the warp
                held = r;
                held_t = read.t;
                const float* yr =
                    dy + static_cast<long long>(r) * d_pad + t0 + lane;
#pragma unroll
                for (int j = 0; j < NJ; ++j)
                    a[j] = j < have ? __ldg(yr + 32 * j) : 0.f;
            }
            const float* xs = st + q * kSlice + lane;
            float part = 0.f;
#pragma unroll
            for (int j = 0; j < NJ; ++j)
                if (j < have) part = fmaf(a[j], xs[32 * j], part);
            u[q] = part;
        }
        __syncwarp();                   // the stage is free for a copy
        transposed_levels<kGroup, kGroups>(u, lane);
#pragma unroll
        for (int k = 0; k + 1 < kGroups; ++k) w[k] = w[k + 1];
        w[kGroups - 1] = u[0];          // at the tile's end, w[g] is step g's
        if (read.g + 1 == kGroups) {    // the tile's last step
            transposed_levels<kGroups, 1>(w, lane);
            acc += w[0];
            if (read.t + 1 == tiles) {  // the run's last tile
                const long long p = read.run * kRun + (lane % kGroups) * kGroup
                                    + lane / kGroups;
                if (p < nnz_pad) out[p] = acc;
                acc = 0.f;
            }
        }
        read.advance(lane);
    }
    cp_async_wait<0>();
}

template <int NJ, bool VEC>
cudaError_t launch(const int* rows, const int* cols, const float* dy,
                   const float* x, float* out, long long nnz_pad, int d_pad,
                   int dt, cudaStream_t stream) {
    auto kernel = sddmm_kernel<NJ, VEC>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(NJ));
    if (err != cudaSuccess) return err;
    int dev = 0, sms = 0, per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kWarps * 32, smem_bytes(NJ));
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    const long long runs = (nnz_pad + kRun - 1) / kRun;
    const long long wanted = (runs + kWarps - 1) / kWarps;
    const long long resident = static_cast<long long>(sms) * per_sm;
    const long long ctas = wanted < resident ? wanted : resident;
    kernel<<<static_cast<unsigned>(ctas), kWarps * 32, smem_bytes(NJ),
             stream>>>(rows, cols, dy, x, out, nnz_pad, d_pad, dt);
    return cudaGetLastError();
}

// the instance for a lane tile: NJ = ceil(dt / 32) rounded up to a power
// of two; 0 when dt is outside 1..512
int elements_per_lane(int dt) {
    if (dt < 1 || dt > 512) return 0;
    int nj = 1;
    while (32 * nj < dt) nj *= 2;
    return nj;
}

}  // namespace

// All pointers are device pointers, stream is a cudaStream_t; dt is the
// lane tile (kernel_lane_tile(d_pad), at most 512).  Returns the launch's
// error code.
extern "C" int sddmm_launch(const void* rows, const void* cols,
                            const void* dy, const void* x, void* out,
                            long long nnz_pad, int d_pad, int dt,
                            void* stream) {
    const bool vec = d_pad % 4 == 0
                     && reinterpret_cast<uintptr_t>(x) % 16 == 0;
#define LAUNCH(NJ, VEC)                                                     \
    return static_cast<int>(launch<NJ, VEC>(                                \
        static_cast<const int*>(rows), static_cast<const int*>(cols),       \
        static_cast<const float*>(dy), static_cast<const float*>(x),        \
        static_cast<float*>(out), nnz_pad, d_pad, dt,                       \
        static_cast<cudaStream_t>(stream)))
#define BOTH(NJ)                                                            \
    if (vec) LAUNCH(NJ, true);                                              \
    LAUNCH(NJ, false)
    switch (elements_per_lane(dt)) {
        case 1: BOTH(1);
        case 2: BOTH(2);
        case 4: BOTH(4);
        case 8: BOTH(8);
        case 16: BOTH(16);
        default: return cudaErrorInvalidValue;
    }
#undef BOTH
#undef LAUNCH
}

// CTAs of the 16-byte-copy instance with NJ elements a lane (1, 2, 4, 8
// or 16, the first argument, in the place other kernels take bm) that
// fit on one SM with its ring, as the launch asks the card; the second
// argument is unused.  -1 on a CUDA error.
extern "C" int sddmm_ctas_per_sm(int nj, int smem) {
    (void)smem;
#define QUERY(NJ)                                                          \
    return occupancy::ctas_per_sm(sddmm_kernel<NJ, true>, kWarps * 32,     \
                                  smem_bytes(NJ))
    switch (nj) {
        case 1: QUERY(1);
        case 2: QUERY(2);
        case 4: QUERY(4);
        case 8: QUERY(8);
        case 16: QUERY(16);
        default: return -1;
    }
#undef QUERY
}
