// Descriptor-trip device code of the resident fused sparse-attention
// kernel K5 (attn_fused.cu): the SDDMM score, the masked online softmax
// and the S·V product of one trip step, with the (acc, m, l) carry of
// each row.  The staged K6 (attn_fused_staged.cu) has its own CTA (a K/V
// ring, scores in one to four lanes) and takes from here only the
// constants, Operands, pick and the bm dispatch; it reproduces the
// roundings of Cta below exactly, so the two agree bit for bit.
//
// Layout.  A CTA of 128 threads serves one 128-column tile of the value
// width dv; each thread owns one output column and keeps the bm row
// accumulators of the current descriptor in registers, as in the SpMM
// kernels.  The score z = q·k reduces over the whole head width dh, not
// over the thread's column, so it is a reduction across threads: the
// descriptor's Q block (bm x dh_pad) is loaded once into shared memory,
// and warp w scores the rows r = w, w + 4, ... of the block, its lanes
// striding over dh (coalesced 128-byte reads of each K row) and a
// butterfly of shuffles summing the lanes.  That warp also carries the
// row's running max m and denominator l (every lane holds the same copy)
// and writes the step's weights p and rescale exp(m - m_new) to shared
// memory; after one __syncthreads every thread folds them into its
// column: acc = acc * rescale + p · V.  The p/rescale buffers alternate
// between two halves by step parity, so one barrier a step suffices.
// Every 128-column tile recomputes the same scores, as every dt tile does
// in the reference's grid; with dv = 128 there is one tile.
//
// Order of the fold (the reference's, kernels/attn_fused.py:65-124): a
// VPU step folds one nonzero per row; an MXU step folds a block of bk
// columns at once (max over the block, one rescale); padding slots carry
// w = 0 and the finite mask value -1e30 keeps the first rescale exp(0).
// The products and sums of the carry use __fmul_rn/__fadd_rn (no FMA
// contraction) and expf is the IEEE-accurate one (no fast math); the dot
// products are fp32 FFMA.  Tensor cores have no IEEE fp32 mode.
#pragma once

#include <cuda_runtime.h>

namespace attn {

constexpr int kColTile = 128;            // threads per CTA, output columns
constexpr int kWarps = kColTile / 32;
constexpr float kNeg = -1e30f;           // finite "masked" score
constexpr int kMaxBk = 32;               // an MXU block's width fits a warp

// the sum over a warp, the same value in every lane (each stage adds
// two lanes' values, and a + b == b + a, so all lanes agree bit for bit)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, s));
    return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
    return v;
}

// floats of shared scratch one CTA needs (kernels/attn_fused.py::
// scratch_bytes computes the same): Q block, two halves of p and of the
// rescale, and the final denominators
__host__ __device__ inline int scratch_floats(int bm, int bk, int dh_pad) {
    return bm * dh_pad + 2 * bm * bk + 2 * bm + bm;
}

struct Operands {
    const float* q;      // (B*bm, dh_pad) workspace-ordered, scale folded in
    const float* k;      // (n_pad, dh_pad)
    const float* v;      // (n_pad, dv_pad)
    float* y;            // (B*bm, dv_pad)
    int bk, dh_pad, dv_pad;
};

// a[r] for a row r known only at run time (it depends on the warp),
// read with compile-time indices so the array stays in registers
template <int BM>
__device__ __forceinline__ int pick(const int (&a)[BM], int r) {
    int v = a[0];
#pragma unroll
    for (int i = 1; i < BM; ++i)
        if (i == r) v = a[i];
    return v;
}

template <int BM>
struct Cta {
    static constexpr int kRows = (BM + kWarps - 1) / kWarps;   // rows per warp

    const Operands o;
    float* q_s;          // BM * dh_pad
    float* p_s;          // 2 halves of BM * bk
    float* r_s;          // 2 halves of BM
    float* l_s;          // BM
    int col, warp, lane, step;
    float acc[BM];
    float m[kRows], l[kRows];

    __device__ Cta(const Operands& ops, float* scratch)
        : o(ops), col(blockIdx.y * kColTile + threadIdx.x),
          warp(threadIdx.x >> 5), lane(threadIdx.x & 31), step(0) {
        q_s = scratch;
        p_s = q_s + BM * o.dh_pad;
        r_s = p_s + 2 * BM * o.bk;
        l_s = r_s + 2 * BM;
    }

    // q_r · k_kr over the head width, in every lane of the warp
    __device__ __forceinline__ float score(int r, long long kr) const {
        const float* qr = q_s + r * o.dh_pad;
        const float* kp = o.k + kr * o.dh_pad;
        float part = 0.f;
        for (int j = lane; j < o.dh_pad; j += 32) part = fmaf(qr[j], __ldg(kp + j), part);
        return warp_sum(part);
    }

    // start descriptor b: its Q block into shared memory, fresh carry
    __device__ __forceinline__ void begin(long long b) {
        const float* qb = o.q + b * BM * o.dh_pad;
        for (int i = threadIdx.x; i < BM * o.dh_pad; i += kColTile) q_s[i] = __ldg(qb + i);
#pragma unroll
        for (int r = 0; r < BM; ++r) acc[r] = 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            m[i] = kNeg;
            l[i] = 0.f;
        }
        step = 0;
        __syncthreads();
    }

    // VPU steps [0, n): row r's weight for step s is vs[vp[r] + s], its
    // K/V row cs[cp[r] + s] (global streams in K5, the ring slot in K6)
    __device__ __forceinline__ void vpu_steps(const float* vs, const int* cs,
                                              const int (&vp)[BM], const int (&cp)[BM],
                                              int n) {
        for (int s = 0; s < n; ++s, ++step) {
            float* ps = p_s + (step & 1) * BM * o.bk;
            float* rs = r_s + (step & 1) * BM;
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
                const int r = warp + i * kWarps;
                if (r >= BM) continue;
                const float w = vs[pick(vp, r) + s];
                const float z = score(r, cs[pick(cp, r) + s]);
                const float m_new = fmaxf(m[i], w > 0.f ? z : kNeg);
                const float rr = expf(__fsub_rn(m[i], m_new));
                const float p = __fmul_rn(w, expf(fminf(__fsub_rn(z, m_new), 0.f)));
                l[i] = __fadd_rn(__fmul_rn(l[i], rr), p);
                m[i] = m_new;
                if (lane == 0) {
                    ps[r] = p;
                    rs[r] = rr;
                }
            }
            __syncthreads();
#pragma unroll
            for (int r = 0; r < BM; ++r) {
                const long long kr = cs[cp[r] + s];
                const float vv = __ldg(o.v + kr * o.dv_pad + col);
                acc[r] = __fadd_rn(__fmul_rn(acc[r], rs[r]), __fmul_rn(ps[r], vv));
            }
        }
    }

    // MXU block steps [0, n): step s's (bm x bk) weight panel at
    // va[s*bm*bk], its block-column cs[s] (K/V rows cs[s]*bk + c)
    __device__ __forceinline__ void mxu_steps(const float* va, const int* cs, int n) {
        const int bk = o.bk;
        for (int s = 0; s < n; ++s, ++step) {
            float* ps = p_s + (step & 1) * BM * bk;
            float* rs = r_s + (step & 1) * BM;
            const long long k0 = static_cast<long long>(cs[s]) * bk;
            const float* a = va + static_cast<long long>(s) * BM * bk;
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
                const int r = warp + i * kWarps;
                if (r >= BM) continue;
                // lane c keeps the score of block column c
                float z = 0.f;
                for (int c = 0; c < bk; ++c) {
                    const float zc = score(r, k0 + c);
                    if (lane == c) z = zc;
                }
                const bool live = lane < bk;
                const float w = live ? a[r * bk + lane] : 0.f;
                const float m_new = fmaxf(m[i], warp_max(live && w > 0.f ? z : kNeg));
                const float rr = expf(__fsub_rn(m[i], m_new));
                const float p = live ? __fmul_rn(w, expf(fminf(__fsub_rn(z, m_new), 0.f)))
                                     : 0.f;
                l[i] = __fadd_rn(__fmul_rn(l[i], rr), warp_sum(p));
                m[i] = m_new;
                if (live) ps[r * bk + lane] = p;
                if (lane == 0) rs[r] = rr;
            }
            __syncthreads();
            const float* vp = o.v + k0 * o.dv_pad + col;
#pragma unroll
            for (int r = 0; r < BM; ++r) {
                const float* pr = ps + r * bk;
                float t = __fmul_rn(pr[0], __ldg(vp));
                for (int c = 1; c < bk; ++c)
                    t = __fadd_rn(t, __fmul_rn(pr[c], __ldg(vp + static_cast<long long>(c) * o.dv_pad)));
                acc[r] = __fadd_rn(__fmul_rn(acc[r], rs[r]), t);
            }
        }
    }

    // acc / l for descriptor b's rows (0 where l == 0), one store each
    __device__ __forceinline__ void finish(long long b) {
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            const int r = warp + i * kWarps;
            if (r < BM && lane == 0) l_s[r] = l[i];
        }
        __syncthreads();
        float* out = o.y + b * BM * o.dv_pad + col;
#pragma unroll
        for (int r = 0; r < BM; ++r) {
            const float d = l_s[r];
            out[static_cast<long long>(r) * o.dv_pad] = __fdiv_rn(acc[r], d > 0.f ? d : 1.f);
        }
    }
};

// Raise the CTA's dynamic shared memory limit when it needs more than
// the default 48 KB.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

}  // namespace attn

// Instantiates LAUNCH(BM) for the row-block sizes the wrappers accept.
#define ATTN_DISPATCH_BM(bm, LAUNCH)                  \
    switch (bm) {                                     \
        case 1: LAUNCH(1); break;                     \
        case 2: LAUNCH(2); break;                     \
        case 4: LAUNCH(4); break;                     \
        case 8: LAUNCH(8); break;                     \
        case 16: LAUNCH(16); break;                   \
        default: return cudaErrorInvalidValue;        \
    }
