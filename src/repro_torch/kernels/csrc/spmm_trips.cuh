// Descriptor-trip device code of the one-thread-a-column routes of the
// resident SpMM kernel K1 (spmm_ell_fused.cu) and the pre-fusion BCSR
// micro-oracle K10 (spmm_bcsr.cu), which take widths the gather ring does
// not; their ring routes, K2 and K9 (spmm_bcsr_fused.cu,
// spmm_ell_segment.cu) run on spmm_gather_ring.cuh and take only
// kColTile, zero, store_rows and the bm dispatch here.
//
// Layout: one CTA per (merged trip, 128-column tile); each thread owns
// one output column of the tile and keeps one descriptor's bm row
// accumulators in registers.  A merged trip's mw member descriptors run
// one after another, each with fresh accumulators and its own store, so
// every row reduces in exactly the order of the reference kernels.
//
// The products and sums use __fmul_rn/__fadd_rn, not a fused
// multiply-add: the reference accumulates acc + v*x with two roundings
// (kernels/spmm_ell_fused.py:88-89), and so does the plain PyTorch
// version, which the VPU trips therefore match bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace spmm {

constexpr int kColTile = 128;   // threads per CTA = output columns per CTA

template <int BM>
__device__ __forceinline__ void zero(float (&acc)[BM]) {
#pragma unroll
    for (int r = 0; r < BM; ++r) acc[r] = 0.f;
}

// VPU trip (tag 0): L gather-FMA steps; row r's slot for step nz is
// off + r*L + nz, its column entry coff + r*L + nz.  The cols/vals loads
// are the same address across the CTA (broadcast); the X row load is
// coalesced across the threads of a warp.
template <int BM>
__device__ __forceinline__ void vpu_trips(
        float (&acc)[BM], int off, int coff, int L,
        const int* __restrict__ cols, const float* __restrict__ vals,
        const float* __restrict__ x, int col, int d_pad) {
    zero(acc);
    for (int nz = 0; nz < L; ++nz) {
#pragma unroll
        for (int r = 0; r < BM; ++r) {
            const int k = __ldg(cols + coff + r * L + nz);
            const float v = __ldg(vals + off + r * L + nz);
            const float xv = __ldg(x + static_cast<long long>(k) * d_pad + col);
            acc[r] = __fadd_rn(acc[r], __fmul_rn(v, xv));
        }
    }
}

// MXU trip (tag 1).  Per step k: t = a(bm x bk) · xp(bk) for this
// thread's column, then acc += t — the reference's acc + dot(a, xp).
// Step k's value panel is vals[off + k*bm*bk:], row-major (bm, bk); its
// X panel is the bk rows of block-column cols[coff + k].  Each X value
// is loaded once and reused for all BM rows from registers.
template <int BM>
__device__ __forceinline__ void mxu_trips(
        float (&acc)[BM], int off, int coff, int K, int bk,
        const int* __restrict__ cols, const float* __restrict__ vals,
        const float* __restrict__ x, int col, int d_pad) {
    zero(acc);
    for (int k = 0; k < K; ++k) {
        const int bc = __ldg(cols + coff + k);
        const float* a = vals + off + k * BM * bk;
        const float* xp = x + static_cast<long long>(bc) * bk * d_pad + col;
        float t[BM];
        zero(t);
        for (int c = 0; c < bk; ++c) {
            const float xv = __ldg(xp + static_cast<long long>(c) * d_pad);
#pragma unroll
            for (int r = 0; r < BM; ++r)
                t[r] = __fadd_rn(t[r], __fmul_rn(__ldg(a + r * bk + c), xv));
        }
#pragma unroll
        for (int r = 0; r < BM; ++r) acc[r] = __fadd_rn(acc[r], t[r]);
    }
}

// Every workspace row is written, zero for a descriptor with L == 0,
// so the output needs no initialisation.
template <int BM>
__device__ __forceinline__ void store_rows(
        float* __restrict__ y, long long block, const float (&acc)[BM],
        int col, int d_pad) {
    float* out = y + block * BM * d_pad + col;
#pragma unroll
    for (int r = 0; r < BM; ++r) out[static_cast<long long>(r) * d_pad] = acc[r];
}

}  // namespace spmm

// Instantiates LAUNCH(BM) for the row-block sizes the wrappers accept
// (ops' default is 8); any other bm is refused with
// cudaErrorInvalidValue before a launch.
#define SPMM_DISPATCH_BM(bm, LAUNCH)                  \
    switch (bm) {                                     \
        case 1: LAUNCH(1); break;                     \
        case 2: LAUNCH(2); break;                     \
        case 4: LAUNCH(4); break;                     \
        case 8: LAUNCH(8); break;                     \
        case 16: LAUNCH(16); break;                   \
        default: return cudaErrorInvalidValue;        \
    }
