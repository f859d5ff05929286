// Descriptor-trip device code shared by the fused SpMM kernels
// (spmm_ell_fused.cu, spmm_bcsr_fused.cu).
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
