// What the fused sparse-attention kernels K5 (attn_fused.cu) and K6
// (attn_fused_staged.cu) share beside their CTA (attn_ring.cuh): the
// column tile, the finite "masked" score, the operands, pick and the bm
// dispatch.  The CTA itself, the order of its fold and its roundings are
// in attn_ring.cuh.
#pragma once

#include <cuda_runtime.h>

namespace attn {

constexpr int kColTile = 128;            // consumer threads, output columns
constexpr float kNeg = -1e30f;           // finite "masked" score

struct Operands {
    const float* q;      // (B*bm, dh_pad) workspace-ordered, scale folded in
    const float* k;      // (n_pad, dh_pad)
    const float* v;      // (n_pad, dv_pad)
    float* y;            // (B*bm, dv_pad)
    int bk, dh_pad, dv_pad;
};

// a[r] for a row r known only at run time (it depends on the thread),
// read with compile-time indices so the array stays in registers
template <int BM>
__device__ __forceinline__ int pick(const int (&a)[BM], int r) {
    int v = a[0];
#pragma unroll
    for (int i = 1; i < BM; ++i)
        if (i == r) v = a[i];
    return v;
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
