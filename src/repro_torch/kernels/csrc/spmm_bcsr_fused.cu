// K2: the fused mixed VPU/MXU SpMM, Y_ws = plan · X, in one launch.
//
// Replaces the TPU kernel src/repro/kernels/spmm_bcsr_fused.py ::
// spmm_bcsr_fused (_kernel, resident staging).  Each descriptor is
// tagged: tag 0 runs K1's gather-FMA trips with the column entries at
// coff + r*L + nz; tag 1 runs L block steps, each a (bm x bk) value
// panel times the (bk x 128) X panel of block-column cols[coff + k].
//
// What bounds it on an H100 is bytes.  On a block-structured matrix
// the X panels of neighbouring block-rows overlap, so L2 serves most
// re-reads and the floor is X once, the value panels once and the
// output once over 3.35 TB/s; an MXU step does 2*bm flops per X value
// it loads, far too few for the fp32 rate to be the limit.  The design
// loads each X panel row once per step into registers (bk coalesced
// loads per thread) and reuses it for all bm rows, so X traffic is the
// panel's, not bm times it.  On a 2^20-row banded stencil (one H100
// 80GB HBM3 at 700 W) it still runs at about 5x that floor; the bm*bk
// warp-uniform loads of the value panel per step are the first suspect.
// The block product is plain fp32 FFMA work — the reference computes
// fp32 x fp32 -> fp32 (spmm_bcsr_fused.py:94-97) and Hopper's tensor
// cores have no IEEE fp32 mode; wgmma/TF32 variants come with a
// precision knob in a later change.  The tag branch is per descriptor,
// so it is uniform across the CTA and never diverges a warp.
#include "spmm_trips.cuh"

namespace {

// MXU trip (tag 1).  Per step k: t = a(bm x bk) · xp(bk) for this
// thread's column, then acc += t — the reference's acc + dot(a, xp).
template <int BM>
__device__ __forceinline__ void mxu_trips(
        float (&acc)[BM], int off, int coff, int K, int bk,
        const int* __restrict__ cols, const float* __restrict__ vals,
        const float* __restrict__ x, int col, int d_pad) {
    spmm::zero(acc);
    for (int k = 0; k < K; ++k) {
        const int bc = __ldg(cols + coff + k);
        const float* a = vals + off + k * BM * bk;
        const float* xp = x + static_cast<long long>(bc) * bk * d_pad + col;
        float t[BM];
        spmm::zero(t);
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

template <int BM>
__global__ void __launch_bounds__(spmm::kColTile)
spmm_bcsr_fused_kernel(const int* __restrict__ blk_tag,
                       const int* __restrict__ blk_off,
                       const int* __restrict__ blk_coff,
                       const int* __restrict__ blk_L,
                       const int* __restrict__ cols,
                       const float* __restrict__ vals,
                       const float* __restrict__ x, float* __restrict__ y,
                       int bk, int mw, int d_pad) {
    const int col = blockIdx.y * spmm::kColTile + threadIdx.x;
    if (col >= d_pad) return;
    for (int w = 0; w < mw; ++w) {
        const long long b = static_cast<long long>(blockIdx.x) * mw + w;
        const int off = __ldg(blk_off + b);
        const int coff = __ldg(blk_coff + b);
        const int L = __ldg(blk_L + b);
        float acc[BM];
        if (__ldg(blk_tag + b) == 0)
            spmm::vpu_trips<BM>(acc, off, coff, L, cols, vals, x, col, d_pad);
        else
            mxu_trips<BM>(acc, off, coff, L, bk, cols, vals, x, col, d_pad);
        spmm::store_rows<BM>(y, b, acc, col, d_pad);
    }
}

}  // namespace

// num_trips = num_blocks / mw merged trips; all pointers are device
// pointers, stream is a cudaStream_t.  Returns the launch's error code.
extern "C" int spmm_bcsr_fused_launch(
        const void* blk_tag, const void* blk_off, const void* blk_coff,
        const void* blk_L, const void* cols, const void* vals,
        const void* x, void* y, int num_trips, int bm, int bk, int mw,
        int d_pad, void* stream) {
    const dim3 grid(num_trips, (d_pad + spmm::kColTile - 1) / spmm::kColTile);
    const dim3 block(spmm::kColTile);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LAUNCH(BM)                                                            \
    spmm_bcsr_fused_kernel<BM><<<grid, block, 0, s>>>(                        \
        static_cast<const int*>(blk_tag), static_cast<const int*>(blk_off),   \
        static_cast<const int*>(blk_coff), static_cast<const int*>(blk_L),    \
        static_cast<const int*>(cols), static_cast<const float*>(vals),       \
        static_cast<const float*>(x), static_cast<float*>(y), bk, mw, d_pad)
    SPMM_DISPATCH_BM(bm, LAUNCH)
#undef LAUNCH
    return static_cast<int>(cudaGetLastError());
}
