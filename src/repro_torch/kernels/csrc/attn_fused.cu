// K5: the fused sparse-attention sandwich, Y_ws = softmax(mask ⊙ Q·Kᵀ)·V,
// in one launch over the descriptor stream (resident operands).
//
// Replaces the TPU kernel src/repro/kernels/attn_fused.py :: attn_fused
// (_kernel, _softmax_trip).  Per descriptor: VPU trips (tag 0) score one
// K row per block row per step and fold it into the running softmax;
// MXU trips (tag 1) score a (bm x bk) block against the K panel of
// block-column cols[coff + k], fold it with one rescale per block step,
// and add the (bm x bk)·(bk x 128) product with the V panel.  The output
// is acc / l, zero for a row whose weights are all zero.
//
// What bounds it on an H100: operations.  Each nonzero costs 2*dh flops
// of score and 2*dv of S·V in fp32 outside the tensor cores (67 TFLOP/s),
// while its bytes are a 4-byte weight and a 4-byte column; Q, K, V and
// the output are read or written once.  The design (attn_trips.cuh) keeps
// the descriptor's Q block in shared memory, has each warp score its own
// rows with lanes striding over dh and a shuffle butterfly, and has every
// thread fold the weights into its own output column; K and V rows come
// from device memory through L1/L2, where the window mask's neighbouring
// rows reuse them.  One CTA per (merged trip, 128-column tile); a merged
// trip's members run one after another, each with its own carry.
#include "attn_trips.cuh"
#include "occupancy.cuh"

namespace {

template <int BM>
__global__ void __launch_bounds__(attn::kColTile)
attn_fused_kernel(const int* __restrict__ blk_tag, const int* __restrict__ blk_off,
                  const int* __restrict__ blk_coff, const int* __restrict__ blk_L,
                  const int* __restrict__ cols, const float* __restrict__ vals,
                  const attn::Operands o, int mw) {
    extern __shared__ __align__(16) float scratch[];
    attn::Cta<BM> cta(o, scratch);
    for (int w = 0; w < mw; ++w) {
        const long long b = static_cast<long long>(blockIdx.x) * mw + w;
        const int off = __ldg(blk_off + b);
        const int coff = __ldg(blk_coff + b);
        const int L = __ldg(blk_L + b);
        cta.begin(b);
        if (__ldg(blk_tag + b) == 0) {
            int vp[BM], cp[BM];
#pragma unroll
            for (int r = 0; r < BM; ++r) {
                vp[r] = off + r * L;
                cp[r] = coff + r * L;
            }
            cta.vpu_steps(vals, cols, vp, cp, L);
        } else {
            cta.mxu_steps(vals + off, cols + coff, L);
        }
        cta.finish(b);
    }
}

}  // namespace

// num_trips = num_blocks / mw merged trips; all pointers are device
// pointers, stream is a cudaStream_t; dv_pad is a multiple of 128.
// Returns the launch's error code.
extern "C" int attn_fused_launch(
        const void* blk_tag, const void* blk_off, const void* blk_coff,
        const void* blk_L, const void* cols, const void* vals, const void* q,
        const void* k, const void* v, void* y, int num_trips, int bm, int bk,
        int mw, int dh_pad, int dv_pad, void* stream) {
    const attn::Operands o{static_cast<const float*>(q), static_cast<const float*>(k),
                           static_cast<const float*>(v), static_cast<float*>(y), bk,
                           dh_pad, dv_pad};
    const dim3 grid(num_trips, dv_pad / attn::kColTile);
    const size_t smem = static_cast<size_t>(attn::scratch_floats(bm, bk, dh_pad)) * 4u;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
#define LAUNCH(BM)                                                            \
    if ((err = attn::allow_smem(attn_fused_kernel<BM>, smem)) != cudaSuccess) \
        return static_cast<int>(err);                                         \
    attn_fused_kernel<BM><<<grid, attn::kColTile, smem, s>>>(                 \
        static_cast<const int*>(blk_tag), static_cast<const int*>(blk_off),   \
        static_cast<const int*>(blk_coff), static_cast<const int*>(blk_L),    \
        static_cast<const int*>(cols), static_cast<const float*>(vals), o, mw)
    ATTN_DISPATCH_BM(bm, LAUNCH)
#undef LAUNCH
    return static_cast<int>(cudaGetLastError());
}

// CTAs of the bm instance that fit on one SM with `smem` bytes of
// dynamic shared memory, as the card reports it; -1 on a CUDA error.
extern "C" int attn_fused_ctas_per_sm(int bm, int smem) {
#define QUERY(BM) \
    return occupancy::ctas_per_sm(attn_fused_kernel<BM>, attn::kColTile, smem)
    ATTN_DISPATCH_BM(bm, QUERY)
#undef QUERY
}
