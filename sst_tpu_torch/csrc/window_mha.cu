// Multi-head attention inside each window of SST's bucketed window tensors,
// for Hopper.
//
// Replaces the TPU kernel sst_tpu/ops/pallas_attention.py:_mha_kernel (a
// Pallas kernel that took blocks of windows through VMEM, one static lane
// slice per head, so that the [W, H, T, T] logits never reached HBM). It
// computes the same function, with the same roundings, per (window, head):
//
//   l[t, s] = f32(q[t] . k[s]) * 1/sqrt(dh) + pad[s] * -1e4   (q, k bf16)
//   m[t]    = max_s l[t, s];   p = exp(l - m) in f32;   sum[t] = sum_s p
//   o[t]    = sum_s bf16(p[t, s]) * v[s]   accumulated in f32
//   out[t]  = bf16(o[t] / sum[t])
//
// The mask is additive (-1e4, not -inf), so an all-padded window stays
// finite; padded query rows are computed like the others and are
// meaningless to the caller.
//
// What bounds it: bytes. At SST-Waymo's test-time buckets one attention
// layer reads 3 x 128,000 window slots x 128 bf16 channels and writes one
// such array (131 MB: 0.039 ms at 3.35 TB/s) for 5.2 GFLOP of products
// (0.005 ms at 989 TFLOP/s bf16). The design keeps every intermediate on
// chip, as the TPU kernel did:
//   * one block per (window, head): the head's K and V rows (T x 16 each,
//     T <= kMaxTokens) are converted to f32 in shared memory once and read
//     by every query row as broadcasts;
//   * one thread per query row keeps its q row and its 16 f32 output sums
//     in registers; pass 1 finds the row maximum, pass 2 recomputes each
//     logit (the same value, bit for bit) and accumulates p, the row sum and
//     bf16(p) * v; nothing of size T x T is stored anywhere;
//   * q, k and v are read through a row stride, so the three column blocks
//     of the windowed [W, T, 3C] qkv buffer need no copies.
// Scalar f32 FMA, not tensor cores: products of bf16 values are exact in
// f32, so the logits and AV sums differ from the TPU kernel's only in
// summation order. Tensor-core mma, several windows per block and skipping
// empty window slots are later work.
//
// Contract (checked by the Python wrapper): q, k, v are [w, t, c] bf16
// views sharing one row stride and one window stride (elements), with unit
// channel stride; pad is [w, t] uint8 (nonzero = padded key), contiguous;
// out is [w, t, c] bf16, contiguous; c = nhead * 16; t <= kMaxTokens.
// Launches on the given stream (which fixes the device) and does not
// synchronise. Returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <climits>

namespace {

constexpr int kHeadDim = 16;
constexpr int kMaxTokens = 320;  // 132 * 320 bytes of shared memory < 48 KB
constexpr int kMaxThreads = 256;

__global__ void __launch_bounds__(kMaxThreads)
window_mha_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const unsigned char* __restrict__ pad,
                  __nv_bfloat16* __restrict__ out, int t, int c, int nhead,
                  long long row_stride, long long win_stride, float scale) {
  extern __shared__ float smem[];
  float* ks = smem;                 // [t][kHeadDim]
  float* vs = ks + t * kHeadDim;    // [t][kHeadDim]
  float* neg = vs + t * kHeadDim;   // [t] additive key mask

  const long long wh = blockIdx.x;
  const int h = static_cast<int>(wh % nhead);
  const long long w = wh / nhead;
  const long long base = w * win_stride + static_cast<long long>(h) * kHeadDim;

  for (int i = threadIdx.x; i < t * kHeadDim; i += blockDim.x) {
    const long long off = base + (i / kHeadDim) * row_stride + i % kHeadDim;
    ks[i] = __bfloat162float(k[off]);
    vs[i] = __bfloat162float(v[off]);
  }
  for (int s = threadIdx.x; s < t; s += blockDim.x) {
    neg[s] = __fmul_rn(pad[w * t + s] ? 1.0f : 0.0f, -1e4f);
  }
  __syncthreads();

  for (int r = threadIdx.x; r < t; r += blockDim.x) {
    const __nv_bfloat16* qp = q + base + r * row_stride;
    float qr[kHeadDim];
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) {
      qr[d] = __bfloat162float(qp[d]);
    }
    // pass 1: the row maximum of the masked logits
    float m = -INFINITY;
    for (int s = 0; s < t; ++s) {
      const float* kr = ks + s * kHeadDim;
      float dot = 0.0f;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) {
        dot = fmaf(qr[d], kr[d], dot);
      }
      m = fmaxf(m, __fadd_rn(__fmul_rn(dot, scale), neg[s]));
    }
    // pass 2: p, its row sum, and bf16(p) * v
    float sum = 0.0f;
    float o[kHeadDim];
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) {
      o[d] = 0.0f;
    }
    for (int s = 0; s < t; ++s) {
      const float* kr = ks + s * kHeadDim;
      const float* vr = vs + s * kHeadDim;
      float dot = 0.0f;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) {
        dot = fmaf(qr[d], kr[d], dot);
      }
      const float l = __fadd_rn(__fmul_rn(dot, scale), neg[s]);
      const float p = expf(__fsub_rn(l, m));
      sum = __fadd_rn(sum, p);
      const float pb = __bfloat162float(__float2bfloat16_rn(p));
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) {
        o[d] = fmaf(pb, vr[d], o[d]);
      }
    }
    __nv_bfloat16* op = out + (w * t + r) * static_cast<long long>(c) +
                        static_cast<long long>(h) * kHeadDim;
#pragma unroll
    for (int d = 0; d < kHeadDim; ++d) {
      op[d] = __float2bfloat16_rn(__fdiv_rn(o[d], sum));
    }
  }
}

}  // namespace

extern "C" int sst_window_mha_bf16(const void* q, const void* k,
                                   const void* v, const void* pad, void* out,
                                   int w, int t, int c, int nhead,
                                   long long row_stride, long long win_stride,
                                   void* stream) {
  if (w <= 0 || t <= 0 || t > kMaxTokens || nhead <= 0 ||
      c != nhead * kHeadDim || row_stride <= 0 || win_stride <= 0 ||
      static_cast<long long>(w) * nhead > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int threads = (t + 31) / 32 * 32;
  if (threads > kMaxThreads) {
    threads = kMaxThreads;
  }
  const size_t smem =
      (2 * static_cast<size_t>(t) * kHeadDim + t) * sizeof(float);
  const float scale =
      static_cast<float>(1.0 / sqrt(static_cast<double>(kHeadDim)));
  window_mha_kernel<<<w * nhead, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const unsigned char*>(pad),
      static_cast<__nv_bfloat16*>(out), t, c, nhead, row_stride, win_stride,
      scale);
  return static_cast<int>(cudaGetLastError());
}
