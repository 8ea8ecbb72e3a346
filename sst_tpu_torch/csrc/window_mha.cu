// Multi-head attention inside each window of SST's bucketed window tensors,
// for Hopper, on the bf16 tensor cores.
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
// The mask is additive (-1e4, not -inf): padded keys of an occupied window
// are computed, as in the Pallas kernel. Slots past T (T rounded up to the
// 16-row tile) do not exist: their logits are -inf and their v rows zero.
//
// What bounds it: neither bytes nor operations but latency and issue. At
// SST-Waymo's test-time buckets one attention layer reads 3 x 128,000 window
// slots x 128 bf16 channels and writes one such array (131 MB: 0.039 ms at
// 3.35 TB/s) for 5.2 GFLOP of products (0.005 ms at 989 TFLOP/s bf16), in
// windows of 30-144 tokens, half of them empty. The design:
//   * one block of 4 warps per window. The block reads the window's pad row
//     first; a window without a valid slot writes zeros and stops there.
//     Otherwise it stages the window's k and v rows for all heads in dynamic
//     shared memory with 16-byte cp.async copies from the strided [W, T, 3C]
//     column blocks (rows padded by 8 elements, so that ldmatrix is free of
//     bank conflicts): at T = 320, C = 128 that is 170 KB;
//   * the warps take (16-row query tile, head) tasks in turn. A tile whose
//     rows are all padded writes zeros and is not computed. Otherwise the
//     warp loads its q tile straight into an mma A fragment and runs two
//     passes over 16-key chunks. QK^T is mma.sync.m16n8k16 bf16 -> f32 (dh =
//     16 is one k-step; the products are exact in f32); pass 1 takes the row
//     maximum, pass 2 recomputes each chunk's logits (the same mma on the same
//     inputs: the same bits), takes p = expf(l - m) and the f32 row sum of
//     the unrounded p, packs bf16(p) from the accumulator fragment straight
//     into the A fragment of the PV mma (v through ldmatrix.trans), and
//     divides by the sum after AV. Not an online softmax: rescaling would
//     round bf16(p) against a running maximum, another function. Recomputing
//     QK^T instead of holding a T-long logit row keeps registers bounded for
//     every T up to kMaxTokens;
//   * no atomics and a fixed order: two runs give the same bits.
//
// Contract (checked by the Python wrapper): q, k, v are [w, t, c] bf16
// views sharing one row stride and one window stride (elements, multiples
// of 8), with unit channel stride and 16-byte aligned base pointers; pad is
// [w, t] uint8 (nonzero = padded key), contiguous; out is [w, t, c] bf16,
// contiguous; c = nhead * 16; t <= kMaxTokens. Output rows of an all-padded
// window or query tile are zeros. Launches on the given stream (which fixes
// the device) and does not synchronise. Returns cudaGetLastError() after the
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 16;
constexpr int kTile = 16;        // query rows per warp task, keys per chunk
constexpr int kMaxTokens = 320;
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowPad = 8;       // bf16 elements appended to each staged row
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes = 0 writes 16 zero bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a * b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The logits of one 16-key chunk for the warp's 16 query rows: s[j][.] is
// the accumulator fragment of keys n0 + 8j .. n0 + 8j + 7 (c0, c1: row g,
// keys 2t, 2t + 1; c2, c3: row g + 8), scaled and masked in f32.
__device__ __forceinline__ void chunk_logits(float (&s)[2][4],
                                             const uint32_t (&qa)[4],
                                             const __nv_bfloat16* ks, int ld,
                                             int n0, int col, const float* neg,
                                             int lane, float scale) {
  // ldmatrix rows: matrix (lane / 8) = (keys + 8 * (mat / 2), dims
  // 8 * (mat % 2)); registers 0, 1 are the B fragment of keys n0 .. n0 + 7
  const int mat = lane >> 3;
  const __nv_bfloat16* row =
      ks + (n0 + (lane & 7) + 8 * (mat >> 1)) * ld + col + 8 * (mat & 1);
  uint32_t kb[4];
  ldmatrix_x4(kb, row);
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    mma_bf16(s[j], qa, kb[2 * j], kb[2 * j + 1]);
    const float n_lo = neg[n0 + 8 * j + 2 * t];
    const float n_hi = neg[n0 + 8 * j + 2 * t + 1];
    s[j][0] = __fadd_rn(__fmul_rn(s[j][0], scale), n_lo);
    s[j][1] = __fadd_rn(__fmul_rn(s[j][1], scale), n_hi);
    s[j][2] = __fadd_rn(__fmul_rn(s[j][2], scale), n_lo);
    s[j][3] = __fadd_rn(__fmul_rn(s[j][3], scale), n_hi);
  }
}

__global__ void __launch_bounds__(kThreads)
window_mha_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const unsigned char* __restrict__ pad,
                  __nv_bfloat16* __restrict__ out, int t, int c, int nhead,
                  long long row_stride, long long win_stride, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tiles = (t + kTile - 1) / kTile;
  const int tpad = tiles * kTile;
  const int ld = c + kRowPad;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [tpad][ld]
  __nv_bfloat16* vs = ks + tpad * ld;                           // [tpad][ld]
  float* neg = reinterpret_cast<float*>(vs + tpad * ld);        // [tpad]
  int* tile_live = reinterpret_cast<int*>(neg + tpad);          // [tiles]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long w = blockIdx.x;
  const long long base = w * win_stride;
  __nv_bfloat16* out_w = out + w * t * c;

  for (int i = tid; i < tiles; i += kThreads) {
    tile_live[i] = 0;
  }
  __syncthreads();
  int live = 0;
  for (int s = tid; s < tpad; s += kThreads) {
    float n = -INFINITY;  // a slot past t does not exist
    if (s < t) {
      const bool padded = pad[w * t + s] != 0;
      n = __fmul_rn(padded ? 1.0f : 0.0f, -1e4f);
      if (!padded) {
        live = 1;
        tile_live[s / kTile] = 1;
      }
    }
    neg[s] = n;
  }
  if (!__syncthreads_or(live)) {
    // no valid slot: every output row of the window is zero
    uint4* o = reinterpret_cast<uint4*>(out_w);
    const int n = t * c / 8;
    for (int i = tid; i < n; i += kThreads) {
      o[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  // stage k and v: rows past t are zero-filled
  const int row_chunks = c / 8;
  for (int i = tid; i < tpad * row_chunks; i += kThreads) {
    const int r = i / row_chunks;
    const int col = (i - r * row_chunks) * 8;
    const bool ok = r < t;
    const long long off = base + static_cast<long long>(r) * row_stride + col;
    cp_async16(ks + r * ld + col, ok ? k + off : k, ok ? 16 : 0);
    cp_async16(vs + r * ld + col, ok ? v + off : v, ok ? 16 : 0);
  }
  cp_async_wait_all();
  __syncthreads();

  const int g = lane >> 2;
  const int tq = lane & 3;
  const int mat = lane >> 3;
  for (int task = warp; task < tiles * nhead; task += kWarps) {
    const int qt = task / nhead;
    const int h = task - qt * nhead;
    const int q0 = qt * kTile;
    const int col = h * kHeadDim;
    if (!tile_live[qt]) {
      // every query row of the tile is padded: zeros, not computed
      const int r = q0 + (lane >> 1);
      if (r < t) {
        *reinterpret_cast<uint4*>(out_w + static_cast<long long>(r) * c +
                                  col + 8 * (lane & 1)) =
            make_uint4(0u, 0u, 0u, 0u);
      }
      continue;
    }
    // the q tile as an A fragment: rows q0 + g (+ 8), dims 2tq (+ 8)
    uint32_t qa[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + g + 8 * (i & 1);
      qa[i] = r < t ? *reinterpret_cast<const uint32_t*>(
                          q + base + static_cast<long long>(r) * row_stride +
                          col + 2 * tq + 8 * (i >> 1))
                    : 0u;
    }

    // pass 1: the row maxima of rows g and g + 8
    float m_lo = -INFINITY, m_hi = -INFINITY;
    for (int n0 = 0; n0 < tpad; n0 += kTile) {
      float s[2][4];
      chunk_logits(s, qa, ks, ld, n0, col, neg, lane, scale);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        m_lo = fmaxf(m_lo, fmaxf(s[j][0], s[j][1]));
        m_hi = fmaxf(m_hi, fmaxf(s[j][2], s[j][3]));
      }
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, x));
      m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, x));
    }

    // pass 2: p, its row sums, and bf16(p) @ v
    float sum_lo = 0.0f, sum_hi = 0.0f;
    float o[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    for (int n0 = 0; n0 < tpad; n0 += kTile) {
      float s[2][4];
      chunk_logits(s, qa, ks, ld, n0, col, neg, lane, scale);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[j][0] = expf(__fsub_rn(s[j][0], m_lo));
        s[j][1] = expf(__fsub_rn(s[j][1], m_lo));
        s[j][2] = expf(__fsub_rn(s[j][2], m_hi));
        s[j][3] = expf(__fsub_rn(s[j][3], m_hi));
        sum_lo = __fadd_rn(__fadd_rn(sum_lo, s[j][0]), s[j][1]);
        sum_hi = __fadd_rn(__fadd_rn(sum_hi, s[j][2]), s[j][3]);
      }
      // the accumulator fragments are the A fragment of P (16 x 16 keys)
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                              pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]),
                              pack_bf16(s[1][2], s[1][3])};
      // ldmatrix.trans rows: matrix mat = (keys + 8 * (mat % 2), dims
      // 8 * (mat / 2)); registers 0, 1 are the B fragment of dims 0 .. 7
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vs + (n0 + (lane & 7) + 8 * (mat & 1)) * ld +
                                col + 8 * (mat >> 1));
      mma_bf16(o[0], pa, vb[0], vb[1]);
      mma_bf16(o[1], pa, vb[2], vb[3]);
    }
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
      sum_lo = __fadd_rn(sum_lo, __shfl_xor_sync(0xffffffffu, sum_lo, x));
      sum_hi = __fadd_rn(sum_hi, __shfl_xor_sync(0xffffffffu, sum_hi, x));
    }

    // o[j]: c0, c1 row g, dims 8j + 2tq (+1); c2, c3 row g + 8
    const int r_lo = q0 + g;
    const int r_hi = r_lo + 8;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int d = col + 8 * j + 2 * tq;
      if (r_lo < t) {
        *reinterpret_cast<__nv_bfloat162*>(
            out_w + static_cast<long long>(r_lo) * c + d) =
            __floats2bfloat162_rn(__fdiv_rn(o[j][0], sum_lo),
                                  __fdiv_rn(o[j][1], sum_lo));
      }
      if (r_hi < t) {
        *reinterpret_cast<__nv_bfloat162*>(
            out_w + static_cast<long long>(r_hi) * c + d) =
            __floats2bfloat162_rn(__fdiv_rn(o[j][2], sum_hi),
                                  __fdiv_rn(o[j][3], sum_hi));
      }
    }
  }
}

size_t smem_bytes(int t, int c) {
  const size_t tiles = (t + kTile - 1) / kTile;
  const size_t tpad = tiles * kTile;
  return 2 * tpad * (c + kRowPad) * sizeof(__nv_bfloat16) +
         tpad * sizeof(float) + tiles * sizeof(int);
}

}  // namespace

extern "C" int sst_window_mha_bf16(const void* q, const void* k,
                                   const void* v, const void* pad, void* out,
                                   int w, int t, int c, int nhead,
                                   long long row_stride, long long win_stride,
                                   void* stream) {
  const size_t smem = smem_bytes(t, c);
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  };
  if (w <= 0 || t <= 0 || t > kMaxTokens || nhead <= 0 ||
      c != nhead * kHeadDim || row_stride <= 0 || win_stride <= 0 ||
      row_stride % 8 != 0 || win_stride % 8 != 0 || !aligned(q) ||
      !aligned(k) || !aligned(v) || !aligned(out) || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        window_mha_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  const float scale =
      static_cast<float>(1.0 / sqrt(static_cast<double>(kHeadDim)));
  window_mha_kernel<<<w, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const unsigned char*>(pad),
      static_cast<__nv_bfloat16*>(out), t, c, nhead, row_stride, win_stride,
      scale);
  return static_cast<int>(cudaGetLastError());
}
