// Sparse 3D convolution over a neighbour table (rulebook), for Hopper.
//
// Replaces the TPU kernel sst_tpu/ops/sparse_conv_pallas.py:_conv_kernel.
// That kernel streamed, per block of 128 output rows, 9 (dz, dy) windows of
// the key-sorted input through VMEM, matched rows by zyx key carried in an
// f32 lane, gathered them with a one-hot "match matmul" on the MXU and kept
// the padded [27, Cin, Cout] weights resident in VMEM (6 MiB gate). All of
// that is TPU workaround. Given the neighbour table that the rulebook builds
// (sst_tpu_torch/ops/sparse_conv.py build_conv_plans), this kernel computes
// the same function directly:
//
//   out[v, :] = sum_k sum_c feats[nbr[k, v], c] * W[k, c, :]
//
// where an index outside [0, vin) reads a zero row (the kernel checks the
// bound itself, so it never reads out of range and needs no zero-row concat).
//
// What bounds it: f32 arithmetic on the SIMT cores (no TF32, no bf16). A
// 128 -> 128 conv over all 27 taps is 885 kFLOP per output row; computing
// every tap of every capped row of FSDv2-Waymo's sparse build would be about
// 3.5 TFLOP per frame. The design:
//   * each block owns 64 output rows x 64 output channels; 256 threads each
//     accumulate a 4 x 4 register tile in f32 FMA, in a fixed order (tap,
//     then input channel), so results are deterministic and need no atomics;
//   * per tap the block loads its 64 neighbour indices; if no row of the
//     tile has that neighbour (__syncthreads_or) the tap is skipped, and a
//     warp whose 8 rows all lack it skips the FMAs (it still helps stage);
//   * per 32-channel chunk of Cin the block gathers its rows' chunk into
//     shared memory (a warp reads one row's 32 channels, one coalesced
//     128-byte line; missing rows read 0) and stages W[k, c0:c0+32,
//     n0:n0+64];
//   * every output element is written, 0 for a row without neighbours; any
//     K, Cin, Cout, vin and vout are taken, with the ragged edges masked.
// Left for later: TF32 or bf16 wgmma, a per-tap compacted rulebook (so that
// missing (row, tap) pairs cost nothing), cp.async/TMA double buffering.
//
// Contract (checked by the Python wrapper sst_tpu_torch/ops/
// sparse_conv_gemm.py): feats [vin, cin] f32, nbr [taps, vout] int32,
// w [taps, cin, cout] f32 and out [vout, cout] f32, all contiguous on the
// device of the stream. Launches on the given stream and does not
// synchronise. Returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;      // output rows per block
constexpr int kCols = 64;      // output channels per block
constexpr int kDepth = 32;     // input channels per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, a 4 x 4 tile each
constexpr int kRowStride = kRows + 4;  // keeps float4 reads aligned
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
sparse_conv_gemm_kernel(const float* __restrict__ feats,
                        const int* __restrict__ nbr,
                        const float* __restrict__ w, float* __restrict__ out,
                        int vin, int vout, int cin, int cout, int taps) {
  // gathered input rows, transposed: a_s[channel][row]
  __shared__ __align__(16) float a_s[kDepth][kRowStride];
  // W[k, c0:c0+kDepth, n0:n0+kCols]
  __shared__ __align__(16) float b_s[kDepth][kCols];
  __shared__ int idx_s[kRows];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid & 15;  // output channels n0 + 4*tx .. 4*tx+3
  const int ty = tid >> 4;  // output rows m0 + 4*ty .. 4*ty+3
  const int m0 = blockIdx.x * kRows;
  const int n0 = blockIdx.y * kCols;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] = 0.0f;
    }
  }

  for (int k = 0; k < taps; ++k) {
    int has = 0;
    if (tid < kRows) {
      const int m = m0 + tid;
      int idx = -1;
      if (m < vout) {
        idx = __ldg(nbr + static_cast<long long>(k) * vout + m);
        if (idx < 0 || idx >= vin) {
          idx = -1;
        }
      }
      idx_s[tid] = idx;
      has = idx >= 0;
    }
    if (!__syncthreads_or(has)) {
      continue;  // no row of the tile has this neighbour
    }
    // the 8 rows this warp computes are 8 * warp .. 8 * warp + 7
    const bool warp_has =
        __any_sync(0xffffffffu, lane < 8 && idx_s[8 * warp + lane] >= 0);
    const float* w_k = w + static_cast<long long>(k) * cin * cout;

    for (int c0 = 0; c0 < cin; c0 += kDepth) {
      // gather: warp `warp` loads rows warp, warp + 8, ...; lane = channel
      const int c = c0 + lane;
#pragma unroll
      for (int i = 0; i < kRows / 8; ++i) {
        const int r = warp + 8 * i;
        const int idx = idx_s[r];
        a_s[lane][r] = (idx >= 0 && c < cin)
                           ? __ldg(feats + static_cast<long long>(idx) * cin + c)
                           : 0.0f;
      }
      // weights: thread loads column tid % 64 of rows tid / 64 + 4 * i
      const int col = tid & (kCols - 1);
      const int n = n0 + col;
#pragma unroll
      for (int i = 0; i < kDepth / 4; ++i) {
        const int cc = (tid >> 6) + 4 * i;
        const int ci = c0 + cc;
        b_s[cc][col] = (ci < cin && n < cout)
                           ? __ldg(w_k + static_cast<long long>(ci) * cout + n)
                           : 0.0f;
      }
      __syncthreads();
      if (warp_has) {
#pragma unroll
        for (int kk = 0; kk < kDepth; ++kk) {
          const float4 a = *reinterpret_cast<const float4*>(&a_s[kk][4 * ty]);
          const float4 b = *reinterpret_cast<const float4*>(&b_s[kk][4 * tx]);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
            }
          }
        }
      }
      __syncthreads();
    }
  }

  const int nb = n0 + 4 * tx;
  const bool vec = (cout & 3) == 0 && nb + 3 < cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 4 * ty + i;
    if (m >= vout) {
      continue;
    }
    float* row = out + static_cast<long long>(m) * cout;
    if (vec) {
      *reinterpret_cast<float4*>(row + nb) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (nb + j < cout) {
          row[nb + j] = acc[i][j];
        }
      }
    }
  }
}

}  // namespace

extern "C" int sst_sparse_conv_gemm_f32(const void* feats, const void* nbr,
                                        const void* w, void* out, int vin,
                                        int vout, int cin, int cout, int taps,
                                        void* stream) {
  if (vin < 0 || vout <= 0 || cin <= 0 || cout <= 0 || taps <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long col_tiles = (static_cast<long long>(cout) + kCols - 1) / kCols;
  if (col_tiles > kMaxGridY) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned int>((vout + kRows - 1) / kRows),
                  static_cast<unsigned int>(col_tiles));
  sparse_conv_gemm_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feats), static_cast<const int*>(nbr),
      static_cast<const float*>(w), static_cast<float*>(out), vin, vout, cin,
      cout, taps);
  return static_cast<int>(cudaGetLastError());
}
