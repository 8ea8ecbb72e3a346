// Weight gradient of the sparse 3D convolution over a neighbour table, for
// Hopper.
//
// Replaces the TPU kernel sst_tpu/ops/sparse_conv_pallas.py:_dw_kernel. That
// kernel streamed the key-sorted input through VMEM per block of 128 output
// rows, aligned rows with the one-hot "match matmul" of the forward kernel
// (keys carried in f32 lanes) and accumulated every block into one
// VMEM-resident [27 * C_pad, Cout_pad] result across the sequential TPU grid.
// All of that is TPU workaround. Given the neighbour table that the rulebook
// builds (sst_tpu_torch/ops/sparse_conv.py build_conv_plans), this kernel
// computes the same function directly:
//
//   dW[k, c, n] = sum_v feats[nbr[k, v], c] * dout[v, n]
//
// where an index outside [0, vin) reads a zero row (the kernel checks the
// bound itself).
//
// What bounds it: f32 arithmetic on the SIMT cores, the same useful work as
// the forward conv (2 * Cin * Cout FLOP per (row, tap) pair that has a
// neighbour). The design:
//   * the grid runs over (tap k, 64-channel Cin tile, 64-channel Cout tile)
//     and over S splits of the output rows; each block owns one 64 x 64 tile
//     of dW[k] for its split, 256 threads each accumulating a 4 x 4 register
//     tile in f32 FMA, in a fixed order (row by row);
//   * per chunk of 32 output rows the block loads the rows' tap-k neighbour
//     indices; if no row of the chunk has that neighbour (__syncthreads_or)
//     the chunk is skipped; otherwise it gathers the rows' feats[nbr[k, v],
//     c0:c0+64] into shared memory (a missing row reads 0) and stages
//     dout[v, n0:n0+64] beside it;
//   * blocks on different SMs cannot carry a sum across the TPU's sequential
//     grid, so each split writes its partial tile to a workspace
//     [S, K, Cin, Cout], and a second kernel sums the S partials in split
//     order. No float atomics: the result is the same bit for bit in every
//     run. With S = 1 the first kernel writes dW itself;
//   * every element of dW is written (0 for a tap that no row has); any K,
//     Cin, Cout, vin and vout are taken, with the ragged edges masked.
// Left for later: TF32 or bf16 wgmma, a per-tap compacted rulebook (so that
// missing (row, tap) pairs cost nothing), cp.async/TMA double buffering.
//
// Contract (checked by the Python wrapper sst_tpu_torch/ops/
// sparse_conv_dw.py): feats [vin, cin] f32, nbr [taps, vout] int32, dout
// [vout, cout] f32, workspace [splits, taps, cin, cout] f32 (unused when
// splits == 1) and dw [taps, cin, cout] f32, all contiguous on the device of
// the stream; split s covers output rows [s * rows_per_split, (s + 1) *
// rows_per_split), rows_per_split a multiple of 32. Launches on the given
// stream and does not synchronise. Returns cudaGetLastError() after the
// launches.

#include <cuda_runtime.h>

namespace {

constexpr int kTileC = 64;     // input channels per block (rows of the tile)
constexpr int kTileN = 64;     // output channels per block
constexpr int kChunk = 32;     // output rows per shared-memory stage
constexpr int kThreads = 256;  // 16 x 16 threads, a 4 x 4 tile each
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
sparse_conv_dw_kernel(const float* __restrict__ feats,
                      const int* __restrict__ nbr,
                      const float* __restrict__ dout,
                      float* __restrict__ partial, int vin, int vout, int cin,
                      int cout, int taps, int rows_per_split) {
  // gathered input rows a_s[row][channel] and output-gradient rows
  // b_s[row][channel] of one chunk
  __shared__ __align__(16) float a_s[kChunk][kTileC];
  __shared__ __align__(16) float b_s[kChunk][kTileN];
  __shared__ int idx_s[kChunk];

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // output channels n0 + 4*tx .. 4*tx+3
  const int ty = tid >> 4;  // input channels c0 + 4*ty .. 4*ty+3
  const int n_tiles = (cout + kTileN - 1) / kTileN;
  const int c_tiles = (cin + kTileC - 1) / kTileC;
  int t = blockIdx.x;
  const int n0 = (t % n_tiles) * kTileN;
  t /= n_tiles;
  const int c0 = (t % c_tiles) * kTileC;
  const int k = t / c_tiles;
  const int s = blockIdx.y;
  const long long v_begin = static_cast<long long>(s) * rows_per_split;
  const long long v_end =
      v_begin + rows_per_split < vout ? v_begin + rows_per_split : vout;
  const int* nbr_k = nbr + static_cast<long long>(k) * vout;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] = 0.0f;
    }
  }

  for (long long v0 = v_begin; v0 < v_end; v0 += kChunk) {
    int has = 0;
    if (tid < kChunk) {
      const long long v = v0 + tid;
      int idx = -1;
      if (v < v_end) {
        idx = __ldg(nbr_k + v);
        if (idx < 0 || idx >= vin) {
          idx = -1;
        }
      }
      idx_s[tid] = idx;
      has = idx >= 0;
    }
    if (!__syncthreads_or(has)) {
      continue;  // no row of the chunk has this neighbour
    }
    // stage: element e of the 32 x 64 chunk is row e / 64, channel e % 64,
    // so a warp reads 32 consecutive channels of one row
#pragma unroll
    for (int i = 0; i < kChunk * kTileC / kThreads; ++i) {
      const int e = tid + kThreads * i;
      const int r = e / kTileC;
      const int col = e % kTileC;
      const int idx = idx_s[r];
      const int c = c0 + col;
      a_s[r][col] = (idx >= 0 && c < cin)
                        ? __ldg(feats + static_cast<long long>(idx) * cin + c)
                        : 0.0f;
      const long long v = v0 + r;
      const int n = n0 + col;
      b_s[r][col] = (v < v_end && n < cout)
                        ? __ldg(dout + v * cout + n)
                        : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < kChunk; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&a_s[r][4 * ty]);
      const float4 b = *reinterpret_cast<const float4*>(&b_s[r][4 * tx]);
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
    __syncthreads();
  }

  float* out = partial +
               (static_cast<long long>(s) * taps + k) *
                   static_cast<long long>(cin) * cout;
  const int nb = n0 + 4 * tx;
  const bool vec = (cout & 3) == 0 && nb + 3 < cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + 4 * ty + i;
    if (c >= cin) {
      continue;
    }
    float* row = out + static_cast<long long>(c) * cout;
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

// dw[i] = sum over s of partial[s, i], in split order
__global__ void __launch_bounds__(kThreads)
sum_splits_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                  long long n, int splits) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    float sum = 0.0f;
    for (int s = 0; s < splits; ++s) {
      sum += __ldg(partial + s * n + i);
    }
    dw[i] = sum;
  }
}

}  // namespace

extern "C" int sst_sparse_conv_dw_f32(const void* feats, const void* nbr,
                                      const void* dout, void* workspace,
                                      void* dw, int vin, int vout, int cin,
                                      int cout, int taps, int splits,
                                      int rows_per_split, void* stream) {
  if (vin < 0 || vout <= 0 || cin <= 0 || cout <= 0 || taps <= 0 ||
      splits <= 0 || splits > kMaxGridY || rows_per_split <= 0 ||
      rows_per_split % kChunk != 0 ||
      static_cast<long long>(splits) * rows_per_split < vout ||
      (splits > 1 && workspace == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = static_cast<long long>(taps) *
                          ((cin + kTileC - 1) / kTileC) *
                          ((cout + kTileN - 1) / kTileN);
  if (tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* partial = splits > 1 ? static_cast<float*>(workspace)
                              : static_cast<float*>(dw);
  const dim3 grid(static_cast<unsigned int>(tiles),
                  static_cast<unsigned int>(splits));
  sparse_conv_dw_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(feats), static_cast<const int*>(nbr),
      static_cast<const float*>(dout), partial, vin, vout, cin, cout, taps,
      rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) {
    return static_cast<int>(err);
  }
  const long long n = static_cast<long long>(taps) * cin * cout;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) {
    blocks = 132 * 16;  // grid-stride beyond 16 blocks per SM
  }
  sum_splits_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, st>>>(
      partial, static_cast<float*>(dw), n, splits);
  return static_cast<int>(cudaGetLastError());
}
