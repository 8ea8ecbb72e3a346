// Sparse 3D convolution over a neighbour table (rulebook), for Hopper, on
// the tensor cores at f32 accuracy (3xTF32).
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
// What bounds it: operations. On FSDv2-Waymo's sparse build only 31% of
// (row, tap) pairs have a neighbour, and f32 products must stay f32-accurate
// (the JAX kernel runs Precision.HIGHEST). The design:
//   * a mask-sorted row schedule (the output-stationary order of spconv
//     2.x, built by sst_tpu_torch/ops/sparse_conv_gemm.py conv_schedule):
//     the output rows are sorted by their K-bit tap mask, tile i computes
//     rows perm[64 i .. 64 i + 63] and only the taps set in tile_mask[i] (the
//     OR of its rows' masks), and writes each row once through perm. Rows
//     that share a mask share a tile, so executed work comes near the useful
//     work; a tile of rows without neighbours writes zeros. No atomics and a
//     fixed order: the same bits in every run;
//   * 3xTF32 on the tensor cores: each operand is split a = hi + lo with
//     hi = a rounded to TF32 as cvt.rna.tf32 rounds, and lo = a - hi
//     (exact in f32; the mma reads the top 19 bits of its f32 pattern),
//     and lo*hi + hi*lo + hi*hi are accumulated by mma.sync.m16n8k8 TF32
//     -> f32 (error ~2^-21 per product). The tensor cores' f32 accumulation does not round to
//     nearest, and its bias grows with the number of accumulations (2.6e-4
//     after the 27 x 512 channels of a merge conv), so each stage's sums
//     start from zero and are added to the f32 accumulators with IEEE adds.
//     Plain TF32 would compute another function; 495 / 3 = 165 TFLOP/s is
//     the f32-accurate tensor-core rate;
//   * each block owns 64 output rows x 64 output channels, 4 warps of 32 x 32
//     (2 x 4 mma tiles each). Per block it loads its rows' neighbour indices
//     for every set tap once (cp.async). Then, per (set tap, 32-channel Cin
//     chunk), it gathers the 64 rows' chunk (16-byte cp.async; src-size 0
//     zero-fills a missing row) and stages W[k, c0:c0+32, n0:n0+64] the same
//     way, into a 2-stage ring: the next stage's gathers overlap this
//     stage's mma. What hides the gathers' latency is blocks in flight: at
//     45 KB of shared memory and at most 128 registers a thread, 4 blocks
//     share an SM (a 3- or 4-stage ring leaves room for 3 or 2 and ran
//     slower on the H100). Shared rows are padded (36 and 72 floats) so the
//     fragment loads are free of bank conflicts. TMA cannot gather
//     arbitrary rows;
//   * widths that are not a multiple of 4 (or unaligned bases) take 4-byte
//     cp.async copies in the same kernel; any K <= 32, Cin, Cout, vin and
//     vout are taken, with the ragged edges masked.
//
// Contract (checked by the Python wrapper sst_tpu_torch/ops/
// sparse_conv_gemm.py): feats [vin, cin] f32, nbr [taps, vout] int32,
// w [taps, cin, cout] f32, perm [vout] int32 (a permutation of the output
// rows), tile_mask [ceil(vout / 64)] int32 (bit k set if a row of the tile
// has a neighbour at tap k) and out [vout, cout] f32, all contiguous on the
// device of the stream; the wrapper's tile rows (TILE_ROWS) equal kRows.
// Launches on the given stream and does not synchronise. Returns cudaGetLastError() after the
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // output rows per tile
constexpr int kCols = 64;      // output channels per block
constexpr int kDepth = 32;     // input channels per stage
constexpr int kStages = 2;
constexpr int kBlocksPerSm = 4;  // bounds the registers at 128 a thread
constexpr int kThreads = 128;  // 4 warps of 32 x 32
constexpr int kMaxTaps = 32;
constexpr int kALd = kDepth + 4;  // a_s row: 36 floats
constexpr int kBLd = kCols + 8;   // b_s row: 72 floats
constexpr int kAStage = kRows * kALd;
constexpr int kBStage = kDepth * kBLd;
constexpr size_t kSmemBytes =
    sizeof(float) * kStages * (kAStage + kBStage) +
    sizeof(int) * (kMaxTaps * kRows + kRows);
static_assert(kSmemBytes <= 48 * 1024,
              "a block's dynamic shared memory above 48 KB needs "
              "cudaFuncAttributeMaxDynamicSharedMemorySize");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// global -> shared copies; src_bytes below the copy size zero-fills the rest
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a = hi + lo: hi is a rounded to TF32, to nearest with ties away from
// zero (cvt.rna.tf32's rounding, as an integer add and mask: the cvt
// instruction issues slower); lo = a - hi is exact in f32 and the mma
// truncates it to TF32. A NaN stays a NaN in lo.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(a, __uint_as_float(hi)));
}

// d += a * b, m16n8k8, TF32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Stage (tap k, channels c0 .. c0 + kDepth) of the tile: the gathered rows
// a_s[row][channel] and W[k, c0 + channel, n0 + col] as b_s[channel][col].
__device__ __forceinline__ void issue_stage(
    float* a_s, float* b_s, const float* __restrict__ feats,
    const float* __restrict__ w, const int* idx, int k, int c0, int n0,
    int vin, int cin, int cout, bool a_vec, bool b_vec, int tid) {
  if (a_vec) {
#pragma unroll
    for (int i = 0; i < kRows * kDepth / 4 / kThreads; ++i) {
      const int q = tid + i * kThreads;
      const int r = q >> 3;
      const int c = c0 + 4 * (q & 7);
      const int src = idx[r];
      const bool ok = src >= 0 && src < vin && c < cin;
      cp_async16(a_s + r * kALd + 4 * (q & 7),
                 ok ? feats + static_cast<long long>(src) * cin + c : feats,
                 ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < kRows * kDepth / kThreads; ++i) {
      const int q = tid + i * kThreads;
      const int r = q >> 5;
      const int c = c0 + (q & 31);
      const int src = idx[r];
      const bool ok = src >= 0 && src < vin && c < cin;
      cp_async4(a_s + r * kALd + (q & 31),
                ok ? feats + static_cast<long long>(src) * cin + c : feats,
                ok ? 4 : 0);
    }
  }
  const float* w_k = w + static_cast<long long>(k) * cin * cout;
  if (b_vec) {
#pragma unroll
    for (int i = 0; i < kDepth * kCols / 4 / kThreads; ++i) {
      const int q = tid + i * kThreads;
      const int cc = q >> 4;
      const int n = n0 + 4 * (q & 15);
      const bool ok = c0 + cc < cin && n < cout;
      cp_async16(b_s + cc * kBLd + 4 * (q & 15),
                 ok ? w_k + static_cast<long long>(c0 + cc) * cout + n : w,
                 ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < kDepth * kCols / kThreads; ++i) {
      const int q = tid + i * kThreads;
      const int cc = q >> 6;
      const int n = n0 + (q & 63);
      const bool ok = c0 + cc < cin && n < cout;
      cp_async4(b_s + cc * kBLd + (q & 63),
                ok ? w_k + static_cast<long long>(c0 + cc) * cout + n : w,
                ok ? 4 : 0);
    }
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
sparse_conv_gemm_kernel(const float* __restrict__ feats,
                        const int* __restrict__ nbr,
                        const float* __restrict__ w,
                        const int* __restrict__ perm,
                        const unsigned* __restrict__ tile_mask,
                        float* __restrict__ out, int vin, int vout, int cin,
                        int cout, int taps, int col_tiles, bool a_vec,
                        bool b_vec) {
  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                        // [kStages][kRows][kALd]
  float* b_s = a_s + kStages * kAStage;     // [kStages][kDepth][kBLd]
  int* idx_s = reinterpret_cast<int*>(b_s + kStages * kBStage);
  int* row_s = idx_s + kMaxTaps * kRows;    // output row of each tile row

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x / col_tiles;
  const int n0 = (blockIdx.x - tile * col_tiles) * kCols;
  const int m0 = tile * kRows;
  const int rows = min(kRows, vout - m0);
  const unsigned mask = tile_mask[tile];

  if (tid < kRows) {
    row_s[tid] = tid < rows ? perm[m0 + tid] : 0;
  }
  __syncthreads();
  // idx_s[k][r] = nbr[k, row_s[r]] for every set tap; -1 past the last row
  for (int i = tid; i < taps * kRows; i += kThreads) {
    const int k = i / kRows;
    const int r = i - k * kRows;
    if ((mask >> k) & 1u) {
      if (r < rows) {
        cp_async4(idx_s + i, nbr + static_cast<long long>(k) * vout + row_s[r],
                  4);
      } else {
        idx_s[i] = -1;
      }
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // the (set tap, Cin chunk) stages in order; the producer's cursor
  const int chunks = (cin + kDepth - 1) / kDepth;
  const int n_iter = __popc(mask) * chunks;
  unsigned rest = mask;
  int pk = __ffs(rest) - 1;
  int pc = 0;
  auto issue = [&](int stage) {
    issue_stage(a_s + stage * kAStage, b_s + stage * kBStage, feats, w,
                idx_s + pk * kRows, pk, pc, n0, vin, cin, cout, a_vec, b_vec,
                tid);
    pc += kDepth;
    if (pc >= cin) {
      pc = 0;
      rest &= rest - 1;
      pk = __ffs(rest) - 1;
    }
  };

  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 1) * 32;  // the warp's rows in the tile
  const int wn = (warp & 1) * 32;   // its columns in the block
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[mi][ni][e] = 0.0f;
      }
    }
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_iter) {
      issue(s);
    }
    cp_async_commit();
  }
  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `it` has landed; stage it - 1 is consumed
    if (it + kStages - 1 < n_iter) {
      issue((it + kStages - 1) % kStages);
    }
    cp_async_commit();

    const float* a = a_s + (it % kStages) * kAStage;
    const float* b = b_s + (it % kStages) * kBStage;
    float part[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          part[mi][ni][e] = 0.0f;
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < kDepth; kk += 8) {
      // A fragments (rows g, g + 8; channels t, t + 4) and B fragments
      // (channels t, t + 4; column g), split into TF32 hi and lo parts
      uint32_t a_hi[2][4], a_lo[2][4], b_hi[4][2], b_lo[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* ar = a + (wm + 16 * mi + g) * kALd + kk + t;
        split_tf32(ar[0], a_hi[mi][0], a_lo[mi][0]);
        split_tf32(ar[8 * kALd], a_hi[mi][1], a_lo[mi][1]);
        split_tf32(ar[4], a_hi[mi][2], a_lo[mi][2]);
        split_tf32(ar[8 * kALd + 4], a_hi[mi][3], a_lo[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float* br = b + (kk + t) * kBLd + wn + 8 * ni + g;
        split_tf32(br[0], b_hi[ni][0], b_lo[ni][0]);
        split_tf32(br[4 * kBLd], b_hi[ni][1], b_lo[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_tf32(part[mi][ni], a_lo[mi], b_hi[ni]);
          mma_tf32(part[mi][ni], a_hi[mi], b_lo[ni]);
          mma_tf32(part[mi][ni], a_hi[mi], b_hi[ni]);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[mi][ni][e] = __fadd_rn(acc[mi][ni][e], part[mi][ni][e]);
        }
      }
    }
  }

  // c0, c1: row g, columns 2t, 2t + 1; c2, c3: row g + 8
  const bool pair = (cout & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wm + 16 * mi + g + 8 * half;
      if (r >= rows) {
        continue;
      }
      float* dst = out + static_cast<long long>(row_s[r]) * cout;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn + 8 * ni + 2 * t;
        const float x = acc[mi][ni][2 * half];
        const float y = acc[mi][ni][2 * half + 1];
        if (pair && n + 1 < cout) {
          *reinterpret_cast<float2*>(dst + n) = make_float2(x, y);
        } else {
          if (n < cout) {
            dst[n] = x;
          }
          if (n + 1 < cout) {
            dst[n + 1] = y;
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" int sst_sparse_conv_gemm_f32(const void* feats, const void* nbr,
                                        const void* w, const void* perm,
                                        const void* tile_mask, void* out,
                                        int vin, int vout, int cin, int cout,
                                        int taps, void* stream) {
  if (vin < 0 || vout <= 0 || cin <= 0 || cout <= 0 || taps <= 0 ||
      taps > kMaxTaps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long tiles = (static_cast<long long>(vout) + kRows - 1) / kRows;
  const long long col_tiles = (static_cast<long long>(cout) + kCols - 1) / kCols;
  if (tiles * col_tiles > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  };
  const bool a_vec = cin % 4 == 0 && aligned(feats);
  const bool b_vec = cout % 4 == 0 && aligned(w);
  sparse_conv_gemm_kernel<<<static_cast<unsigned int>(tiles * col_tiles),
                            kThreads, kSmemBytes,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(feats), static_cast<const int*>(nbr),
      static_cast<const float*>(w), static_cast<const int*>(perm),
      static_cast<const unsigned*>(tile_mask), static_cast<float*>(out), vin,
      vout, cin, cout, taps, static_cast<int>(col_tiles), a_vec, b_vec);
  return static_cast<int>(cudaGetLastError());
}
