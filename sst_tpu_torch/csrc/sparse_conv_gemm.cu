// Sparse 3D convolution over a neighbour table (rulebook), for Hopper, on
// the tensor cores: f32 at f32 accuracy (3xTF32), and a bf16 route.
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
// The bf16 route (sst_sparse_conv_gemm_bf16) computes the function of the
// TPU kernel's bf16 path: bf16 feats and weights, each product exact in f32,
// sums in f32 over every tap and channel, and the result rounded to bf16
// once, to nearest even. It is the same kernel template over bf16 elements
// (Route<__nv_bfloat16>): the tile schedule, the tile shape and the 2-stage
// cp.async ring are shared, and only a stage differs:
//   * the stage holds 32 bf16 channels (a 16-byte copy moves 8 of them),
//     rows padded to 40 and 72 bf16 so fragment loads are free of bank
//     conflicts; channels past Cin read zeros, which pads Cin to the mma's
//     k of 16 (CTRL's and SECOND's 4-6 input channels take one zero-padded
//     stage per tap);
//   * one mma.sync.m16n8k16 bf16 -> f32 per fragment, no hi/lo split. What
//     bounds it is still operations, now against the bf16 tensor rate
//     (989 TFLOP/s), six times the 3xTF32 route's;
//   * each stage's sums start from zero and are added to the f32
//     accumulators with IEEE adds, as in the f32 route;
//   * widths that are not a multiple of 8 (or unaligned bases) are staged
//     by plain loads and stores in the same ring, in place of cp.async.
//
// Contract (checked by the Python wrapper sst_tpu_torch/ops/
// sparse_conv_gemm.py): feats [vin, cin], nbr [taps, vout] int32,
// w [taps, cin, cout], perm [vout] int32 (a permutation of the output
// rows), tile_mask [ceil(vout / 64)] int32 (bit k set if a row of the tile
// has a neighbour at tap k) and out [vout, cout], feats, w and out all f32
// (sst_sparse_conv_gemm_f32) or all bf16 (sst_sparse_conv_gemm_bf16), all
// contiguous on the device of the stream; the wrapper's tile rows
// (TILE_ROWS) equal kRows. Launches on the given stream and does not
// synchronise. Returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
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
constexpr int kBLd = kCols + 8;  // b_s row: 72 elements
constexpr int kBStage = kDepth * kBLd;

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

// two bf16 values as one 32-bit mma operand, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// d += a * b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// What differs between the two routes: the gathered rows' padding, the
// elements a 16-byte copy moves, how a ragged element is staged, the
// products of one stage (A the gathered rows a_s[row][channel], B the
// weights b_s[channel][col]) and the stores of the result.
template <typename E>
struct Route;

template <>
struct Route<float> {
  static constexpr int kVec = 4;
  static constexpr int kALd = kDepth + 4;  // a_s row: 36 floats
  // a 4-byte cp.async; zero-filled where !ok
  __device__ static void stage_one(float* dst, const float* src,
                                   const float* base, bool ok) {
    cp_async4(dst, ok ? src : base, ok ? 4 : 0);
  }
  // 3xTF32 over m16n8k8: A fragments (rows g, g + 8; channels t, t + 4)
  // and B fragments (channels t, t + 4; column g), split into TF32 hi and
  // lo parts
  __device__ static void stage_mma(float (&part)[2][4][4], const float* a,
                                   const float* b, int wm, int wn, int g,
                                   int t) {
#pragma unroll
    for (int kk = 0; kk < kDepth; kk += 8) {
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
  }
  __device__ static void store_pair(float* dst, float x, float y) {
    *reinterpret_cast<float2*>(dst) = make_float2(x, y);
  }
  __device__ static void store_one(float* dst, float x) { *dst = x; }
};

template <>
struct Route<__nv_bfloat16> {
  static constexpr int kVec = 8;
  static constexpr int kALd = kDepth + 8;  // a_s row: 40 bf16 (80 bytes)
  // a plain load and store (cp.async moves 4 bytes or more); 0 where !ok
  __device__ static void stage_one(__nv_bfloat16* dst,
                                   const __nv_bfloat16* src,
                                   const __nv_bfloat16*, bool ok) {
    *dst = ok ? *src : __float2bfloat16(0.0f);
  }
  // one bf16 product over m16n8k16: A fragments (rows g, g + 8; channel
  // pairs 2t and 2t + 8, one 32-bit load each), B fragments (channel pairs
  // 2t and 2t + 8; column g, packed from two 16-bit loads)
  __device__ static void stage_mma(float (&part)[2][4][4],
                                   const __nv_bfloat16* a,
                                   const __nv_bfloat16* b, int wm, int wn,
                                   int g, int t) {
#pragma unroll
    for (int kk = 0; kk < kDepth; kk += 16) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* ar = a + (wm + 16 * mi + g) * kALd + kk + 2 * t;
        af[mi][0] = *reinterpret_cast<const uint32_t*>(ar);
        af[mi][1] = *reinterpret_cast<const uint32_t*>(ar + 8 * kALd);
        af[mi][2] = *reinterpret_cast<const uint32_t*>(ar + 8);
        af[mi][3] = *reinterpret_cast<const uint32_t*>(ar + 8 * kALd + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const __nv_bfloat16* br = b + (kk + 2 * t) * kBLd + wn + 8 * ni + g;
        bf[ni][0] = pack_bf16(br[0], br[kBLd]);
        bf[ni][1] = pack_bf16(br[8 * kBLd], br[9 * kBLd]);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_bf16(part[mi][ni], af[mi], bf[ni]);
        }
      }
    }
  }
  // one rounding to bf16, to nearest even
  __device__ static void store_pair(__nv_bfloat16* dst, float x, float y) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
  }
  __device__ static void store_one(__nv_bfloat16* dst, float x) {
    *dst = __float2bfloat16_rn(x);
  }
};

template <typename E>
constexpr size_t smem_bytes() {
  return sizeof(E) * kStages * (kRows * Route<E>::kALd + kBStage) +
         sizeof(int) * (kMaxTaps * kRows + kRows);
}
static_assert(smem_bytes<float>() <= 48 * 1024 &&
                  smem_bytes<__nv_bfloat16>() <= 48 * 1024,
              "a block's dynamic shared memory above 48 KB needs "
              "cudaFuncAttributeMaxDynamicSharedMemorySize");

// Stage (tap k, channels c0 .. c0 + kDepth) of the tile: the gathered rows
// a_s[row][channel] and W[k, c0 + channel, n0 + col] as b_s[channel][col].
template <typename E>
__device__ __forceinline__ void issue_stage(
    E* a_s, E* b_s, const E* __restrict__ feats, const E* __restrict__ w,
    const int* idx, int k, int c0, int n0, int vin, int cin, int cout,
    bool a_vec, bool b_vec, int tid) {
  constexpr int kVec = Route<E>::kVec;
  constexpr int kALd = Route<E>::kALd;
  constexpr int kALanes = kDepth / kVec;  // 16-byte copies per a_s row
  constexpr int kBLanes = kCols / kVec;   // and per b_s row
  if (a_vec) {
#pragma unroll
    for (int i = 0; i < kRows * kALanes / kThreads; ++i) {
      const int q = tid + i * kThreads;
      const int r = q / kALanes;
      const int cc = kVec * (q % kALanes);
      const int c = c0 + cc;
      const int src = idx[r];
      const bool ok = src >= 0 && src < vin && c < cin;
      cp_async16(a_s + r * kALd + cc,
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
      Route<E>::stage_one(a_s + r * kALd + (q & 31),
                          feats + static_cast<long long>(src) * cin + c,
                          feats, ok);
    }
  }
  const E* w_k = w + static_cast<long long>(k) * cin * cout;
  if (b_vec) {
#pragma unroll
    for (int i = 0; i < kDepth * kBLanes / kThreads; ++i) {
      const int q = tid + i * kThreads;
      const int cc = q / kBLanes;
      const int nn = kVec * (q % kBLanes);
      const int n = n0 + nn;
      const bool ok = c0 + cc < cin && n < cout;
      cp_async16(b_s + cc * kBLd + nn,
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
      Route<E>::stage_one(b_s + cc * kBLd + (q & 63),
                          w_k + static_cast<long long>(c0 + cc) * cout + n,
                          w, ok);
    }
  }
}

template <typename E>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
sparse_conv_gemm_kernel(const E* __restrict__ feats,
                        const int* __restrict__ nbr,
                        const E* __restrict__ w,
                        const int* __restrict__ perm,
                        const unsigned* __restrict__ tile_mask,
                        E* __restrict__ out, int vin, int vout, int cin,
                        int cout, int taps, int col_tiles, bool a_vec,
                        bool b_vec) {
  constexpr int kAStage = kRows * Route<E>::kALd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* a_s = reinterpret_cast<E*>(smem_raw);  // [kStages][kRows][kALd]
  E* b_s = a_s + kStages * kAStage;         // [kStages][kDepth][kBLd]
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
    issue_stage<E>(a_s + stage * kAStage, b_s + stage * kBStage, feats, w,
                   idx_s + pk * kRows, pk, pc, n0, vin, cin, cout, a_vec,
                   b_vec, tid);
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
    Route<E>::stage_mma(part, a_s + (it % kStages) * kAStage,
                        b_s + (it % kStages) * kBStage, wm, wn, g, t);
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
      E* dst = out + static_cast<long long>(row_s[r]) * cout;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn + 8 * ni + 2 * t;
        const float x = acc[mi][ni][2 * half];
        const float y = acc[mi][ni][2 * half + 1];
        if (pair && n + 1 < cout) {
          Route<E>::store_pair(dst + n, x, y);
        } else {
          if (n < cout) {
            Route<E>::store_one(dst + n, x);
          }
          if (n + 1 < cout) {
            Route<E>::store_one(dst + n + 1, y);
          }
        }
      }
    }
  }
}

template <typename E>
int launch_gemm(const void* feats, const void* nbr, const void* w,
                const void* perm, const void* tile_mask, void* out, int vin,
                int vout, int cin, int cout, int taps, void* stream) {
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
  constexpr int kVec = Route<E>::kVec;
  const bool a_vec = cin % kVec == 0 && aligned(feats);
  const bool b_vec = cout % kVec == 0 && aligned(w);
  sparse_conv_gemm_kernel<E><<<static_cast<unsigned int>(tiles * col_tiles),
                               kThreads, smem_bytes<E>(),
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const E*>(feats), static_cast<const int*>(nbr),
      static_cast<const E*>(w), static_cast<const int*>(perm),
      static_cast<const unsigned*>(tile_mask), static_cast<E*>(out), vin,
      vout, cin, cout, taps, static_cast<int>(col_tiles), a_vec, b_vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sst_sparse_conv_gemm_f32(const void* feats, const void* nbr,
                                        const void* w, const void* perm,
                                        const void* tile_mask, void* out,
                                        int vin, int vout, int cin, int cout,
                                        int taps, void* stream) {
  return launch_gemm<float>(feats, nbr, w, perm, tile_mask, out, vin, vout,
                            cin, cout, taps, stream);
}

extern "C" int sst_sparse_conv_gemm_bf16(const void* feats, const void* nbr,
                                         const void* w, const void* perm,
                                         const void* tile_mask, void* out,
                                         int vin, int vout, int cin, int cout,
                                         int taps, void* stream) {
  return launch_gemm<__nv_bfloat16>(feats, nbr, w, perm, tile_mask, out,
                                    vin, vout, cin, cout, taps, stream);
}
