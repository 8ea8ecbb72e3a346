// Weight gradient of the sparse 3D convolution over a neighbour table, for
// Hopper, on the tensor cores: f32 at f32 accuracy (3xTF32), and a bf16
// route.
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
// What bounds it: operations, the same useful work as the forward conv (2 *
// Cin * Cout FLOP per (row, tap) pair that has a neighbour), which must stay
// f32-accurate. The design:
//   * the forward's mask-sorted row schedule (sst_tpu_torch/ops/
//     sparse_conv_gemm.py conv_schedule, cached on the conv's plan): tile i
//     holds output rows perm[64 i .. 64 i + 63], and only the tiles whose
//     tile_mask[i] has bit k contribute to dW[k]. Rows that share a mask
//     share a tile, so the executed (row, tap) pairs are the forward's;
//   * a first kernel lists, per tap k, the schedule's tiles whose mask has
//     bit k (a ballot per warp, one block per tap). The grid runs over (tap
//     k, 64-channel Cin tile, 64-channel Cout tile) and over S splits; split
//     s of tap k takes the s-th of S equal shares of k's list, in schedule
//     order, so the blocks of one tap carry equal work wherever its tiles lie
//     in the mask order (splits over the schedule's own tile ranges left the
//     tiles of a high tap bit to a few of them). Per tile a block gathers,
//     in two 32-row stages, feats[nbr[k, perm[r]], c0:c0+64] and
//     dout[perm[r], n0:n0+64]
//     (16-byte cp.async; src-size 0 zero-fills a missing row or a row past
//     vout) into a 2-stage ring, so the next stage's gathers overlap this
//     stage's products. The tile's output rows (perm) are copied two tiles
//     ahead and its neighbour indices (nbr[k, perm[r]]) one tile ahead, both
//     by cp.async, so no thread waits on an index load;
//   * 3xTF32 on mma.sync.m16n8k8, as the forward conv: M = Cin, N = Cout
//     and the reduction runs over the stage's rows. Each operand is split
//     a = hi + lo (hi rounded to TF32 as cvt.rna rounds, lo = a - hi exact
//     in f32), and lo*hi + hi*lo + hi*hi are accumulated. A is feats^T, so
//     its fragments read the [rows][channels] stage transposed; rows are
//     padded to 72 floats, which keeps both operands' fragment loads free of
//     bank conflicts (lane (g, t) reads row t, column g: bank 8 t + g). The
//     tensor cores' f32 accumulation does not round to nearest, and here the
//     reduction runs over up to ~10^5 rows per tap: each 32-row stage is
//     summed from zero and added to the f32 accumulators with IEEE adds;
//   * blocks on different SMs cannot carry a sum across the TPU's sequential
//     grid, so each split writes its partial tile to a workspace
//     [S, K, Cin, Cout], and a last kernel sums the S partials in split
//     order. No float atomics: the result is the same bit for bit in every
//     run. With S = 1 the main kernel writes dW itself. 4 warps of 32 x 32
//     outputs, at most 128 registers a thread and 40 KB of shared memory: 4
//     blocks share an SM, and the wrapper sizes S so the grid fills the 132
//     SMs with them several times over;
//   * every element of dW is written (0 for a tap that no row has); any
//     K <= 32, Cin, Cout, vin and vout are taken, with the ragged edges
//     masked; widths that are not a multiple of 4 (or unaligned bases) take
//     4-byte cp.async copies in the same kernel.
//
// The bf16 route (sst_sparse_conv_dw_bf16) computes the function of the TPU
// kernel's bf16 path with _windowed_conv_bwd's rounding: bf16 feats and
// dout, each product exact in f32, sums in f32, and dW rounded to bf16 once,
// to nearest even, where it is written. It is the same kernel template over
// bf16 elements (Route<__nv_bfloat16>): the tap lists, splits, tile
// schedule and 2-stage ring are shared; a stage holds 32 rows of 64 bf16
// channels of each operand (rows padded to 72 bf16), its products are one
// mma.sync.m16n8k16 bf16 -> f32 per fragment (no hi/lo split), and each
// stage's sums start from zero and are added with IEEE adds. Both operands'
// fragments pair two rows, so they are packed from two 16-bit shared loads.
// The split workspace stays f32; the last kernel (or the main one where
// S = 1) rounds. bf16 widths that are not a multiple of 8 (or unaligned
// bases) are staged by plain loads and stores in place of cp.async.
//
// Contract (checked by the Python wrapper sst_tpu_torch/ops/
// sparse_conv_dw.py): feats [vin, cin], nbr [taps, vout] int32, dout
// [vout, cout], perm [vout] int32 (a permutation of the output rows),
// tile_mask [T = ceil(vout / 64)] int32 (bit k set if a row of the tile has
// a neighbour at tap k), lists [taps * T + taps] int32 (scratch),
// workspace [splits, taps, cin, cout] f32 (unused when splits == 1) and dw
// [taps, cin, cout]; feats, dout and dw all f32 (sst_sparse_conv_dw_f32) or
// all bf16 (sst_sparse_conv_dw_bf16); all contiguous on the device of the
// stream; ceil(T / splits) <= 512. Launches on the given stream and does
// not synchronise. Returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileRows = 64;   // rows per schedule tile (TILE_ROWS)
constexpr int kStageRows = 32;  // rows per stage: half a tile
constexpr int kTileC = 64;      // input channels per block (M)
constexpr int kTileN = 64;      // output channels per block (N)
constexpr int kThreads = 128;   // 4 warps of 32 x 32
constexpr int kBlocksPerSm = 4; // bounds the registers at 128 a thread
constexpr int kLd = kTileC + 8; // shared row: 72 elements
constexpr int kStage = kStageRows * kLd;
constexpr int kMaxTaps = 32;
constexpr int kMaxSplitTiles = 512;  // a split's share of a tap's tiles
constexpr int kListThreads = 1024;
constexpr int kMaxGridY = 65535;
static_assert(kTileC == kTileN, "both operands share the stage layout");

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// a = hi + lo: hi is a rounded to TF32, to nearest with ties away from
// zero (cvt.rna.tf32's rounding, as an integer add and mask); lo = a - hi is
// exact in f32 and the mma truncates it to TF32. The same split as
// sparse_conv_gemm.cu.
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

// What differs between the two routes: the elements a 16-byte copy moves,
// how a ragged element is staged, and the products of one stage. A is
// feats^T (A[channel][row], read transposed from the [row][channel] stage),
// B the dout rows; the reduction runs over the stage's 32 rows.
template <typename E>
struct Route;

template <>
struct Route<float> {
  static constexpr int kVec = 4;
  // a 4-byte cp.async; zero-filled where !ok
  __device__ static void stage_one(float* dst, const float* src,
                                   const float* base, bool ok) {
    cp_async4(dst, ok ? src : base, ok ? 4 : 0);
  }
  // 3xTF32 over m16n8k8: A fragments (channels g, g + 8; rows t, t + 4),
  // B fragments (rows t, t + 4; channel g)
  __device__ static void stage_mma(float (&part)[2][4][4], const float* a,
                                   const float* b, int wm, int wn, int g,
                                   int t) {
#pragma unroll
    for (int kk = 0; kk < kStageRows; kk += 8) {
      uint32_t a_hi[2][4], a_lo[2][4], b_hi[4][2], b_lo[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const float* ar = a + (kk + t) * kLd + wm + 16 * mi + g;
        split_tf32(ar[0], a_hi[mi][0], a_lo[mi][0]);
        split_tf32(ar[8], a_hi[mi][1], a_lo[mi][1]);
        split_tf32(ar[4 * kLd], a_hi[mi][2], a_lo[mi][2]);
        split_tf32(ar[4 * kLd + 8], a_hi[mi][3], a_lo[mi][3]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const float* br = b + (kk + t) * kLd + wn + 8 * ni + g;
        split_tf32(br[0], b_hi[ni][0], b_lo[ni][0]);
        split_tf32(br[4 * kLd], b_hi[ni][1], b_lo[ni][1]);
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
};

template <>
struct Route<__nv_bfloat16> {
  static constexpr int kVec = 8;
  // a plain load and store (cp.async moves 4 bytes or more); 0 where !ok
  __device__ static void stage_one(__nv_bfloat16* dst,
                                   const __nv_bfloat16* src,
                                   const __nv_bfloat16*, bool ok) {
    *dst = ok ? *src : __float2bfloat16(0.0f);
  }
  // one bf16 product over m16n8k16: A fragments (channels g, g + 8; row
  // pairs 2t and 2t + 8), B fragments (row pairs 2t and 2t + 8; channel
  // g), each pair packed from two 16-bit loads
  __device__ static void stage_mma(float (&part)[2][4][4],
                                   const __nv_bfloat16* a,
                                   const __nv_bfloat16* b, int wm, int wn,
                                   int g, int t) {
#pragma unroll
    for (int kk = 0; kk < kStageRows; kk += 16) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* ar = a + (kk + 2 * t) * kLd + wm + 16 * mi + g;
        af[mi][0] = pack_bf16(ar[0], ar[kLd]);
        af[mi][1] = pack_bf16(ar[8], ar[kLd + 8]);
        af[mi][2] = pack_bf16(ar[8 * kLd], ar[9 * kLd]);
        af[mi][3] = pack_bf16(ar[8 * kLd + 8], ar[9 * kLd + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const __nv_bfloat16* br = b + (kk + 2 * t) * kLd + wn + 8 * ni + g;
        bf[ni][0] = pack_bf16(br[0], br[kLd]);
        bf[ni][1] = pack_bf16(br[8 * kLd], br[9 * kLd]);
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
};

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }

// the bf16 route's one rounding, to nearest even
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// The output rows of schedule tile `tile` into rows[0 .. 63]: one 4-byte
// copy per row by threads 0 .. 63; rows past vout are zero-filled (and
// masked again where they are read).
__device__ __forceinline__ void load_tile_rows(int* rows,
                                               const int* __restrict__ perm,
                                               int tile, int vout, int tid) {
  if (tid < kTileRows) {
    const int v = tile * kTileRows + tid;
    cp_async4(rows + tid, v < vout ? perm + v : perm, v < vout ? 4 : 0);
  }
}

// The feats rows of schedule tile `tile` at this tap into src[0 .. 63]: one
// 4-byte copy nbr[k, rows[r]] per row by threads 0 .. 63, from the tile's
// output rows (already in shared memory), so no thread waits on the load;
// rows past vout are written as -1. An index outside [0, vin) is masked
// where it is read.
__device__ __forceinline__ void load_tile_src(int* src, const int* rows,
                                              const int* __restrict__ nbr_k,
                                              int tile, int vout, int tid) {
  if (tid < kTileRows) {
    if (tile * kTileRows + tid < vout) {
      cp_async4(src + tid, nbr_k + rows[tid], 4);
    } else {
      src[tid] = -1;
    }
  }
}

// One 32-row stage: a_s[r][cc] = feats[src[r], c0 + cc] (0 where src[r] is
// outside [0, vin)) and
// b_s[r][nn] = dout[rows[r], n0 + nn] for r < 32 (src and rows offset to the
// stage's half of the tile; v0 the stage's first schedule position).
template <typename E>
__device__ __forceinline__ void issue_stage(
    E* a_s, E* b_s, const E* __restrict__ feats, const E* __restrict__ dout,
    const int* rows, const int* src, int v0, int c0, int n0, int vin,
    int vout, int cin, int cout, bool a_vec, bool b_vec, int tid) {
  constexpr int kVec = Route<E>::kVec;
  constexpr int kLanes = kTileC / kVec;  // 16-byte copies per stage row
  if (a_vec) {
#pragma unroll
    for (int i = 0; i < kStageRows * kLanes / kThreads; ++i) {
      const int q = tid + i * kThreads;
      const int r = q / kLanes;
      const int cc = kVec * (q % kLanes);
      const int s = src[r];
      const int c = c0 + cc;
      const bool ok = s >= 0 && s < vin && c < cin;
      cp_async16(a_s + r * kLd + cc,
                 ok ? feats + static_cast<long long>(s) * cin + c : feats,
                 ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < kStageRows * kTileC / kThreads; ++i) {
      const int q = tid + i * kThreads;
      const int r = q >> 6;
      const int cc = q & 63;
      const int s = src[r];
      const int c = c0 + cc;
      const bool ok = s >= 0 && s < vin && c < cin;
      Route<E>::stage_one(a_s + r * kLd + cc,
                          feats + static_cast<long long>(s) * cin + c, feats,
                          ok);
    }
  }
  if (b_vec) {
#pragma unroll
    for (int i = 0; i < kStageRows * kLanes / kThreads; ++i) {
      const int q = tid + i * kThreads;
      const int r = q / kLanes;
      const int nn = kVec * (q % kLanes);
      const int n = n0 + nn;
      const bool ok = v0 + r < vout && n < cout;
      cp_async16(b_s + r * kLd + nn,
                 ok ? dout + static_cast<long long>(rows[r]) * cout + n
                    : dout,
                 ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = 0; i < kStageRows * kTileN / kThreads; ++i) {
      const int q = tid + i * kThreads;
      const int r = q >> 6;
      const int nn = q & 63;
      const int n = n0 + nn;
      const bool ok = v0 + r < vout && n < cout;
      Route<E>::stage_one(
          b_s + r * kLd + nn,
          dout + static_cast<long long>(ok ? rows[r] : 0) * cout + n, dout,
          ok);
    }
  }
}

// lists[k][0 .. counts[k]) = the schedule's tiles whose mask has bit k, in
// schedule order: one block per tap, a ballot per warp.
__global__ void __launch_bounds__(kListThreads)
tap_tile_lists_kernel(const unsigned* __restrict__ tile_mask, int n_sched,
                      int* __restrict__ lists, int* __restrict__ counts) {
  __shared__ int warp_s[kListThreads / 32];
  const int k = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* list = lists + static_cast<long long>(k) * n_sched;
  int count = 0;
  for (int base = 0; base < n_sched; base += kListThreads) {
    const int i = base + threadIdx.x;
    const bool has = i < n_sched && ((__ldg(tile_mask + i) >> k) & 1u);
    const unsigned ballot = __ballot_sync(0xffffffffu, has);
    if (lane == 0) {
      warp_s[warp] = __popc(ballot);
    }
    __syncthreads();
    int at = count;
    for (int w = 0; w < warp; ++w) {
      at += warp_s[w];
    }
    if (has) {
      list[at + __popc(ballot & ((1u << lane) - 1u))] = i;
    }
    for (int w = 0; w < kListThreads / 32; ++w) {
      count += warp_s[w];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    counts[k] = count;
  }
}

// The main kernel over elements E, writing T: the f32 partial tile of
// split s (splits > 1), or where S = 1 dW itself (T = E, the bf16 route
// rounding once).
template <typename E, typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
sparse_conv_dw_kernel(const E* __restrict__ feats,
                      const int* __restrict__ nbr,
                      const E* __restrict__ dout,
                      const int* __restrict__ perm,
                      const int* __restrict__ lists,
                      const int* __restrict__ counts,
                      T* __restrict__ partial, int vin, int vout, int cin,
                      int cout, int taps, int splits, bool a_vec,
                      bool b_vec) {
  __shared__ __align__(16) E a_s[2][kStage];  // feats rows, per stage
  __shared__ __align__(16) E b_s[2][kStage];  // dout rows, per stage
  __shared__ int rows_s[3][kTileRows];  // perm of three tiles in flight
  __shared__ int src_s[2][kTileRows];   // their neighbour rows at tap k
  __shared__ int list_s[kMaxSplitTiles];  // the split's tiles with bit k

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_tiles = (cout + kTileN - 1) / kTileN;
  const int c_tiles = (cin + kTileC - 1) / kTileC;
  int b = blockIdx.x;
  const int n0 = (b % n_tiles) * kTileN;
  b /= n_tiles;
  const int c0 = (b % c_tiles) * kTileC;
  const int k = b / c_tiles;
  const int s = blockIdx.y;
  const int n_sched = (vout - 1) / kTileRows + 1;
  const int* nbr_k = nbr + static_cast<long long>(k) * vout;

  // this split's share of the tap's tiles (those whose mask has bit k)
  const long long listed = __ldg(counts + k);
  const int lo = static_cast<int>(listed * s / splits);
  const int count = static_cast<int>(listed * (s + 1) / splits) - lo;
  const int* list_k = lists + static_cast<long long>(k) * n_sched + lo;
  for (int i = tid; i < count; i += kThreads) {
    cp_async4(list_s + i, list_k + i, 4);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  const int g = lane >> 2;
  const int t = lane & 3;
  const int wm = (warp >> 1) * 32;  // the warp's input channels in the tile
  const int wn = (warp & 1) * 32;   // its output channels
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

  // stage it is half (it & 1) of listed tile it >> 1
  const int n_iter = 2 * count;
  if (n_iter > 0) {
    load_tile_rows(rows_s[0], perm, list_s[0], vout, tid);
    if (count > 1) {
      load_tile_rows(rows_s[1], perm, list_s[1], vout, tid);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    load_tile_src(src_s[0], rows_s[0], nbr_k, list_s[0], vout, tid);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    issue_stage<E>(a_s[0], b_s[0], feats, dout, rows_s[0], src_s[0],
                   list_s[0] * kTileRows, c0, n0, vin, vout, cin, cout,
                   a_vec, b_vec, tid);
    cp_async_commit();
  }
  for (int it = 0; it < n_iter; ++it) {
    const int p = it >> 1;
    const int half = it & 1;
    cp_async_wait_all();
    __syncthreads();  // stage `it` has landed; stage it - 1 is consumed
    // at a tile's first half: copy the next tile's neighbour rows (its
    // perm landed a tile ago) and the perm of the tile after it
    if (half == 0 && p + 1 < count) {
      load_tile_src(src_s[(p + 1) & 1], rows_s[(p + 1) % 3], nbr_k,
                    list_s[p + 1], vout, tid);
    }
    if (half == 0 && p + 2 < count) {
      load_tile_rows(rows_s[(p + 2) % 3], perm, list_s[p + 2], vout, tid);
    }
    if (it + 1 < n_iter) {
      const int q = (it + 1) >> 1;
      const int h = (it + 1) & 1;
      issue_stage<E>(a_s[(it + 1) & 1], b_s[(it + 1) & 1], feats, dout,
                     rows_s[q % 3] + h * kStageRows,
                     src_s[q & 1] + h * kStageRows,
                     list_s[q] * kTileRows + h * kStageRows, c0, n0, vin,
                     vout, cin, cout, a_vec, b_vec, tid);
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
    Route<E>::stage_mma(part, a_s[it & 1], b_s[it & 1], wm, wn, g, t);
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

  // c0, c1: channel g, outputs 2t, 2t + 1; c2, c3: channel g + 8
  T* out = partial + (static_cast<long long>(s) * taps + k) *
                         static_cast<long long>(cin) * cout;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + wm + 16 * mi + g + 8 * h;
      if (c >= cin) {
        continue;
      }
      T* row = out + static_cast<long long>(c) * cout;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn + 8 * ni + 2 * t;
        if (n < cout) {
          store_out(row + n, acc[mi][ni][2 * h]);
        }
        if (n + 1 < cout) {
          store_out(row + n + 1, acc[mi][ni][2 * h + 1]);
        }
      }
    }
  }
}

// dw[i] = sum over s of partial[s, i], in split order
template <typename T>
__global__ void __launch_bounds__(256)
sum_splits_kernel(const float* __restrict__ partial, T* __restrict__ dw,
                  long long n, int splits) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    float sum = 0.0f;
    for (int s = 0; s < splits; ++s) {
      sum += __ldg(partial + s * n + i);
    }
    store_out(dw + i, sum);
  }
}

// The tap lists, the main kernel over the splits and, where S > 1, the
// split sum, for elements E (the launch checks done by the caller).
template <typename E>
int launch_dw(const void* feats, const void* nbr, const void* dout,
              const void* perm, const void* tile_mask, void* lists,
              void* workspace, void* dw, int vin, int vout, int cin,
              int cout, int taps, int splits, void* stream) {
  const long long n_sched =
      (static_cast<long long>(vout) + kTileRows - 1) / kTileRows;
  if (vin < 0 || vout <= 0 || cin <= 0 || cout <= 0 || taps <= 0 ||
      taps > kMaxTaps || splits <= 0 || splits > kMaxGridY ||
      (n_sched + splits - 1) / splits > kMaxSplitTiles || lists == nullptr ||
      (splits > 1 && workspace == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks = static_cast<long long>(taps) *
                           ((cin + kTileC - 1) / kTileC) *
                           ((cout + kTileN - 1) / kTileN);
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  };
  constexpr int kVec = Route<E>::kVec;
  const bool a_vec = cin % kVec == 0 && aligned(feats);
  const bool b_vec = cout % kVec == 0 && aligned(dout);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* list_ptr = static_cast<int*>(lists);
  int* count_ptr = list_ptr + static_cast<long long>(taps) * n_sched;
  tap_tile_lists_kernel<<<taps, kListThreads, 0, st>>>(
      static_cast<const unsigned*>(tile_mask), static_cast<int>(n_sched),
      list_ptr, count_ptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned int>(blocks),
                  static_cast<unsigned int>(splits));
  const E* f = static_cast<const E*>(feats);
  const E* d = static_cast<const E*>(dout);
  if (splits == 1) {
    sparse_conv_dw_kernel<E, E><<<grid, kThreads, 0, st>>>(
        f, static_cast<const int*>(nbr), d, static_cast<const int*>(perm),
        list_ptr, count_ptr, static_cast<E*>(dw), vin, vout, cin, cout,
        taps, splits, a_vec, b_vec);
    return static_cast<int>(cudaGetLastError());
  }
  float* partial = static_cast<float*>(workspace);
  sparse_conv_dw_kernel<E, float><<<grid, kThreads, 0, st>>>(
      f, static_cast<const int*>(nbr), d, static_cast<const int*>(perm),
      list_ptr, count_ptr, partial, vin, vout, cin, cout, taps, splits,
      a_vec, b_vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const long long n = static_cast<long long>(taps) * cin * cout;
  long long sum_blocks = (n + 255) / 256;
  if (sum_blocks > 132 * 16) {
    sum_blocks = 132 * 16;  // grid-stride beyond 16 blocks per SM
  }
  sum_splits_kernel<E><<<static_cast<unsigned int>(sum_blocks), 256, 0, st>>>(
      partial, static_cast<E*>(dw), n, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sst_sparse_conv_dw_f32(const void* feats, const void* nbr,
                                      const void* dout, const void* perm,
                                      const void* tile_mask, void* lists,
                                      void* workspace, void* dw, int vin,
                                      int vout, int cin, int cout, int taps,
                                      int splits, void* stream) {
  return launch_dw<float>(feats, nbr, dout, perm, tile_mask, lists,
                          workspace, dw, vin, vout, cin, cout, taps, splits,
                          stream);
}

extern "C" int sst_sparse_conv_dw_bf16(const void* feats, const void* nbr,
                                       const void* dout, const void* perm,
                                       const void* tile_mask, void* lists,
                                       void* workspace, void* dw, int vin,
                                       int vout, int cin, int cout, int taps,
                                       int splits, void* stream) {
  return launch_dw<__nv_bfloat16>(feats, nbr, dout, perm, tile_mask, lists,
                                  workspace, dw, vin, vout, cin, cout, taps,
                                  splits, stream);
}
