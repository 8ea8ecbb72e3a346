// Segment sum / max over rows already sorted by segment id, for Hopper.
//
// Replaces the TPU kernel sst_tpu/ops/sorted_reduce.py:_sorted_reduce_kernel
// (a Pallas kernel that streamed 512-row chunks through VMEM, carried the
// segment id in an f32 lane and reduced with a one-hot MXU matmul for sum
// and a segmented Hillis-Steele scan for max). None of those workarounds is
// needed here: because rows arrive sorted by segment id, every segment is one
// contiguous row range.
//
// What bounds it: bytes. One call reads the N x C rows once and writes the
// num_segments x C output once; there is no arithmetic to speak of. Rows are
// float32 or bfloat16 (the element type is a template parameter of the one
// reduce kernel): a bfloat16 row is widened to float32, reduced in float32
// and the result rounded to nearest even, the function bf16(reduce(f32(x)))
// that the TPU kernel computes for any input dtype. The design is two
// kernels:
//   * segment_offsets_kernel: the row range of every segment, once per
//     sorted id array: offsets[s] is the first row whose id is >= s, for s in
//     [0, num_segments], one thread per boundary. Negative ids sort before
//     segment 0 and ids >= num_segments after offsets[num_segments], so they
//     are dropped for free. The three reductions of one VFE forward share
//     one id array and so one offsets array (the wrapper takes it as an
//     argument);
//   * reduce_kernel: lanes are mapped to (segment, channel unit) by C. A
//     unit is 16 bytes where C allows it (4 float32 channels as a float4, or
//     8 bfloat16 channels as a uint4), and a group of 2^j lanes (the power
//     of two at or above the units per row, at most 32) shares a segment: at
//     C = 64 16 lanes read one float32 row's 256 bytes side by side and a
//     warp reduces 2 segments; 8 lanes read a bfloat16 row's 128 bytes and a
//     warp reduces 4. With other widths a unit is one channel; at C <= 4 a
//     thread owns a whole segment (C = 3: its three channels), wider rows
//     get a group of lanes as above. No lane idles at the flagship's widths,
//     and an empty segment costs one store per unit;
//   * every output row is written exactly once (empty segments write 0), so
//     the output needs no memset and the kernel no atomics: each segment is
//     summed in row order, the same bits in every run;
//   * a max that is not finite is written as 0, the JAX package's
//     segment_reduce function: a NaN sticks once seen (fmaxf would drop it)
//     and is then zeroed with any +-inf maximum; a sum is written as it is.
//
// Contract (checked by the Python wrapper sst_tpu_torch/ops/
// sorted_reduce.py): seg [n] int32 nondecreasing, offsets [num_segments + 1]
// int32, data [n, c] and out [num_segments, c] of one element type (float32
// or bfloat16), all contiguous on the device of the stream. Each entry point
// launches on the given stream and does not synchronise, and returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
segment_offsets_kernel(const int* __restrict__ seg, int n, int num_segments,
                       int* __restrict__ offsets) {
  const long long s = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (s > num_segments) {
    return;
  }
  // lower bound of s in seg[0, n)
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(seg + mid) < s) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  offsets[s] = lo;
}

template <bool kMax>
__device__ __forceinline__ float combine(float acc, float v) {
  if (kMax) {
    return (v > acc || v != v) ? v : acc;  // NaN sticks once seen
  }
  return acc + v;
}

template <bool kMax>
__device__ __forceinline__ float finish(float acc, bool nonempty) {
  return (nonempty && (!kMax || isfinite(acc))) ? acc : 0.0f;
}

// A unit of a row: T is what one load reads, K the float32 channels it
// holds. float (1) and float4 (4) for float32 rows; __nv_bfloat16 (1) and
// uint4 (8 bfloat16, element 0 in the low half of word 0) for bfloat16 rows.
template <typename T>
struct Unit;

template <>
struct Unit<float> {
  static constexpr int K = 1;
  __device__ static void widen(float u, float* v) { v[0] = u; }
  __device__ static float narrow(const float* v) { return v[0]; }
};

template <>
struct Unit<float4> {
  static constexpr int K = 4;
  __device__ static void widen(float4 u, float* v) {
    v[0] = u.x;
    v[1] = u.y;
    v[2] = u.z;
    v[3] = u.w;
  }
  __device__ static float4 narrow(const float* v) {
    return make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Unit<__nv_bfloat16> {
  static constexpr int K = 1;
  __device__ static void widen(__nv_bfloat16 u, float* v) {
    v[0] = __bfloat162float(u);
  }
  __device__ static __nv_bfloat16 narrow(const float* v) {
    return __float2bfloat16_rn(v[0]);
  }
};

template <>
struct Unit<uint4> {
  static constexpr int K = 8;
  __device__ static void widen2(unsigned w, float* v) {
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  }
  __device__ static unsigned narrow2(const float* v) {
    return static_cast<unsigned>(
               __bfloat16_as_ushort(__float2bfloat16_rn(v[0]))) |
           (static_cast<unsigned>(
                __bfloat16_as_ushort(__float2bfloat16_rn(v[1])))
            << 16);
  }
  __device__ static void widen(uint4 u, float* v) {
    widen2(u.x, v);
    widen2(u.y, v + 2);
    widen2(u.z, v + 4);
    widen2(u.w, v + 6);
  }
  __device__ static uint4 narrow(const float* v) {
    return make_uint4(narrow2(v), narrow2(v + 2), narrow2(v + 4),
                      narrow2(v + 6));
  }
};

// A row holds `units` units of type T. Thread t reduces units j,
// j + 2^log_group, ... of segment t >> log_group, where j = t mod
// 2^log_group, in float32 and in row order.
template <bool kMax, typename T>
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const T* __restrict__ data, const int* __restrict__ offsets,
              T* __restrict__ out, int units, int num_segments,
              int log_group) {
  constexpr int K = Unit<T>::K;
  const long long t = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const long long s = t >> log_group;
  if (s >= num_segments) {
    return;
  }
  const int group = 1 << log_group;
  const int start = __ldg(offsets + s);
  const int end = __ldg(offsets + s + 1);
  for (int u = static_cast<int>(t & (group - 1)); u < units; u += group) {
    const T* p = data + static_cast<long long>(start) * units + u;
    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      acc[k] = kMax ? -INFINITY : 0.0f;
    }
    for (int r = start; r < end; ++r, p += units) {
      float v[K];
      Unit<T>::widen(__ldg(p), v);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        acc[k] = combine<kMax>(acc[k], v[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      acc[k] = finish<kMax>(acc[k], end > start);
    }
    out[s * units + u] = Unit<T>::narrow(acc);
  }
}

template <bool kMax, typename T>
int launch_reduce(const void* data, const void* offsets, void* out, int units,
                  int num_segments, int log_group, cudaStream_t stream) {
  const long long threads = static_cast<long long>(num_segments) << log_group;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  reduce_kernel<kMax, T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                           stream>>>(
      static_cast<const T*>(data), static_cast<const int*>(offsets),
      static_cast<T*>(out), units, num_segments, log_group);
  return static_cast<int>(cudaGetLastError());
}

// Rows of `c` channels of type Scalar, read as Vec units of `per_vec`
// channels where c and both pointers allow it, else one channel at a time.
template <typename Scalar, typename Vec>
int dispatch(const void* data, const void* offsets, void* out, int c,
             int num_segments, int mode, cudaStream_t stream) {
  constexpr int per_vec = Unit<Vec>::K;
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  };
  const bool vec = c % per_vec == 0 && aligned(data) && aligned(out);
  const int units = vec ? c / per_vec : c;
  int log_group = 0;  // a thread per segment up to 4 units
  if (vec || units > 4) {
    while ((1 << log_group) < units && log_group < 5) {
      ++log_group;
    }
  }
  if (vec) {
    return mode == 1 ? launch_reduce<true, Vec>(data, offsets, out, units,
                                                num_segments, log_group, stream)
                     : launch_reduce<false, Vec>(data, offsets, out, units,
                                                 num_segments, log_group,
                                                 stream);
  }
  return mode == 1 ? launch_reduce<true, Scalar>(data, offsets, out, units,
                                                 num_segments, log_group,
                                                 stream)
                   : launch_reduce<false, Scalar>(data, offsets, out, units,
                                                  num_segments, log_group,
                                                  stream);
}

}  // namespace

extern "C" int sst_segment_offsets_i32(const void* seg, void* offsets, int n,
                                       int num_segments, void* stream) {
  if (n < 0 || num_segments < 0 || num_segments == 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks =
      (static_cast<long long>(num_segments) + 1 + kThreads - 1) / kThreads;
  segment_offsets_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seg), n, num_segments,
      static_cast<int*>(offsets));
  return static_cast<int>(cudaGetLastError());
}

// mode: 0 = sum, 1 = max. dtype: 0 = float32, 1 = bfloat16 (data and out).
extern "C" int sst_sorted_segment_reduce(const void* data, const void* offsets,
                                         void* out, int c, int num_segments,
                                         int mode, int dtype, void* stream) {
  if (c <= 0 || num_segments <= 0 || (mode != 0 && mode != 1) ||
      (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return dispatch<__nv_bfloat16, uint4>(data, offsets, out, c, num_segments,
                                          mode, st);
  }
  return dispatch<float, float4>(data, offsets, out, c, num_segments, mode,
                                 st);
}
