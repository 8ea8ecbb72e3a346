// Segment sum / max over rows already sorted by segment id, for Hopper.
//
// Replaces the TPU kernel sst_tpu/ops/sorted_reduce.py:_sorted_reduce_kernel
// (a Pallas kernel that streamed 512-row chunks through VMEM, carried the
// segment id in an f32 lane and reduced with a one-hot MXU matmul for sum
// and a segmented Hillis-Steele scan for max). None of those workarounds is
// needed here: because rows arrive sorted by segment id, every segment is one
// contiguous row range.
//
// What bounds it: bytes. One call reads the N x C f32 rows once and writes
// the num_segments x C output once; there is no arithmetic to speak of. The
// design is two kernels:
//   * segment_offsets_kernel: the row range of every segment, once per
//     sorted id array: offsets[s] is the first row whose id is >= s, for s in
//     [0, num_segments], one thread per boundary. Negative ids sort before
//     segment 0 and ids >= num_segments after offsets[num_segments], so they
//     are dropped for free. The three reductions of one VFE forward share
//     one id array and so one offsets array (the wrapper takes it as an
//     argument);
//   * reduce_kernel: lanes are mapped to (segment, channel unit) by C. With
//     C a multiple of 4 a unit is a float4, and a group of 2^j lanes (the
//     power of two at or above C / 4, at most 32) shares a segment: at C = 64
//     16 lanes read one row's 256 bytes side by side and a warp reduces 2
//     segments. With other widths a unit is one channel; at C <= 4 a thread
//     owns a whole segment (C = 3: its three channels), wider rows get a
//     group of lanes as above. No lane idles at the flagship's widths, and an
//     empty segment costs one store per unit;
//   * every output row is written exactly once (empty segments write 0), so
//     the output needs no memset and the kernel no atomics: each segment is
//     summed in row order, the same bits in every run;
//   * a max that is not finite is written as 0, the JAX package's
//     segment_reduce function: a NaN sticks once seen (fmaxf would drop it)
//     and is then zeroed with any +-inf maximum; a sum is written as it is.
//
// Contract (checked by the Python wrapper sst_tpu_torch/ops/
// sorted_reduce.py): seg [n] int32 nondecreasing, offsets [num_segments + 1]
// int32, data [n, c] f32 and out [num_segments, c] f32, all contiguous on the
// device of the stream. Each entry point launches on the given stream and
// does not synchronise, and returns cudaGetLastError() after its launch.

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

template <bool kMax>
__device__ __forceinline__ float4 combine(float4 acc, float4 v) {
  return make_float4(combine<kMax>(acc.x, v.x), combine<kMax>(acc.y, v.y),
                     combine<kMax>(acc.z, v.z), combine<kMax>(acc.w, v.w));
}

template <bool kMax>
__device__ __forceinline__ float4 finish(float4 acc, bool nonempty) {
  return make_float4(finish<kMax>(acc.x, nonempty),
                     finish<kMax>(acc.y, nonempty),
                     finish<kMax>(acc.z, nonempty),
                     finish<kMax>(acc.w, nonempty));
}

template <typename T>
__device__ __forceinline__ T init_value(bool is_max);

template <>
__device__ __forceinline__ float init_value<float>(bool is_max) {
  return is_max ? -INFINITY : 0.0f;
}

template <>
__device__ __forceinline__ float4 init_value<float4>(bool is_max) {
  const float x = init_value<float>(is_max);
  return make_float4(x, x, x, x);
}

// T is float (a unit is one channel) or float4 (four channels); a row holds
// `units` of them. Thread t reduces units j, j + 2^log_group, ... of segment
// t >> log_group, where j = t mod 2^log_group.
template <bool kMax, typename T>
__global__ void __launch_bounds__(kThreads)
reduce_kernel(const T* __restrict__ data, const int* __restrict__ offsets,
              T* __restrict__ out, int units, int num_segments,
              int log_group) {
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
    T acc = init_value<T>(kMax);
    for (int r = start; r < end; ++r, p += units) {
      acc = combine<kMax>(acc, __ldg(p));
    }
    out[s * units + u] = finish<kMax>(acc, end > start);
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

// mode: 0 = sum, 1 = max.
extern "C" int sst_sorted_segment_reduce_f32(const void* data,
                                             const void* offsets, void* out,
                                             int c, int num_segments, int mode,
                                             void* stream) {
  if (c <= 0 || num_segments <= 0 || (mode != 0 && mode != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  };
  const bool vec = c % 4 == 0 && aligned(data) && aligned(out);
  const int units = vec ? c / 4 : c;
  int log_group = 0;  // a thread per segment up to 4 units
  if (vec || units > 4) {
    while ((1 << log_group) < units && log_group < 5) {
      ++log_group;
    }
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    return mode == 1 ? launch_reduce<true, float4>(data, offsets, out, units,
                                                   num_segments, log_group, st)
                     : launch_reduce<false, float4>(data, offsets, out, units,
                                                    num_segments, log_group,
                                                    st);
  }
  return mode == 1 ? launch_reduce<true, float>(data, offsets, out, units,
                                                num_segments, log_group, st)
                   : launch_reduce<false, float>(data, offsets, out, units,
                                                 num_segments, log_group, st);
}
