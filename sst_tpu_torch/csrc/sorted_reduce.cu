// Segment sum / max over rows already sorted by segment id, for Hopper.
//
// Replaces the TPU kernel sst_tpu/ops/sorted_reduce.py:_sorted_reduce_kernel
// (a Pallas kernel that streamed 512-row chunks through VMEM, carried the
// segment id in an f32 lane and reduced with a one-hot MXU matmul for sum
// and a segmented Hillis-Steele scan for max). None of those workarounds is
// needed here: because rows arrive sorted by segment id, every segment is one
// contiguous row range, found by binary search.
//
// What bounds it: bytes. One call reads the N x C f32 rows once, reads
// log2(N) ids per segment for the two binary searches, and writes the
// num_segments x C output once; there is no arithmetic to speak of. The
// design therefore
//   * gives each segment to one warp, whose lanes walk the channels: for
//     C >= 32 the lanes of a warp read one row's channels side by side, so
//     each row is one coalesced read;
//   * writes every output row exactly once (empty segments write 0), so the
//     output needs no memset and the kernel no atomics: the result is
//     deterministic, with each segment summed in row order;
//   * drops ids outside [0, num_segments) for free: negative ids sort before
//     segment 0 and ids >= num_segments after the last segment, so no binary
//     search ever lands on them;
//   * writes 0 for a max that is not finite, the JAX package's segment_reduce
//     function: a NaN sticks once seen (fmaxf would drop it) and is then
//     zeroed with any +-inf maximum; a sum is written as it is.
// Narrow rows (C = 3 on the flagship's cluster-centre pass) leave most lanes
// of a warp idle; that is left for a later, faster version.
//
// Contract (checked by the Python wrapper): data [n, c] f32 and seg [n] int32
// are contiguous on the same device, seg is nondecreasing, out is
// [num_segments, c] f32. Launches on the given stream (which fixes the
// device) and does not synchronise. Returns cudaGetLastError() after the
// launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr long long kMaxBlocks = 1 << 20;

// First index in the sorted seg[0, n) whose id is >= value.
__device__ __forceinline__ int lower_bound(const int* __restrict__ seg, int n,
                                           int value) {
  int lo = 0;
  int hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(seg + mid) < value) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <bool kMax>
__global__ void __launch_bounds__(kThreads)
sorted_segment_reduce_kernel(const float* __restrict__ data,
                             const int* __restrict__ seg,
                             float* __restrict__ out, int n, int c,
                             int num_segments) {
  const int lane = threadIdx.x & 31;
  const int warp_stride = gridDim.x * kWarpsPerBlock;
  for (int s = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       s < num_segments; s += warp_stride) {
    // All lanes search the same value, so every load is a broadcast.
    const int start = lower_bound(seg, n, s);
    const int end = lower_bound(seg, n, s + 1);
    for (int ch = lane; ch < c; ch += 32) {
      const float* p = data + static_cast<long long>(start) * c + ch;
      float acc = kMax ? -INFINITY : 0.0f;
      for (int r = start; r < end; ++r, p += c) {
        const float v = __ldg(p);
        if (kMax) {
          acc = (v > acc || v != v) ? v : acc;  // NaN sticks once seen
        } else {
          acc += v;
        }
      }
      const bool keep = end > start && (!kMax || isfinite(acc));
      out[static_cast<long long>(s) * c + ch] = keep ? acc : 0.0f;
    }
  }
}

}  // namespace

// mode: 0 = sum, 1 = max.
extern "C" int sst_sorted_segment_reduce_f32(const void* data, const void* seg,
                                             void* out, int n, int c,
                                             int num_segments, int mode,
                                             void* stream) {
  if (n < 0 || c <= 0 || num_segments <= 0 || (mode != 0 && mode != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  long long blocks = (static_cast<long long>(num_segments) + kWarpsPerBlock - 1)
                     / kWarpsPerBlock;
  if (blocks > kMaxBlocks) {
    blocks = kMaxBlocks;
  }
  const dim3 grid(static_cast<unsigned int>(blocks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(data);
  const int* g = static_cast<const int*>(seg);
  float* o = static_cast<float*>(out);
  if (mode == 1) {
    sorted_segment_reduce_kernel<true><<<grid, kThreads, 0, s>>>(
        d, g, o, n, c, num_segments);
  } else {
    sorted_segment_reduce_kernel<false><<<grid, kThreads, 0, s>>>(
        d, g, o, n, c, num_segments);
  }
  return static_cast<int>(cudaGetLastError());
}
