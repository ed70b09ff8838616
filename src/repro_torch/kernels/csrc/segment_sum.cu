// Tie-masked segment sums on Hopper (sm_90a): the sums of the COO and CSR
// relaxations of paper Algorithms 1 and 2 (m in MFBF, p and c in MFBr),
//
//   out(s, v)   = Σ_{e in run v, ascending} val(s, e) · [cand(s, e) == best(s, v)]
//   count(s, v) = Σ_{e in run v}                       [cand(s, e) == best(s, v)]
//
// where run v = [offsets[v], offsets[v+1]) of the arcs grouped by the
// segment (vertex) they reduce into, and only rows with a finite best
// take ties (best = inf / -inf means the segment has no finite
// candidate, so the sum is 0, as in the plain version).
//
// No TPU kernel stands behind this one: the reference computes these sums
// with jax.ops.segment_sum outside any Pallas kernel
// (src/repro/core/monoids.py:219-374). What the port needs from it is
// the reference's order. On the CPU, segment_sum (and torch's index_add_,
// the plain version) adds each segment's terms one at a time in arc index
// order, starting from 0. The compacted CSR relax and its COO fallback
// then give bitwise the same sums (the fallback's extra terms are exact
// zeros), and a row's sums do not depend on the rows beside it. On the
// card index_add_ adds with atomics in no fixed order and a tree
// reduction pairs terms by the run's length; both lose those properties.
// Here one thread owns one (row, segment) and walks its run in ascending
// arc order, adding in exactly the plain version's order.
//
// What bounds it on the H100: bytes. Each candidate and value is read
// once (8 bytes) for a compare and an add; the floor is the bytes of the
// runs whose best is finite, (2·4·Σ len) + the (nb, n) best and outputs,
// at 3.35 TB/s. What the design does about it:
// - Threads of a warp own consecutive segments of one row. Runs are laid
//   out in segment order, so a warp's 32 runs sit side by side in memory
//   and each cache line it fetches is used by the steps that follow.
// - Loads run UNROLL arcs ahead of the adds (ILP), the adds stay in
//   order, so a long run is limited by the load stream and not by one
//   load's latency.
// - Not done: runs are as uneven as the degrees (up to 25,231 arcs at
//   R-MAT scale 18), and a warp waits for its longest run. Splitting long
//   runs would change the order of the sums, which is the point of the
//   kernel.
// Runs on the caller's stream, allocates nothing, returns
// cudaGetLastError(). Built without --use_fast_math: the adds must be
// plain IEEE single adds in program order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;

template <bool COUNT>
__global__ void __launch_bounds__(THREADS) segment_sum_kernel(
    const float* __restrict__ cand, const float* __restrict__ best,
    const float* __restrict__ val, const int64_t* __restrict__ offsets,
    float* __restrict__ out, float* __restrict__ count, int n_seg,
    int64_t len) {
  const int v = blockIdx.x * THREADS + threadIdx.x;
  if (v >= n_seg) return;
  const int64_t row = blockIdx.y;
  const int64_t o = row * n_seg + v;
  const float b = best[o];
  float acc = 0.0f;
  float cnt = 0.0f;
  if (isfinite(b)) {
    const float* c = cand + row * len;
    const float* x = val + row * len;
    // Clamped, so a malformed offsets array cannot read past a row.
    const int64_t lo = offsets[v];
    const int64_t hi = offsets[v + 1];
    int64_t e = lo > 0 ? lo : 0;
    const int64_t end = hi < len ? hi : len;
    for (; e + UNROLL <= end; e += UNROLL) {
      float cv[UNROLL], xv[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        cv[u] = c[e + u];
        xv[u] = x[e + u];
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (cv[u] == b) {
          acc += xv[u];
          if (COUNT) cnt += 1.0f;
        }
      }
    }
    for (; e < end; ++e) {
      if (c[e] == b) {
        acc += x[e];
        if (COUNT) cnt += 1.0f;
      }
    }
  }
  out[o] = acc;
  if (COUNT) count[o] = cnt;
}

}  // namespace

// cand, val: (nb, len) row-major; best, out, count: (nb, n_seg) row-major;
// offsets: (n_seg + 1,) non-decreasing. count may be null.
extern "C" int segment_sum(const float* cand, const float* best,
                           const float* val, const int64_t* offsets,
                           float* out, float* count, int nb, int n_seg,
                           long long len, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb <= 0 || n_seg <= 0) return 0;
  const dim3 grid((n_seg + THREADS - 1) / THREADS, nb);
  if (count != nullptr) {
    segment_sum_kernel<true><<<grid, THREADS, 0, stream>>>(
        cand, best, val, offsets, out, count, n_seg, len);
  } else {
    segment_sum_kernel<false><<<grid, THREADS, 0, stream>>>(
        cand, best, val, offsets, out, count, n_seg, len);
  }
  return static_cast<int>(cudaGetLastError());
}
