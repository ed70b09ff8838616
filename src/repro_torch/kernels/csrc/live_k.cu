// Live-k compaction of a dense product's frontier on Hopper (sm_90a): the
// columns k of F (nb, n) that the next product, multpath_mm.cu's F •(⊕,f) A
// or centpath_mm.cu's F •(⊗,g) Aᵀ, has to contract over.
//
// MFBF's and MFBr's maximal frontiers hold the monoid's identity in most
// entries, (+inf, 0) and (-inf, 0). A column k whose every row the
// product's own guard turns into the identity candidate adds nothing to
// any output cell: dead where every row's F.w is +inf (multpath,
// FINITE = false) or not finite (centpath, FINITE = true; its guard
// rewrites such an F.w as -inf). For each of the product's S split-K
// slices, slice z owning k in [z·L, min((z+1)·L, n)) with L = kts·BK and
// kts = ⌈⌈n/BK⌉/S⌉ (the products' own slices), this pass writes
//
//   counts[z]          the slice's live k; counts[S] their sum
//   idx[z·L + i]       its i-th live k, ascending, i < counts[z]
//   cw/cx[r, z·L + i]  F.w/F.x[r, idx[z·L + i]] for every row r
//
// so a slice's live columns of F lie packed from the slice's own first k,
// in the layout of F, and the product walks them tile by tile. Positions
// past a slice's count are left unwritten.
//
// Replaces no Pallas kernel: the reference's products sweep every k.
//
// What bounds it on the H100: bytes. At least F.w is read once, the live
// columns of F.x read and those of both written once, and idx written:
// (nb·n + 3·nb·n_live)·4 + 4·n_live bytes, 20.0 µs at (64, 65536) with
// every column live at 3.35 TB/s, against the 56–69 ms of the product it
// feeds. This pass reads F.w twice (the scan stops at a column's first
// live row) and writes a byte flag a column.
//
// Two launches on the caller's stream, and no host sync:
// - live_k_scan: a block of CH threads takes CH consecutive k of one slice,
//   a thread a column, and reads the column's rows UNROLL at a time (the
//   loads of a group in flight together) until one is live. It writes a
//   byte flag a column and the block's live count.
// - live_k_gather: the same blocks. Each sums the counts of the chunks
//   before it in its slice (at most ⌈L/CH⌉ of them), ranks its live columns
//   by a ballot a warp and the warps' counts, and writes idx and the
//   packed columns, a row at a time (each warp's loads contiguous). The
//   first block of each slice writes the slice's count, and block (0, 0)
//   the sum.
// Returns cudaGetLastError(); built without --use_fast_math.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BK = 16;       // the products' contraction depth per stage
constexpr int CH = 256;      // columns a block, a thread each
constexpr int UNROLL = 8;    // rows of a column read together
constexpr int WARPS = CH / 32;

template <bool FINITE>
__device__ __forceinline__ bool live_w(float w) {
  return FINITE ? isfinite(w) : w != CUDART_INF_F;
}

// Grid (⌈L/CH⌉, S). Block (j, z) takes k = z·L + j·CH + threadIdx.x.
template <bool FINITE>
__global__ void __launch_bounds__(CH)
live_k_scan(const float* __restrict__ fw, uint8_t* __restrict__ flags,
            int* __restrict__ chunk_counts, int nb, int n, int slice_len) {
  const int off = blockIdx.x * CH + threadIdx.x;
  const int k = blockIdx.y * slice_len + off;
  bool live = false;
  if (off < slice_len && k < n) {
    const float* col = fw + k;
    for (int r0 = 0; r0 < nb && !live; r0 += UNROLL) {
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        v[u] = r0 + u < nb ? col[static_cast<size_t>(r0 + u) * n]
                           : CUDART_INF_F;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        live |= r0 + u < nb && live_w<FINITE>(v[u]);
      }
    }
    flags[k] = live;
  }
  const int cnt = __syncthreads_count(live);
  if (threadIdx.x == 0) {
    chunk_counts[blockIdx.y * gridDim.x + blockIdx.x] = cnt;
  }
}

// The sum over the block of each thread's `v`, to every thread. `red`
// holds WARPS ints; the call ends with a barrier, so `red` may be reused.
__device__ __forceinline__ int block_sum(int v, int* red) {
#pragma unroll
  for (int d = 16; d > 0; d /= 2) v += __shfl_xor_sync(0xffffffffu, v, d);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w];
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(CH)
live_k_gather(const float* __restrict__ fw, const float* __restrict__ fx,
              const uint8_t* __restrict__ flags,
              const int* __restrict__ chunk_counts, float* __restrict__ cw,
              float* __restrict__ cx, int* __restrict__ idx,
              int* __restrict__ counts, int nb, int n, int slice_len) {
  __shared__ int red[WARPS];
  const int tid = threadIdx.x;
  const int chunks = gridDim.x;
  const int* cc = chunk_counts + blockIdx.y * chunks;
  int v = 0;
  for (int j = tid; j < static_cast<int>(blockIdx.x); j += CH) v += cc[j];
  const int base = block_sum(v, red);  // live k of the slice before this chunk
  if (blockIdx.x == 0) {
    v = 0;
    for (int j = tid; j < chunks; j += CH) v += cc[j];
    v = block_sum(v, red);
    if (tid == 0) counts[blockIdx.y] = v;
    if (blockIdx.y == 0) {
      v = 0;
      for (int j = tid; j < chunks * static_cast<int>(gridDim.y); j += CH) {
        v += chunk_counts[j];
      }
      v = block_sum(v, red);
      if (tid == 0) counts[gridDim.y] = v;
    }
  }
  const int off = blockIdx.x * CH + tid;
  const int k = blockIdx.y * slice_len + off;
  const bool live = off < slice_len && k < n && flags[k];
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  const int lane = tid % 32;
  if (lane == 0) red[tid / 32] = __popc(ballot);
  __syncthreads();
  int before = 0;
  for (int w = 0; w < tid / 32; ++w) before += red[w];
  if (!live) return;
  const int pos = blockIdx.y * slice_len + base + before +
                  __popc(ballot & ((1u << lane) - 1u));
  idx[pos] = k;
#pragma unroll 8
  for (int r = 0; r < nb; ++r) {
    const size_t row = static_cast<size_t>(r) * n;
    cw[row + pos] = fw[row + k];
    cx[row + pos] = fx[row + k];
  }
}

}  // namespace

// fw, fx: (nb, n) row-major float32 (F.w and F.m, or F.w and F.p); cw, cx:
// (nb, n) float32 outputs; idx: n int32; counts: splits + 1 int32;
// chunk_counts: splits·⌈slice_len/CH⌉ int32 scratch; flags: n bytes of
// scratch. slice_len must be the products' kts·BK for this n and splits;
// finite: 1 for centpath's liveness, 0 for multpath's. All on `device`.
// nb, n >= 1. Returns a cudaError_t.
extern "C" int live_k(const float* fw, const float* fx, float* cw, float* cx,
                      int* idx, int* counts, int* chunk_counts,
                      uint8_t* flags, int nb, int n, int splits,
                      int slice_len, int finite, int device,
                      cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int k_tiles = (n + BK - 1) / BK;
  if (nb < 1 || n < 1 || splits < 1 ||
      slice_len != (k_tiles + splits - 1) / splits * BK) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((slice_len + CH - 1) / CH, splits);
  if (finite) {
    live_k_scan<true><<<grid, CH, 0, stream>>>(fw, flags, chunk_counts, nb,
                                               n, slice_len);
  } else {
    live_k_scan<false><<<grid, CH, 0, stream>>>(fw, flags, chunk_counts, nb,
                                                n, slice_len);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  live_k_gather<<<grid, CH, 0, stream>>>(fw, fx, flags, chunk_counts, cw, cx,
                                         idx, counts, nb, n, slice_len);
  return static_cast<int>(cudaGetLastError());
}
