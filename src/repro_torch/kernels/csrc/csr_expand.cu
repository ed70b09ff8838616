// The CSR arc expansion on Hopper (sm_90a): the compacted union frontier's
// arc ranges laid out as arc slots, the pre-sort arrays of a CSR relax's
// runs. For the frontier's compacted columns u[0, m) and the inclusive
// cumsum offs[0, m) of their degrees (core/monoids.py::_compact_cols),
// slot p in [0, len) belongs to the owner
//
//   j(p) = the first j with offs[j] > min(p, offs[m-1] - 1)
//
// (degree-0 columns own no slot; a dead slot, p >= offs[m-1], belongs to
// the last column with arcs, or to 0 when none has any), reads arc
// e = indptr[u[j]] + p - start_j, start_j = offs[j-1] (0 for j = 0), and
// writes
//
//   key[p] = live and w[e] finite ? seg[e] : n
//   col[p] = u[j]
//   out[p] = live and w[e] finite ? w[e]   : +inf
//
// bitwise what the plain version, core/monoids.py::_expand_arcs (a scatter
// of the columns' starts, a cumulative max over ecap slots, the gathers),
// gives in its first len slots. The caller passes len = the live arcs it
// has already read on the host, so no dead slot is expanded, sorted or
// relaxed.
//
// Replaces no Pallas kernel: the reference's expansion,
// src/repro/core/monoids.py::_expand_edges, is plain JAX (jax.lax.cummax).
// On the card its PyTorch form is a torch.cummax over ecap slots, a
// single-row scan that keeps few SMs busy, beside scatters and gathers of
// ecap slots where ecap is the bucket's power-of-two capacity.
//
// What bounds it on the H100: bytes. Each slot reads seg (8 B) and w (4 B)
// of its arc and writes key (8 B), col (8 B) and out (4 B): 32 B a live
// slot at 3.35 TB/s. Each owner adds offs, u and indptr[u] (24 B) once a
// tile it touches.
//
// What the design does about it:
// - Load-balanced by tile: a block takes TILE consecutive slots, whatever
//   their owners, so a hub row whose range spans thousands of tiles and a
//   tile of hundreds of degree-8 owners cost the same per slot. Two warps
//   find the owners of the tile's first and last slots by 32-way searches
//   of offs (four dependent loads at n = 2^20, from L2: offs is at most
//   8·(n+1) bytes); the owners in between form the tile's window.
// - The window is staged in shared memory, WINDOW owners a round: each
//   owner's range end, its column and its arc base indptr[u[j]] - start_j,
//   read once a tile, not once a slot. Each slot then finds its owner by a
//   binary search of the round's range ends in shared memory. A window
//   wider than WINDOW (owners of one arc each, or degree-0 columns between
//   the tile's owners) takes more rounds.
// - Slots are strided by the block's width, so a warp's stores of key, col
//   and out are contiguous, and so are its loads of seg and w within a
//   range; each thread resolves its ITEMS slots before it loads any of
//   their arcs, to keep 2·ITEMS loads in flight.
// Runs on the caller's stream, allocates nothing (the wrapper passes the
// outputs), returns cudaGetLastError(); built without --use_fast_math.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;               // slots a thread
constexpr int TILE = THREADS * ITEMS;  // slots a block
constexpr int WINDOW = 1024;           // owners staged a round

struct Smem {
  int64_t end[WINDOW];   // offs[j]: the owner's range ends before it
  int64_t base[WINDOW];  // indptr[u[j]] - start_j: its arc id is base + p
  int64_t col[WINDOW];   // u[j]
  int64_t bounds[2];     // the owners of the tile's first and last slots
};
static_assert(sizeof(Smem) <= 48 * 1024, "static shared memory");

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// The first j in [0, m) with offs[j] > q, given offs non-decreasing and
// offs[m-1] > q. Called by all 32 lanes of a warp; each gets the answer.
__device__ int64_t first_above(const int64_t* __restrict__ offs, int64_t m,
                               int64_t q, int lane) {
  int64_t lo = 0, hi = m - 1;  // the answer lies in [lo, hi]
  while (hi - lo >= 32) {
    const int64_t step = (hi - lo + 32) / 32;  // ceil((hi - lo + 1) / 32)
    const int64_t at = lo + lane * step;
    const bool below = at <= hi && offs[at] <= q;
    const int c = __popc(__ballot_sync(0xffffffffu, below));
    if (c == 0) return lo;
    const int64_t next = lo + c * step;  // the first probe above q, if any
    hi = (c < 32 && next <= hi) ? next : hi;
    lo = lo + (c - 1) * step + 1;
  }
  const int64_t at = lo + lane;
  const bool below = at <= hi && offs[at] <= q;
  return lo + __popc(__ballot_sync(0xffffffffu, below));
}

__global__ void __launch_bounds__(THREADS) csr_expand_kernel(
    const int64_t* __restrict__ u, const int64_t* __restrict__ offs,
    int64_t m, const int64_t* __restrict__ indptr,
    const int64_t* __restrict__ seg, const float* __restrict__ w, int64_t n,
    int64_t len, int64_t* __restrict__ key, int64_t* __restrict__ col,
    float* __restrict__ out) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int64_t p0 = static_cast<int64_t>(blockIdx.x) * TILE;
  const int64_t p1 = min64(p0 + TILE, len);
  const int64_t last = offs[m - 1];  // the live slots are [0, last)
  if (tid < 64) {
    const int64_t p = tid < 32 ? p0 : p1 - 1;
    const int64_t j = first_above(offs, m, min64(p, last - 1), tid & 31);
    if ((tid & 31) == 0) sm.bounds[tid >> 5] = j;
  }
  __syncthreads();
  const int64_t j0 = sm.bounds[0], j1 = sm.bounds[1];
  // a slot's owner is in the round [c0, c0 + cnt) iff lo_q <= q < the
  // range end of the round's last owner (q >= -1 always)
  int64_t lo_q = -1;
  for (int64_t c0 = j0; c0 <= j1; c0 += WINDOW) {
    const int cnt = static_cast<int>(min64(WINDOW, j1 - c0 + 1));
    for (int i = tid; i < cnt; i += THREADS) {
      const int64_t j = c0 + i;
      const int64_t v = u[j];
      sm.end[i] = offs[j];
      sm.col[i] = v;
      sm.base[i] = indptr[v] - (j > 0 ? offs[j - 1] : 0);
    }
    __syncthreads();
    const int64_t hi_q = sm.end[cnt - 1];
    int own[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int64_t p = p0 + k * THREADS + tid;
      const int64_t q = min64(p, last - 1);
      own[k] = -1;
      if (p < p1 && q >= lo_q && q < hi_q) {
        int a = 0, b = cnt - 1;  // the first sm.end[a] > q
        while (a < b) {
          const int mid = (a + b) >> 1;
          if (sm.end[mid] > q) {
            b = mid;
          } else {
            a = mid + 1;
          }
        }
        own[k] = a;
      }
    }
    int64_t sk[ITEMS];
    float wk[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int64_t p = p0 + k * THREADS + tid;
      sk[k] = n;
      wk[k] = CUDART_INF_F;
      if (own[k] >= 0 && p < last) {
        const int64_t e = sm.base[own[k]] + p;
        wk[k] = w[e];
        sk[k] = seg[e];
      }
    }
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      if (own[k] < 0) continue;
      const int64_t p = p0 + k * THREADS + tid;
      const bool alive = isfinite(wk[k]);  // a dead slot kept +inf
      key[p] = alive ? sk[k] : n;
      col[p] = sm.col[own[k]];
      out[p] = alive ? wk[k] : CUDART_INF_F;
    }
    lo_q = hi_q;
    __syncthreads();  // the next round rewrites the window
  }
}

}  // namespace

// u, offs: (m,) int64, the compacted columns and the inclusive cumsum of
// their degrees (m >= 1); indptr (n + 1,), seg (E,) int64 and w (E,)
// float32: the CSR side the columns' arc ranges index; key, col (len,)
// int64 and out (len,) float32: the slots [0, len). All on `device`.
// Returns a cudaError_t.
extern "C" int csr_expand(const int64_t* u, const int64_t* offs, long long m,
                          const int64_t* indptr, const int64_t* seg,
                          const float* w, long long n, long long len,
                          int64_t* key, int64_t* col, float* out, int device,
                          cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m < 1 || n < 0 || len < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (len == 0) return 0;
  const long long blocks = (len + TILE - 1) / TILE;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  csr_expand_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      u, offs, m, indptr, seg, w, n, len, key, col, out);
  return static_cast<int>(cudaGetLastError());
}
