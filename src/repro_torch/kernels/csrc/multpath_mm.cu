// Multpath min-plus product on Hopper (sm_90a): the MFBF Bellman-Ford
// action C = F •_(⊕,f) A of paper Algorithm 1,
//
//   C.w(i,j) = min_k F.w(i,k) + A(k,j)
//   C.m(i,j) = Σ_k F.m(i,k) · [F.w(i,k) + A(k,j) == C.w(i,j), finite]
//
// Replaces the TPU kernel src/repro/kernels/tropical_mm.py
// ::multpath_matmul_pallas (body _kernel).
//
// What bounds it on the H100: instruction issue. Min-plus has no
// tensor-core (wgmma) form, and Hopper's fused add-min (DPX) takes
// integers only, so each candidate cell costs at least two float32
// instructions, an FADD and an FMNMX. The floor is 2·nb·n·n2
// instructions at 33.5 T per second (132 SMs × 4 schedulers × 32 lanes ×
// 1.98 GHz); the bytes, (2·nb·n + n·n2 + 2·nb·n2)·4 at 3.35 TB/s, bound
// it less at the main path's nb = 64. The compares, selects and min
// (FSETP, FSEL, FMNMX) go to the ALU pipe, half as wide as the FP32 pipe
// that runs FADD, so the kernel keeps them few: see the two-pass update
// below (PERF.md has what that bought).
//
// What the design does about it:
// - Full-batch tiles. A block of 256 threads (8 warps) owns a 64x64
//   output tile, each thread a 4x4 register micro-tile of (w, m), so at
//   nb <= 64 every adjacency tile is fetched from device memory once per
//   call. Larger nb runs more row tiles on grid.y.
// - Split-K. The output alone is too small to fill 132 SMs at nb = 64
//   (53 tiles at n = 3342), so the wrapper splits the contraction into S
//   slices on grid.z (pick_splits in tropical_mm.py). Each slice writes
//   its (w, m) partial to scratch, and a second kernel folds the partials
//   in slice order with the monoid's ⊕: no atomics, so the outputs are
//   bitwise repeatable, w is bitwise equal to the plain version for any S
//   (min is order-free) and m differs only by the order of the tie sums.
//   S = 1 writes the outputs directly and launches no fold.
// - Staging that overlaps compute. F's (w, m) tiles (64 rows x BK, k
//   contiguous) and A's BK x 64 tile go through a ring of three
//   shared-memory stages filled by cp.async, two tiles ahead of the one
//   being consumed, with one barrier per tile. When n, n2 and the
//   pointers allow it the copies are 16-byte cp.async.cg, else 4-byte
//   cp.async.ca (a row of n = 3342 floats is not 16-byte aligned).
//   cp.async's zero fill would write 0, which is not this monoid's
//   identity, so ragged k, row and column edges are loaded with ordinary
//   masked loads as (inf, 0) for F and inf for A. Nothing is padded.
// - Two passes over each staged tile, and no finiteness test per cell.
//   Pass 1 takes each cell's smallest candidate over the tile's BK steps
//   (FADD, FMNMX). The merge drops m when that minimum is strictly below
//   the running w, and lowers w. Pass 2 recomputes the candidates and adds
//   F.m where one equals the new w (FADD, FSETP, predicated FADD). So a
//   cell costs five instructions, two of them at the half rate, against
//   six with three at the half rate for a one-pass update. While w is
//   still inf, ties at inf may add garbage to m; the first finite minimum
//   resets it, and each slice's epilogue zeroes m wherever w is not
//   finite. That is the plain version's result, whose ties exclude
//   non-finite candidates.
// - Each thread sweeps its slice's k in ascending order.
// - Only the frontier's live k. MFBF's maximal frontier is (inf, 0) in
//   most columns, and a column whose every row has F.w = +inf adds nothing
//   to any cell. Before each launch live_k.cu packs each slice's live
//   columns of F from the slice's first k, in F's layout, and writes their
//   k (idx) and count (counts[z]) to device memory. Slice z walks its
//   count in tiles of BK: F's tiles come from the packed copy, A's staged
//   row i is a[idx[i]] (still a contiguous 64-column chunk, so the 16-byte
//   path stays open), and each thread reads the A rows of the tile after
//   next while it reduces this one. The grid stays sized from n and a
//   block reads its slice's count on the card, so nothing waits on the
//   host; a slice with no live k writes the identity partial (inf, 0).
//   The slices keep their k ranges (pick_splits is unchanged) and each
//   walks its live k in ascending order: w is the same minimum, and m the
//   same sum with the same nonzero terms in the same order (a dead k adds
//   nothing, or garbage at w = inf that the first finite minimum resets).
//   So every output is bitwise what the full sweep gives at the same S,
//   and a row's outputs do not depend on the rows beside it. Re-cutting
//   the live list into even slices would change the order of m's sums.
// ptxas (-Xptxas=-v, CUDA 12.8): 128 registers with a 24-byte spill for
// the 4-byte-copy instance (its four A-row indices a thread), 126 and no
// spill for the 16-byte one, 43008 bytes of shared memory, so two blocks
// (16 warps) per SM; the fold 31.
// Capping the kernel at 80 registers for three blocks per SM spilled
// more and ran slower.
// Runs on the caller's stream, allocates nothing (the wrapper passes the
// scratch), returns cudaGetLastError(). Built without --use_fast_math:
// the semantics rest on exact IEEE inf arithmetic.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // output rows (batch) per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 16;   // contraction depth per stage
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int STAGES = 3;
constexpr int FLD = BK + 4;  // F's shared row stride: 16-byte rows, and
                             // the two rows a warp reads sit 16 banks apart

struct Stage {
  float fw[BM][FLD];
  float fm[BM][FLD];
  float a[BK][BN];
};
static_assert(BM * BK / 4 == THREADS && BK * BN / 4 == THREADS,
              "the 16-byte path copies one chunk of each array per thread");
static_assert(STAGES * sizeof(Stage) <= 48 * 1024, "static shared memory");

__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool vec) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The A rows that thread `tid` stages from tile `t` of a slice's live k:
// row[i] = idx[base + t·BK + r_i] for its rows r_i of the tile, -1 past
// the slice's `live` count. The 16-byte path copies one chunk a thread
// (row tid / 16), the 4-byte path BK·BN/THREADS floats (rows tid / 64 +
// 4·i).
template <bool VEC>
__device__ __forceinline__ void fetch_rows(int (&row)[4], const int* idx,
                                           int base, int live, int t,
                                           int tid) {
  if (VEC) {
    const int q = t * BK + tid / (BN / 4);
    row[0] = q < live ? idx[base + q] : -1;
  } else {
#pragma unroll
    for (int i = 0; i < BK * BN / THREADS; ++i) {
      const int q = t * BK + (tid + i * THREADS) / BN;
      row[i] = q < live ? idx[base + q] : -1;
    }
  }
}

// Stage tile `t` of a slice's live k: F's packed columns base + t·BK ..
// +BK (rows row0..row0+63) and A's rows `row` (columns col0..+63).
template <bool VEC>
__device__ __forceinline__ void load_tile(Stage& s, const float* fw,
                                          const float* fm, const float* a,
                                          const int (&row)[4], int nb, int n,
                                          int n2, int row0, int col0,
                                          int base, int live, int t,
                                          int tid) {
  const int q0 = t * BK;
  if (VEC) {
    {  // F: 64 rows x 4 chunks of 4, one chunk of each array per thread
      const int r = tid / (BK / 4);
      const int c = (tid % (BK / 4)) * 4;
      const int gr = row0 + r;
      const int q = q0 + c;
      const size_t off = static_cast<size_t>(gr) * n + base + q;
      if (gr < nb && q + 3 < live) {
        cp_async(&s.fw[r][c], fw + off, true);
        cp_async(&s.fm[r][c], fm + off, true);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = gr < nb && q + e < live;
          s.fw[r][c + e] = in ? fw[off + e] : CUDART_INF_F;
          s.fm[r][c + e] = in ? fm[off + e] : 0.f;
        }
      }
    }
    {  // A: BK rows x 16 chunks of 4, one chunk per thread
      const int r = tid / (BN / 4);
      const int c = (tid % (BN / 4)) * 4;
      const int gk = row[0];
      const int gc = col0 + c;
      const size_t off = static_cast<size_t>(gk) * n2 + gc;
      if (gk >= 0 && gc + 3 < n2) {
        cp_async(&s.a[r][c], a + off, true);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s.a[r][c + e] = (gk >= 0 && gc + e < n2) ? a[off + e]
                                                   : CUDART_INF_F;
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < BM * BK / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BK;
      const int c = e % BK;
      const int gr = row0 + r;
      const int q = q0 + c;
      const size_t off = static_cast<size_t>(gr) * n + base + q;
      if (gr < nb && q < live) {
        cp_async(&s.fw[r][c], fw + off, false);
        cp_async(&s.fm[r][c], fm + off, false);
      } else {
        s.fw[r][c] = CUDART_INF_F;
        s.fm[r][c] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < BK * BN / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BN;
      const int c = e % BN;
      const int gk = row[i];
      const int gc = col0 + c;
      if (gk >= 0 && gc < n2) {
        cp_async(&s.a[r][c], a + static_cast<size_t>(gk) * n2 + gc, false);
      } else {
        s.a[r][c] = CUDART_INF_F;
      }
    }
  }
}

// A 16-byte shared-memory load that the compiler may not merge with an
// earlier load of the same address: pass 2 reads the tile again through
// it, so the candidates are recomputed instead of being kept from pass 1
// (16·BK of them per thread, which would spill).
__device__ __forceinline__ float4 lds_fresh(const float* p) {
  float4 v;
  asm volatile("ld.volatile.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return v;
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Grid (⌈n2/BN⌉, ⌈nb/BM⌉, S). Slice z = blockIdx.z owns k-tiles
// [z·kts, min((z+1)·kts, ⌈n/BK⌉)) with kts = ⌈⌈n/BK⌉/S⌉; its counts[z]
// live k are idx[z·kts·BK + i], and F's packed columns z·kts·BK + i
// (live_k.cu). It writes its (w, m) to ow/om + z·nb·n2.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
multpath_mm_kernel(const float* __restrict__ fw, const float* __restrict__ fm,
                   const float* __restrict__ a, const int* __restrict__ idx,
                   const int* __restrict__ counts, float* __restrict__ ow,
                   float* __restrict__ om, int nb, int n, int n2) {
  __shared__ __align__(16) Stage st[STAGES];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // column group of this thread
  const int ty = tid / (BN / TN);  // row group of this thread
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int k_tiles = (n + BK - 1) / BK;
  const int kts = (k_tiles + gridDim.z - 1) / gridDim.z;
  const int base = blockIdx.z * kts * BK;
  const int live = counts[blockIdx.z];
  const int nt = (live + BK - 1) / BK;
  int row[4];  // A's rows of the next tile to stage

  float accw[TM][TN];
  float accm[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      accw[i][j] = CUDART_INF_F;
      accm[i][j] = 0.f;
    }
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nt) {
      fetch_rows<VEC>(row, idx, base, live, s, tid);
      load_tile<VEC>(st[s], fw, fm, a, row, nb, n, n2, row0, col0, base,
                     live, s, tid);
    }
    cp_commit();
  }
  fetch_rows<VEC>(row, idx, base, live, STAGES - 1, tid);
  for (int t = 0; t < nt; ++t) {
    cp_wait<STAGES - 2>();  // this thread's copies of tile t have landed
    __syncthreads();        // everyone's have, and tile t-1 is consumed
    if (t + STAGES - 1 < nt) {
      load_tile<VEC>(st[(t + STAGES - 1) % STAGES], fw, fm, a, row, nb, n,
                     n2, row0, col0, base, live, t + STAGES - 1, tid);
    }
    cp_commit();
    // The rows of the tile after next, in flight while this one reduces.
    fetch_rows<VEC>(row, idx, base, live, t + STAGES, tid);
    const Stage& s = st[t % STAGES];
    // Pass 1: each cell's smallest candidate over the tile's BK steps.
    float tmin[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) tmin[i][j] = CUDART_INF_F;
    }
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float4 w4[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        w4[i] = *reinterpret_cast<const float4*>(&s.fw[ty * TM + i][kq]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 a4 =
            *reinterpret_cast<const float4*>(&s.a[kq + kk][tx * TN]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            tmin[i][j] = fminf(tmin[i][j], lane(w4[i], kk) + lane(a4, j));
          }
        }
      }
    }
    // Merge: a strictly smaller minimum drops the ties summed so far.
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        accm[i][j] = tmin[i][j] < accw[i][j] ? 0.f : accm[i][j];
        accw[i][j] = fminf(accw[i][j], tmin[i][j]);
      }
    }
    // Pass 2: add m of every candidate of the tile that ties the new w.
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float4 w4[TM], m4[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        w4[i] = lds_fresh(&s.fw[ty * TM + i][kq]);
        m4[i] = lds_fresh(&s.fm[ty * TM + i][kq]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 a4 = lds_fresh(&s.a[kq + kk][tx * TN]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float f = lane(w4[i], kk);
          const float m = lane(m4[i], kk);
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            if (f + lane(a4, j) == accw[i][j]) accm[i][j] += m;
          }
        }
      }
    }
  }

  const size_t plane = static_cast<size_t>(nb) * n2;
  float* pw = ow + blockIdx.z * plane;
  float* pm = om + blockIdx.z * plane;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty * TM + i;
    if (gr >= nb) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx * TN + j;
      if (gc < n2) {
        const size_t off = static_cast<size_t>(gr) * n2 + gc;
        pw[off] = accw[i][j];
        pm[off] = isfinite(accw[i][j]) ? accm[i][j] : 0.f;
      }
    }
  }
}

// C = ⊕ over z = 0..S-1, in that order, of the slices' (w, m) partials.
__global__ void multpath_fold_kernel(const float* __restrict__ pw,
                                     const float* __restrict__ pm,
                                     float* __restrict__ cw,
                                     float* __restrict__ cm, size_t plane,
                                     int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= plane) return;
  float w = pw[i];
  float m = pm[i];
  for (int z = 1; z < splits; ++z) {
    const float w2 = pw[z * plane + i];
    const float m2 = pm[z * plane + i];
    const bool tie = w == w2 && isfinite(w);
    m = w < w2 ? m : (tie ? m + m2 : m2);
    w = fminf(w, w2);
  }
  cw[i] = w;
  cm[i] = m;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// fw, fm: (nb, n) row-major float32, F's live columns packed by slice
// and idx (n) and counts (splits) int32 their k and counts, as live_k.cu
// writes them for this n and splits; a: (n, n2) row-major float32; cw,
// cm: (nb, n2) outputs; part: scratch of 2·splits·nb·n2 floats (may be
// null when splits == 1). All on `device`. Returns a cudaError_t.
extern "C" int multpath_mm(const float* fw, const float* fm, const float* a,
                           const int* idx, const int* counts, float* cw,
                           float* cm, float* part, int nb, int n, int n2,
                           int splits, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits < 1 || (splits > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t plane = static_cast<size_t>(nb) * n2;
  float* ow = splits == 1 ? cw : part;
  float* om = splits == 1 ? cm : part + splits * plane;
  const dim3 grid((n2 + BN - 1) / BN, (nb + BM - 1) / BM, splits);
  const bool vec = n % 4 == 0 && n2 % 4 == 0 && aligned16(fw) &&
                   aligned16(fm) && aligned16(a);
  if (vec) {
    multpath_mm_kernel<true><<<grid, THREADS, 0, stream>>>(
        fw, fm, a, idx, counts, ow, om, nb, n, n2);
  } else {
    multpath_mm_kernel<false><<<grid, THREADS, 0, stream>>>(
        fw, fm, a, idx, counts, ow, om, nb, n, n2);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int fold_threads = 256;
  const unsigned fold_blocks =
      static_cast<unsigned>((plane + fold_threads - 1) / fold_threads);
  multpath_fold_kernel<<<fold_blocks, fold_threads, 0, stream>>>(
      ow, om, cw, cm, plane, splits);
  return static_cast<int>(cudaGetLastError());
}
