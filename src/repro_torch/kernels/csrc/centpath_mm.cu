// Centpath max-minus product on Hopper (sm_90a): the MFBr Brandes action
// C = F •_(⊗,g) B of paper Algorithm 2, with B = Aᵀ,
//
//   C.w(i,j) = max_k F.w(i,k) - B(k,j)   (inactive or no edge -> -inf)
//   C.p(i,j) = Σ_k F.p(i,k) · [tie at the max, finite]
//   C.c(i,j) = Σ_k [tie at the max, finite]   (children that reported)
//
// Replaces the TPU kernel src/repro/kernels/centpath_mm.py
// ::centpath_matmul_pallas (body _kernel).
//
// What bounds it on the H100: instruction issue. Max-minus has no
// tensor-core (wgmma) form, and Hopper's fused add-max (DPX) takes
// integers only, so each candidate cell costs at least two float32
// instructions, a subtraction and an FMNMX. The floor is 2·nb·n·n2
// instructions at 33.5 T per second (132 SMs × 4 schedulers × 32 lanes ×
// 1.98 GHz); the bytes, (2·nb·n + n·n2 + 3·nb·n2)·4 at 3.35 TB/s, bound
// it less at the main path's nb = 64. Compares, selects and max go to
// the ALU pipe, half as wide as the FP32 pipe that runs FADD, so the
// kernel keeps them few.
//
// What the design does about it, as in multpath_mm.cu:
// - Full-batch tiles: a block of 256 threads owns a 64x64 output tile,
//   each thread a 4x4 register micro-tile of (w, p, c), so at nb <= 64
//   every tile of B is fetched from device memory once per call.
// - Split-K on grid.z into S slices (pick_splits in tropical_mm.py), each
//   writing its (w, p, c) partial to scratch; a second kernel folds them
//   in slice order with the monoid's ⊗. No atomics: the outputs are
//   bitwise repeatable, w and c bitwise equal to the plain version for
//   any S (max and integer counts are order-free), p within the order of
//   its tie sums. S = 1 writes the outputs directly.
// - A ring of three shared-memory stages filled by cp.async (16-byte
//   cp.async.cg when n, n2 and the pointers allow it, else 4-byte
//   cp.async.ca), two tiles ahead, one barrier per tile. Ragged edges are
//   ordinary masked loads of the identities, F as (-inf, 0) and B as
//   +inf, since cp.async's zero fill is no identity here.
// - The plain version's guard,
//     cand = (isfinite(fw) && isfinite(b)) ? fw - b : -inf,
//   is applied once per staged element, not per cell: after its copies
//   land, each thread rewrites the elements it copied, a non-finite F.w
//   as -inf and a non-finite B as +inf. Then fw - b is that same cand for
//   every input (-inf - x = -inf, x - inf = -inf, -inf - inf = -inf).
// - Two passes over each staged tile, and no finiteness test per cell:
//   pass 1 takes each cell's largest candidate over the tile (FADD,
//   FMNMX); the merge drops p and c when it is strictly above the
//   running w; pass 2 recomputes the candidates and adds p and 1 where
//   one equals the new w (FADD, FSETP, two predicated FADDs). Six
//   instructions a cell, two at the half rate, against eight with five
//   for a one-pass update. Ties at -inf may add garbage to p and c; the
//   first finite maximum resets them, and each slice's epilogue zeroes p
//   and c wherever w is still -inf, which is the plain version's result.
// - Only the frontier's live k, as in multpath_mm.cu: live_k.cu packs each
//   slice's columns with a finite F.w (a non-finite one is -inf after the
//   guard, the identity candidate for every cell) from the slice's first
//   k, with their k and count; slice z walks its count in tiles of BK,
//   staging the packed F and B's rows b[idx[i]] (each a contiguous
//   64-column chunk, so the 16-byte copies stay open), reading the B rows
//   of the tile after next while it reduces this one; a slice with no
//   live k writes (-inf, 0, 0). The
//   slices keep their k ranges and each walks its live k in ascending
//   order, so w is the same maximum and p and c the same sums of the same
//   nonzero terms in the same order: every output is bitwise the full
//   sweep's at the same S, and a row's do not depend on its batch.
// ptxas (-Xptxas=-v, CUDA 12.8): 128 and 122 registers for the 4- and
// 16-byte-copy instances, no spills, 43008 bytes of shared memory, two
// blocks (16 warps) per SM; the fold 32.
// Runs on the caller's stream, allocates nothing (the wrapper passes the
// scratch), returns cudaGetLastError(); built without --use_fast_math.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int STAGES = 3;
constexpr int FLD = BK + 4;

struct Stage {
  float fw[BM][FLD];
  float fp[BM][FLD];
  float b[BK][BN];
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

__device__ __forceinline__ float guard_f(float w) {
  return isfinite(w) ? w : -CUDART_INF_F;
}

__device__ __forceinline__ float guard_b(float v) {
  return isfinite(v) ? v : CUDART_INF_F;
}

// The B rows that thread `tid` stages from tile `t` of a slice's live k:
// row[i] = idx[base + t·BK + r_i] for its rows r_i of the tile, -1 past
// the slice's `live` count.
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

// The elements of a stage that thread `tid` copies: in the 16-byte path
// one 4-float chunk of each array, else BM·BK/THREADS single floats of F
// and BK·BN/THREADS of B. load_tile and guard_tile walk the same ones.
// Tile `t` is F's packed columns base + t·BK .. +BK and B's rows `row`.
template <bool VEC>
__device__ __forceinline__ void load_tile(Stage& s, const float* fw,
                                          const float* fp, const float* b,
                                          const int (&row)[4], int nb, int n,
                                          int n2, int row0, int col0,
                                          int base, int live, int t,
                                          int tid) {
  const int q0 = t * BK;
  if (VEC) {
    {
      const int r = tid / (BK / 4);
      const int c = (tid % (BK / 4)) * 4;
      const int gr = row0 + r;
      const int q = q0 + c;
      const size_t off = static_cast<size_t>(gr) * n + base + q;
      if (gr < nb && q + 3 < live) {
        cp_async(&s.fw[r][c], fw + off, true);
        cp_async(&s.fp[r][c], fp + off, true);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = gr < nb && q + e < live;
          s.fw[r][c + e] = in ? fw[off + e] : -CUDART_INF_F;
          s.fp[r][c + e] = in ? fp[off + e] : 0.f;
        }
      }
    }
    {
      const int r = tid / (BN / 4);
      const int c = (tid % (BN / 4)) * 4;
      const int gk = row[0];
      const int gc = col0 + c;
      const size_t off = static_cast<size_t>(gk) * n2 + gc;
      if (gk >= 0 && gc + 3 < n2) {
        cp_async(&s.b[r][c], b + off, true);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s.b[r][c + e] = (gk >= 0 && gc + e < n2) ? b[off + e]
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
        cp_async(&s.fp[r][c], fp + off, false);
      } else {
        s.fw[r][c] = -CUDART_INF_F;
        s.fp[r][c] = 0.f;
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
        cp_async(&s.b[r][c], b + static_cast<size_t>(gk) * n2 + gc, false);
      } else {
        s.b[r][c] = CUDART_INF_F;
      }
    }
  }
}

// Rewrite this thread's own elements of a landed stage with the guard.
template <bool VEC>
__device__ __forceinline__ void guard_tile(Stage& s, int tid) {
  if (VEC) {
    float4& w = *reinterpret_cast<float4*>(
        &s.fw[tid / (BK / 4)][(tid % (BK / 4)) * 4]);
    w = make_float4(guard_f(w.x), guard_f(w.y), guard_f(w.z), guard_f(w.w));
    float4& v = *reinterpret_cast<float4*>(
        &s.b[tid / (BN / 4)][(tid % (BN / 4)) * 4]);
    v = make_float4(guard_b(v.x), guard_b(v.y), guard_b(v.z), guard_b(v.w));
  } else {
#pragma unroll
    for (int i = 0; i < BM * BK / THREADS; ++i) {
      const int e = tid + i * THREADS;
      s.fw[e / BK][e % BK] = guard_f(s.fw[e / BK][e % BK]);
    }
#pragma unroll
    for (int i = 0; i < BK * BN / THREADS; ++i) {
      const int e = tid + i * THREADS;
      s.b[e / BN][e % BN] = guard_b(s.b[e / BN][e % BN]);
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

// Grid (⌈n2/BN⌉, ⌈nb/BM⌉, S); slice z = blockIdx.z owns k-tiles
// [z·kts, min((z+1)·kts, ⌈n/BK⌉)) with kts = ⌈⌈n/BK⌉/S⌉; its counts[z]
// live k are idx[z·kts·BK + i], and F's packed columns z·kts·BK + i
// (live_k.cu). It writes its (w, p, c) to ow/op/oc + z·nb·n2.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
centpath_mm_kernel(const float* __restrict__ fw, const float* __restrict__ fp,
                   const float* __restrict__ b, const int* __restrict__ idx,
                   const int* __restrict__ counts, float* __restrict__ ow,
                   float* __restrict__ op, float* __restrict__ oc, int nb,
                   int n, int n2) {
  __shared__ __align__(16) Stage st[STAGES];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int k_tiles = (n + BK - 1) / BK;
  const int kts = (k_tiles + gridDim.z - 1) / gridDim.z;
  const int base = blockIdx.z * kts * BK;
  const int live = counts[blockIdx.z];
  const int nt = (live + BK - 1) / BK;
  int row[4];  // B's rows of the next tile to stage

  float accw[TM][TN];
  float accp[TM][TN];
  float accc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      accw[i][j] = -CUDART_INF_F;
      accp[i][j] = 0.f;
      accc[i][j] = 0.f;
    }
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nt) {
      fetch_rows<VEC>(row, idx, base, live, s, tid);
      load_tile<VEC>(st[s], fw, fp, b, row, nb, n, n2, row0, col0, base,
                     live, s, tid);
    }
    cp_commit();
  }
  fetch_rows<VEC>(row, idx, base, live, STAGES - 1, tid);
  for (int t = 0; t < nt; ++t) {
    cp_wait<STAGES - 2>();  // this thread's copies of tile t have landed
    guard_tile<VEC>(st[t % STAGES], tid);
    __syncthreads();        // everyone's have, and tile t-1 is consumed
    if (t + STAGES - 1 < nt) {
      load_tile<VEC>(st[(t + STAGES - 1) % STAGES], fw, fp, b, row, nb, n,
                     n2, row0, col0, base, live, t + STAGES - 1, tid);
    }
    cp_commit();
    // The rows of the tile after next, in flight while this one reduces.
    fetch_rows<VEC>(row, idx, base, live, t + STAGES, tid);
    const Stage& s = st[t % STAGES];
    // Pass 1: each cell's largest candidate over the tile's BK steps.
    float tmax[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) tmax[i][j] = -CUDART_INF_F;
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
        const float4 b4 =
            *reinterpret_cast<const float4*>(&s.b[kq + kk][tx * TN]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            tmax[i][j] = fmaxf(tmax[i][j], lane(w4[i], kk) - lane(b4, j));
          }
        }
      }
    }
    // Merge: a strictly larger maximum drops the ties summed so far.
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const bool better = tmax[i][j] > accw[i][j];
        accp[i][j] = better ? 0.f : accp[i][j];
        accc[i][j] = better ? 0.f : accc[i][j];
        accw[i][j] = fmaxf(accw[i][j], tmax[i][j]);
      }
    }
    // Pass 2: add p and 1 for every candidate of the tile that ties the
    // new w.
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float4 w4[TM], p4[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        w4[i] = lds_fresh(&s.fw[ty * TM + i][kq]);
        p4[i] = lds_fresh(&s.fp[ty * TM + i][kq]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b4 = lds_fresh(&s.b[kq + kk][tx * TN]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float f = lane(w4[i], kk);
          const float p = lane(p4[i], kk);
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            if (f - lane(b4, j) == accw[i][j]) {
              accp[i][j] += p;
              accc[i][j] += 1.f;
            }
          }
        }
      }
    }
  }

  const size_t plane = static_cast<size_t>(nb) * n2;
  float* pw = ow + blockIdx.z * plane;
  float* pp = op + blockIdx.z * plane;
  float* pc = oc + blockIdx.z * plane;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty * TM + i;
    if (gr >= nb) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx * TN + j;
      if (gc < n2) {
        const size_t off = static_cast<size_t>(gr) * n2 + gc;
        const bool live = isfinite(accw[i][j]);
        pw[off] = accw[i][j];
        pp[off] = live ? accp[i][j] : 0.f;
        pc[off] = live ? accc[i][j] : 0.f;
      }
    }
  }
}

// C = ⊗ over z = 0..S-1, in that order, of the slices' (w, p, c) partials.
__global__ void centpath_fold_kernel(const float* __restrict__ pw,
                                     const float* __restrict__ pp,
                                     const float* __restrict__ pc,
                                     float* __restrict__ cw,
                                     float* __restrict__ cp,
                                     float* __restrict__ cc, size_t plane,
                                     int splits) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= plane) return;
  float w = pw[i];
  float p = pp[i];
  float c = pc[i];
  for (int z = 1; z < splits; ++z) {
    const float w2 = pw[z * plane + i];
    const float p2 = pp[z * plane + i];
    const float c2 = pc[z * plane + i];
    const bool tie = w == w2 && isfinite(w);
    p = w > w2 ? p : (tie ? p + p2 : p2);
    c = w > w2 ? c : (tie ? c + c2 : c2);
    w = fmaxf(w, w2);
  }
  cw[i] = w;
  cp[i] = p;
  cc[i] = c;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// fw, fp: (nb, n) row-major float32, F's live columns packed by slice
// and idx (n) and counts (splits) int32 their k and counts, as live_k.cu
// writes them for this n and splits; b: (n, n2) row-major float32 (Aᵀ on
// the main path); cw, cp, cc: (nb, n2) outputs; part: scratch of
// 3·splits·nb·n2 floats (may be null when splits == 1). All on `device`.
// Returns a cudaError_t.
extern "C" int centpath_mm(const float* fw, const float* fp, const float* b,
                           const int* idx, const int* counts, float* cw,
                           float* cp, float* cc, float* part, int nb, int n,
                           int n2, int splits, int device,
                           cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits < 1 || (splits > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t plane = static_cast<size_t>(nb) * n2;
  float* ow = splits == 1 ? cw : part;
  float* op = splits == 1 ? cp : part + splits * plane;
  float* oc = splits == 1 ? cc : part + 2 * splits * plane;
  const dim3 grid((n2 + BN - 1) / BN, (nb + BM - 1) / BM, splits);
  const bool vec = n % 4 == 0 && n2 % 4 == 0 && aligned16(fw) &&
                   aligned16(fp) && aligned16(b);
  if (vec) {
    centpath_mm_kernel<true><<<grid, THREADS, 0, stream>>>(
        fw, fp, b, idx, counts, ow, op, oc, nb, n, n2);
  } else {
    centpath_mm_kernel<false><<<grid, THREADS, 0, stream>>>(
        fw, fp, b, idx, counts, ow, op, oc, nb, n, n2);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int fold_threads = 256;
  const unsigned fold_blocks =
      static_cast<unsigned>((plane + fold_threads - 1) / fold_threads);
  centpath_fold_kernel<<<fold_blocks, fold_threads, 0, stream>>>(
      ow, op, oc, cw, cp, cc, plane, splits);
  return static_cast<int>(cudaGetLastError());
}
