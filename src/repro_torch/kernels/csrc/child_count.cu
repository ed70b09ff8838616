// SP-DAG child count on Hopper (sm_90a): the dense count that starts MFBr
// (paper Algorithm 2), read from At = Aᵀ,
//
//   c0(s,v) = Σ_u [Tw(s,v) + At(u,v) == Tw(s,u), and the sum is finite]
//
// as int32: the number of shortest-path-DAG children of v from source s.
//
// Replaces no Pallas kernel: the reference counts with plain jnp
// operations (src/repro/core/monoids.py::count_sp_children_dense). The
// port's plain version, repro_torch.core.monoids.count_sp_children_dense,
// computes the same sum over (nb, n, block) candidate blocks, and this
// kernel is held to it bitwise. At(u,v) is A(v,u) bit for bit and the
// add is the plain version's Tw(s,v) + A(v,u), rounded to nearest, so the
// counts are equal for every input: ±0, ±inf, sums that overflow to inf,
// rows with no finite entry.
//
// What bounds it on the H100: instruction issue. The count has a
// product's shape, (nb, n) x (n, n); each candidate cell needs at least an
// add and a compare, and neither has a tensor-core form. The floor is
// 2·nb·n·n instructions at 33.5 T per second (132 SMs × 4 schedulers × 32
// lanes × 1.98 GHz), against (2·nb·n + n·n + nb·n)·4 bytes at 3.35 TB/s,
// which bound it only below nb ≈ 20. Compares go to the ALU pipe, half as
// wide as the FP32 pipe that runs FADD, so the kernel keeps them to one a
// cell.
//
// What the design does about it, in centpath_mm.cu's tiling:
// - Full-batch tiles: a block of 256 threads owns a 64x64 (s, v) output
//   tile, each thread a 4x4 register micro-tile, so at nb <= 64 every tile
//   of At is fetched from device memory once per call. The thread's
//   sixteen Tw(s,v) stay in registers for the whole contraction.
// - A ring of three shared-memory stages filled by cp.async (16-byte
//   cp.async.cg when n and the pointers allow it, else 4-byte
//   cp.async.ca), two tiles ahead, one barrier per tile. Ragged edges are
//   masked loads: Tw(s,u) past the edge as NaN, At as +inf, neither of
//   which can count.
// - No finiteness test per cell: after its copies land, each thread
//   rewrites the Tw(s,u) elements it staged, a non-finite one as NaN.
//   Equality with a finite Tw(s,u) implies the candidate is finite, and
//   NaN equals nothing, so the count is the plain version's. A cell is
//   then three instructions: the FADD, an FSETP and a predicated FADD of
//   1 into a float32 count. The count runs on the FP32 pipe (an integer
//   add would join the compare on the ALU pipe) and is exact: a slice
//   counts at most n hits a cell, and n < 2^24 for any Aᵀ a card can hold
//   (n·n floats).
// - Split-K on grid.z into S slices (pick_splits in tropical_mm.py). S = 1
//   stores the counts; S > 1 zeroes the output on the stream and each
//   slice adds its nonzero counts with int32 atomics. Integer sums are
//   exact in any order, so every S gives the same bits.
// - It scans the whole dense operand, as the products do: no tile of At is
//   skipped for its structure (that is the CSR path's job).
// ptxas (-Xptxas=-v, CUDA 12.8): 96 and 100 registers for the 16- and
// 4-byte-copy instances, no spills, 27648 bytes of shared memory, two
// blocks (16 warps) per SM. The 16-byte instance's loop over a stage is
// 910 instructions for its 256 cells a thread: 3.55 a cell, the three
// above and the shared loads, copies and loop control.
// Runs on the caller's stream, allocates nothing (the wrapper passes the
// output), returns cudaGetLastError(); built without --use_fast_math.
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
  float tu[BM][FLD];  // Tw(s, u), a non-finite value as NaN
  float b[BK][BN];    // At(u, v)
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

__device__ __forceinline__ float guard_u(float w) {
  return isfinite(w) ? w : CUDART_NAN_F;
}

// The elements of a stage that thread `tid` copies: in the 16-byte path
// one 4-float chunk of each array, else BM·BK/THREADS single floats of
// Tw and BK·BN/THREADS of At. load_tile and guard_tile walk the same ones.
template <bool VEC>
__device__ __forceinline__ void load_tile(Stage& s, const float* tw,
                                          const float* at, int nb, int n,
                                          int row0, int col0, int kt,
                                          int tid) {
  const int k0 = kt * BK;
  if (VEC) {
    {
      const int r = tid / (BK / 4);
      const int c = (tid % (BK / 4)) * 4;
      const int gr = row0 + r;
      const int gk = k0 + c;
      const size_t off = static_cast<size_t>(gr) * n + gk;
      if (gr < nb && gk + 3 < n) {
        cp_async(&s.tu[r][c], tw + off, true);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s.tu[r][c + e] = (gr < nb && gk + e < n) ? tw[off + e]
                                                   : CUDART_NAN_F;
        }
      }
    }
    {
      const int r = tid / (BN / 4);
      const int c = (tid % (BN / 4)) * 4;
      const int gk = k0 + r;
      const int gc = col0 + c;
      const size_t off = static_cast<size_t>(gk) * n + gc;
      if (gk < n && gc + 3 < n) {
        cp_async(&s.b[r][c], at + off, true);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s.b[r][c + e] = (gk < n && gc + e < n) ? at[off + e]
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
      const int gk = k0 + c;
      if (gr < nb && gk < n) {
        cp_async(&s.tu[r][c], tw + static_cast<size_t>(gr) * n + gk, false);
      } else {
        s.tu[r][c] = CUDART_NAN_F;
      }
    }
#pragma unroll
    for (int i = 0; i < BK * BN / THREADS; ++i) {
      const int e = tid + i * THREADS;
      const int r = e / BN;
      const int c = e % BN;
      const int gk = k0 + r;
      const int gc = col0 + c;
      if (gk < n && gc < n) {
        cp_async(&s.b[r][c], at + static_cast<size_t>(gk) * n + gc, false);
      } else {
        s.b[r][c] = CUDART_INF_F;
      }
    }
  }
}

// Rewrite this thread's own Tw(s,u) elements of a landed stage: a
// non-finite value as NaN.
template <bool VEC>
__device__ __forceinline__ void guard_tile(Stage& s, int tid) {
  if (VEC) {
    float4& w = *reinterpret_cast<float4*>(
        &s.tu[tid / (BK / 4)][(tid % (BK / 4)) * 4]);
    w = make_float4(guard_u(w.x), guard_u(w.y), guard_u(w.z), guard_u(w.w));
  } else {
#pragma unroll
    for (int i = 0; i < BM * BK / THREADS; ++i) {
      const int e = tid + i * THREADS;
      s.tu[e / BK][e % BK] = guard_u(s.tu[e / BK][e % BK]);
    }
  }
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// count += 1 where cand == u: an FSETP and a predicated FADD.
__device__ __forceinline__ void count_tie(float& count, float cand, float u) {
  asm("{\n\t.reg .pred p;\n\t"
      "setp.eq.f32 p, %1, %2;\n\t"
      "@p add.f32 %0, %0, 0f3F800000;\n\t}"
      : "+f"(count)
      : "f"(cand), "f"(u));
}

// Grid (⌈n/BN⌉, ⌈nb/BM⌉, S); slice z = blockIdx.z owns u-tiles
// [z·kts, min((z+1)·kts, ⌈n/BK⌉)) with kts = ⌈⌈n/BK⌉/S⌉. With S = 1 it
// stores its counts in `out`; with S > 1 it adds them to a zeroed `out`.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
child_count_kernel(const float* __restrict__ tw, const float* __restrict__ at,
                   int* __restrict__ out, int nb, int n) {
  __shared__ __align__(16) Stage st[STAGES];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  const int k_tiles = (n + BK - 1) / BK;
  const int kts = (k_tiles + gridDim.z - 1) / gridDim.z;
  const int kt0 = blockIdx.z * kts;
  const int nt = max(0, min(k_tiles, kt0 + kts) - kt0);

  // Tw(s, v) of this thread's cells; past an edge NaN (never stored).
  float tv[TM][TN];
  float count[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx * TN + j;
      tv[i][j] = (gr < nb && gc < n) ? tw[static_cast<size_t>(gr) * n + gc]
                                     : CUDART_NAN_F;
      count[i][j] = 0.f;
    }
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nt) {
      load_tile<VEC>(st[s], tw, at, nb, n, row0, col0, kt0 + s, tid);
    }
    cp_commit();
  }
  for (int t = 0; t < nt; ++t) {
    cp_wait<STAGES - 2>();  // this thread's copies of tile t have landed
    guard_tile<VEC>(st[t % STAGES], tid);
    __syncthreads();        // everyone's have, and tile t-1 is consumed
    if (t + STAGES - 1 < nt) {
      load_tile<VEC>(st[(t + STAGES - 1) % STAGES], tw, at, nb, n, row0,
                     col0, kt0 + t + STAGES - 1, tid);
    }
    cp_commit();
    const Stage& s = st[t % STAGES];
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float4 u4[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        u4[i] = *reinterpret_cast<const float4*>(&s.tu[ty * TM + i][kq]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 b4 =
            *reinterpret_cast<const float4*>(&s.b[kq + kk][tx * TN]);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            count_tie(count[i][j], __fadd_rn(tv[i][j], lane(b4, j)),
                      lane(u4[i], kk));
          }
        }
      }
    }
  }

  const bool store = gridDim.z == 1;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty * TM + i;
    if (gr >= nb) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx * TN + j;
      if (gc >= n) continue;
      const int c = static_cast<int>(count[i][j]);
      int* p = out + static_cast<size_t>(gr) * n + gc;
      if (store) {
        *p = c;
      } else if (c != 0) {
        atomicAdd(p, c);
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// tw: (nb, n) row-major float32 distances; at: (n, n) row-major float32
// (Aᵀ); out: (nb, n) int32 counts. All on `device`. Returns a cudaError_t.
extern "C" int child_count(const float* tw, const float* at, int* out, int nb,
                           int n, int splits, int device,
                           cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (splits > 1) {
    err = cudaMemsetAsync(out, 0, static_cast<size_t>(nb) * n * sizeof(int),
                          stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n + BN - 1) / BN, (nb + BM - 1) / BM, splits);
  if (n % 4 == 0 && aligned16(tw) && aligned16(at)) {
    child_count_kernel<true><<<grid, THREADS, 0, stream>>>(tw, at, out, nb, n);
  } else {
    child_count_kernel<false><<<grid, THREADS, 0, stream>>>(tw, at, out, nb,
                                                            n);
  }
  return static_cast<int>(cudaGetLastError());
}
