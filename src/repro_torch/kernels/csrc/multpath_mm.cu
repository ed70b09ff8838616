// Multpath min-plus product on Hopper (sm_90a): the MFBF Bellman-Ford
// action C = F •_(⊕,f) A of paper Algorithm 1,
//
//   C.w(i,j) = min_k F.w(i,k) + A(k,j)
//   C.m(i,j) = Σ_k F.m(i,k) · [F.w(i,k) + A(k,j) == C.w(i,j), finite]
//
// Replaces the TPU kernel src/repro/kernels/tropical_mm.py
// ::multpath_matmul_pallas (body _kernel).
//
// What bounds it on the H100: min-plus has no tensor-core form, so every
// candidate cell is CUDA-core work: one add and one min-select with a
// tie test. Counting one ⊗ and one ⊕ per cell as a GEMM does, a
// relaxation is 2·nb·n·n2 operations at the card's 67 TFLOP/s float32
// rate, against (2·nb·n + n·n2 + 2·nb·n2)·4 bytes at 3.35 TB/s. At the
// main path's nb = 64 the operations bound is the larger (about 1.5x the
// bytes bound), so the kernel is compute-bound; each cell costs about six
// instructions (add, two compares, finiteness test, select, min).
//
// What the design does about it:
// - One block of 128 threads owns a 32x64 output tile; each thread keeps
//   a 4x4 register micro-tile of (w, m) accumulators, so one k step reads
//   three float4s from shared memory for 16 cells. The k loop runs inside
//   the block (it replaces the TPU's sequential k grid axis and its
//   revisited output block); no state crosses blocks, so there are no
//   atomics and no second pass.
// - F's (w, m) tiles (BM x BK, stored k-major) and A's BK x BN tile are
//   staged in shared memory; the 3-D candidate block never exists.
// - Ragged edges are masked at the tile load: out-of-range F entries load
//   as the monoid identity (inf, 0) and out-of-range A entries as inf.
//   Nothing is padded per call (padding A at n = 12536 would copy about
//   0.63 GB on every relaxation).
// - Each thread sweeps k in ascending order, as the TPU kernel does, so w
//   is bitwise equal to the plain version and m differs only by the
//   order of the tie sums.
// - The launch runs on the caller's stream, allocates nothing and returns
//   cudaGetLastError(). Built without --use_fast_math: the semantics rest
//   on exact IEEE inf arithmetic and bitwise-equal weights.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BM = 32;    // output rows (batch) per block
constexpr int BN = 64;    // output columns per block
constexpr int BK = 16;    // contraction depth per shared-memory tile
constexpr int TM = 4;     // rows per thread
constexpr int TN = 4;     // columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 128
constexpr int FPAD = 4;   // keeps the transposed F stores off one bank

__device__ __forceinline__ void mp_relax(float& accw, float& accm, float cand,
                                         float m) {
  const bool better = cand < accw;
  const bool tie = (cand == accw) && isfinite(cand);
  accm = better ? m : (tie ? accm + m : accm);
  accw = fminf(accw, cand);
}

__global__ void __launch_bounds__(THREADS)
multpath_mm_kernel(const float* __restrict__ fw, const float* __restrict__ fm,
                   const float* __restrict__ a, float* __restrict__ cw,
                   float* __restrict__ cm, int nb, int n, int n2) {
  __shared__ __align__(16) float sfw[BK][BM + FPAD];
  __shared__ __align__(16) float sfm[BK][BM + FPAD];
  __shared__ __align__(16) float sa[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // column group of this thread
  const int ty = tid / (BN / TN);  // row group of this thread
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

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

  for (int k0 = 0; k0 < n; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK;
      const int c = e % BK;
      const int gr = row0 + r;
      const int gk = k0 + c;
      const bool in = gr < nb && gk < n;
      const size_t off = static_cast<size_t>(gr) * n + gk;
      sfw[c][r] = in ? fw[off] : CUDART_INF_F;
      sfm[c][r] = in ? fm[off] : 0.f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN;
      const int c = e % BN;
      const int gk = k0 + r;
      const int gc = col0 + c;
      sa[r][c] = (gk < n && gc < n2)
                     ? a[static_cast<size_t>(gk) * n2 + gc]
                     : CUDART_INF_F;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 w4 = *reinterpret_cast<const float4*>(&sfw[kk][ty * TM]);
      const float4 m4 = *reinterpret_cast<const float4*>(&sfm[kk][ty * TM]);
      const float4 a4 = *reinterpret_cast<const float4*>(&sa[kk][tx * TN]);
      const float fwv[TM] = {w4.x, w4.y, w4.z, w4.w};
      const float fmv[TM] = {m4.x, m4.y, m4.z, m4.w};
      const float av[TN] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          mp_relax(accw[i][j], accm[i][j], fwv[i] + av[j], fmv[i]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty * TM + i;
    if (gr >= nb) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx * TN + j;
      if (gc < n2) {
        const size_t off = static_cast<size_t>(gr) * n2 + gc;
        cw[off] = accw[i][j];
        cm[off] = accm[i][j];
      }
    }
  }
}

}  // namespace

// fw, fm: (nb, n) row-major float32; a: (n, n2) row-major float32;
// cw, cm: (nb, n2) outputs. All on `device`. Returns a cudaError_t.
extern "C" int multpath_mm(const float* fw, const float* fm, const float* a,
                           float* cw, float* cm, int nb, int n, int n2,
                           int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n2 + BN - 1) / BN, (nb + BM - 1) / BM);
  multpath_mm_kernel<<<grid, THREADS, 0, stream>>>(fw, fm, a, cw, cm, nb, n,
                                                   n2);
  return static_cast<int>(cudaGetLastError());
}
