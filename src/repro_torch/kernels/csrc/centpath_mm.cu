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
// What bounds it on the H100: max-minus has no tensor-core form, so every
// candidate cell is CUDA-core work. Counting one ⊗ and one ⊕ per cell, a
// relaxation is 2·nb·n·n2 operations at 67 TFLOP/s float32, against
// (2·nb·n + n·n2 + 3·nb·n2)·4 bytes at 3.35 TB/s; at nb = 64 the
// operations bound is the larger, so the kernel is compute-bound, with
// three accumulators per cell (w, p and c).
//
// What the design does about it: the same tiling as multpath_mm.cu. One
// block of 128 threads owns a 32x64 output tile with a 4x4 register
// micro-tile of (w, p, c) per thread; F's (w, p) and B's tiles are staged
// in shared memory; k is swept in ascending order inside the block, so no
// state crosses blocks. The finiteness guard of the plain version,
//   cand = (isfinite(fw) && isfinite(b)) ? fw - b : -inf,
// is hoisted to the tile load: a non-finite F.w loads as -inf and a
// non-finite B entry as +inf, and then fw - b is that same cand for every
// input (-inf - x = -inf, x - inf = -inf, -inf - inf = -inf), so the hot
// loop does one subtraction. Ragged edges load as identities too: F as
// (-inf, 0), B as +inf; nothing is padded per call. w and c are bitwise
// equal to the plain version; p differs only by the order of tie sums.
// Runs on the caller's stream, allocates nothing, returns
// cudaGetLastError(); built without --use_fast_math.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int BM = 32;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 128
constexpr int FPAD = 4;

__device__ __forceinline__ void cp_relax(float& accw, float& accp,
                                         float& accc, float cand, float p) {
  const bool better = cand > accw;
  const bool tie = (cand == accw) && isfinite(cand);
  accp = better ? p : (tie ? accp + p : accp);
  accc = better ? 1.f : (tie ? accc + 1.f : accc);
  accw = fmaxf(accw, cand);
}

__global__ void __launch_bounds__(THREADS)
centpath_mm_kernel(const float* __restrict__ fw, const float* __restrict__ fp,
                   const float* __restrict__ b, float* __restrict__ cw,
                   float* __restrict__ cp, float* __restrict__ cc, int nb,
                   int n, int n2) {
  __shared__ __align__(16) float sfw[BK][BM + FPAD];
  __shared__ __align__(16) float sfp[BK][BM + FPAD];
  __shared__ __align__(16) float sb[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

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

  for (int k0 = 0; k0 < n; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK;
      const int c = e % BK;
      const int gr = row0 + r;
      const int gk = k0 + c;
      const bool in = gr < nb && gk < n;
      const size_t off = static_cast<size_t>(gr) * n + gk;
      const float w = in ? fw[off] : -CUDART_INF_F;
      sfw[c][r] = isfinite(w) ? w : -CUDART_INF_F;
      sfp[c][r] = in ? fp[off] : 0.f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN;
      const int c = e % BN;
      const int gk = k0 + r;
      const int gc = col0 + c;
      const float v = (gk < n && gc < n2)
                          ? b[static_cast<size_t>(gk) * n2 + gc]
                          : CUDART_INF_F;
      sb[r][c] = isfinite(v) ? v : CUDART_INF_F;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 w4 = *reinterpret_cast<const float4*>(&sfw[kk][ty * TM]);
      const float4 p4 = *reinterpret_cast<const float4*>(&sfp[kk][ty * TM]);
      const float4 b4 = *reinterpret_cast<const float4*>(&sb[kk][tx * TN]);
      const float fwv[TM] = {w4.x, w4.y, w4.z, w4.w};
      const float fpv[TM] = {p4.x, p4.y, p4.z, p4.w};
      const float bv[TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          cp_relax(accw[i][j], accp[i][j], accc[i][j], fwv[i] - bv[j],
                   fpv[i]);
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
        cp[off] = accp[i][j];
        cc[off] = accc[i][j];
      }
    }
  }
}

}  // namespace

// fw, fp: (nb, n) row-major float32; b: (n, n2) row-major float32 (Aᵀ on
// the main path); cw, cp, cc: (nb, n2) outputs. All on `device`. Returns a
// cudaError_t.
extern "C" int centpath_mm(const float* fw, const float* fp, const float* b,
                           float* cw, float* cp, float* cc, int nb, int n,
                           int n2, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n2 + BN - 1) / BN, (nb + BM - 1) / BM);
  centpath_mm_kernel<<<grid, THREADS, 0, stream>>>(fw, fp, b, cw, cp, cc, nb,
                                                   n, n2);
  return static_cast<int>(cudaGetLastError());
}
