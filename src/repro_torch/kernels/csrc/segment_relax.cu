// The sparse relax of the COO and CSR backends on Hopper (sm_90a): the
// gather, the segment min (MFBF) or max (MFBr) and the ordered tie sums of
// paper Algorithms 1 and 2, in one call. For the arcs grouped into runs,
// run v = [offsets[v], offsets[v+1]), each arc e reading frontier column
// col[e] with weight w[e]:
//
//   MFBF  cand(s,e) = Fw(s,col[e]) + w[e]
//         best(s,v) = min over run v;  m = Σ_{e ascending, cand == best,
//         finite} Fm(s,col[e]);        w_out = m > 0 ? best : inf
//   MFBr  cand(s,e) = isfinite(Fw) && isfinite(w) ? Fw(s,col[e]) - w[e]
//                     : -inf
//         best = max over run v;  p = the same ordered sum of Fp, c = the
//         number of ties;         w_out = c > 0 ? best : -inf
//
// Replaces, on the card, the plain body of monoids._multpath_relax_runs /
// _centpath_relax_runs: the (nb, L) index_selects of F, the scatter_reduce
// amin/amax of _segment_extreme and the tie-masked sum (kernels/ref.py);
// the reference computes the same function with jax.ops.segment_min/max
// and jax.ops.segment_sum (src/repro/core/monoids.py:219-251, :315-374).
// No Pallas kernel stands behind it.
//
// The order of the sums. The plain version adds each (row, run)'s ties one
// at a time in ascending arc order, from +0.0, as the reference's CPU
// segment_sum does; the compacted CSR relax then equals its COO fallback
// bitwise and a row's sums do not depend on the rows beside it. Here the
// min/max, which is exact in any order, is taken in parallel, but no sum
// is ever split into partial sums combined later: every sum adds its ties
// one at a time in arc order, from +0.0. Skipping a non-tie is bitwise the
// plain version's "+ 0.0" (an accumulator that starts at +0.0 is never
// -0.0). Runs never read past offsets[n], so the COO padding tail and the
// CSR dead slots cost nothing.
//
// What bounds it on the H100: bytes. col (8 B) and w (4 B) per arc, the
// offsets, F's two fields once and the 2 or 3 outputs cross DRAM; about 5
// instructions per (row, arc) stay below that at 33.5 T/s. The gathers of
// F are served by the 50 MB L2 (F is 11.1 MB a field at nb = 16, n =
// 173,847). What the design does:
// - Rows share the arc metadata. A prep pass writes F as G(v, s) =
//   (Fw(s,v), F2(s,v)) float2 pairs, (n, nb) row-major. Lanes index rows:
//   a group of R lanes (R = nb rounded up to a power of two, at most 32)
//   walks one run, each lane one row, so col[e] and w[e] are one broadcast
//   load for the group and the gather of both fields of all its rows is
//   one contiguous 8·R-byte line. Lanes over arcs would touch 32 lines per
//   load and reload the metadata for every row.
// - Short runs (length <= threshold), packed 32/R to a warp: each lane
//   walks its row of the run in arc order with the monoid's own online
//   update (a strictly better candidate resets the sum to +0.0, a finite
//   tie adds), which is the plain version's ordered sum of the final
//   best's ties; UNROLL gathers at a time, the next UNROLL arcs' col/w in
//   flight behind them.
// - Long runs get a block each (R-MAT scale 18 has degrees up to 25,231).
//   The prep pass bins them on the device (no host sync), those longer
//   than HUGE_RUN first; the first blocks of the launch take them one at a
//   time from a counter, so the longest start first. The run's col/w are
//   staged through shared memory in CHUNK-arc rounds, the next round
//   copied by cp.async while the current one is used (the block barrier
//   each round needs anyway is the copies' barrier). Each lane owns a
//   stripe of R consecutive arcs of a round. Pass 1 takes the min/max
//   over the stripes, then across them in shared memory. Pass 2 tests the
//   ties in parallel and compacts them in arc order: each (stripe, row)
//   flags its ties as the bits of one word and keeps the first TIE_SLOTS
//   values; when the round has any tie (__syncthreads_or) one lane per
//   row walks its row's words stripe by stripe and bit by bit, i.e. in
//   arc order, adding each value one at a time (a tie past the kept ones
//   is loaded again). Ties are rare with weights 1-100; an all-ties run
//   (an unweighted graph) serialises its adds, not its passes.
// - What is left (PERF.md §6): the blocks are latency-bound, a long run's
//   most, and the 25,231-arc run alone costs most of a whole call on its
//   one SM (tools/torch_segment_relax_sweep.py); splitting such a run over
//   blocks needs an ordered hand-off of the running sum between them.
// Runs on the caller's stream, allocates nothing (the wrapper passes the
// scratch), returns cudaGetLastError(). Built without --use_fast_math: the
// adds must be plain IEEE single adds in program order.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

// The constants below were the fastest of the variants tried at R-MAT
// scale 18's shapes on an H100: more blocks per SM cap the registers and
// spill, more staging stages or long-run blocks per SM gained nothing.
constexpr int THREADS = 256;
constexpr int MIN_BLOCKS = 3;   // blocks per SM: 80 registers, no spills
constexpr int CHUNK = THREADS;  // arcs of a long run staged per round
constexpr int STAGES = 2;       // rounds in the staging ring
constexpr int TIE_SLOTS = 4;    // tie values a long-run lane keeps a round
constexpr int UNROLL = 8;       // arcs a short-run lane loads ahead
constexpr int UNROLL_LONG = 16;      // gathers a long-run lane issues at once
constexpr int HUGE_RUN = 8 * CHUNK;  // long runs binned to the list's front
constexpr int LONG_BLOCKS_PER_SM = 2;
constexpr int TILE = 32;        // the prep pass's transpose tile
// The list scratch: three counters, then cap entries.
constexpr int N_HUGE = 0, N_LONG = 1, NEXT = 2, HEAD = 3;

// One long-run block's shared memory. A round has S = THREADS/R stripes of
// T = R arcs (S·T = CHUNK); slot (stripe, row) is thread stripe·R + row =
// threadIdx.x. Its ties in the round are the set bits of flags[slot] (bit
// t for the stripe's arc t), the first TIE_SLOTS of their values at
// vals[slot·TIE_SLOTS + j].
struct LongSmem {
  int64_t col[STAGES][CHUNK];
  float w[STAGES][CHUNK];
  unsigned flags[THREADS];
  float vals[THREADS * TIE_SLOTS];
  float part[THREADS];
  float best[32];
  int64_t run;
};
static_assert(sizeof(LongSmem) <= 48 * 1024, "static shared memory");

template <bool MP>
struct Op {
  // The monoid's identity: an inactive entry's weight.
  static __device__ __forceinline__ float ident() {
    return MP ? CUDART_INF_F : -CUDART_INF_F;
  }
  static __device__ __forceinline__ float cand(float fw, float w) {
    if (MP) return fw + w;
    return (isfinite(fw) && isfinite(w)) ? fw - w : -CUDART_INF_F;
  }
  static __device__ __forceinline__ bool better(float c, float best) {
    return MP ? c < best : c > best;
  }
};

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Run v's arcs, clamped to [0, len) and to lo <= hi, so a malformed
// offsets array cannot read out of bounds. The prep pass and the relax use
// the same bounds, so they agree on which runs are long.
__device__ __forceinline__ void run_bounds(const int64_t* offsets, int64_t v,
                                           int64_t len, int64_t& lo,
                                           int64_t& hi) {
  const int64_t a = offsets[v], b = offsets[v + 1];
  lo = a < 0 ? 0 : (a > len ? len : a);
  hi = b < lo ? lo : (b > len ? len : b);
}

// The (w, x) pair of row s at column c, the identity for a column outside
// [0, n) (never given by a well-formed Runs).
template <bool MP>
__device__ __forceinline__ float2 gather(const float2* __restrict__ g,
                                         int64_t c, int s, int nb, int n) {
  return static_cast<uint64_t>(c) < static_cast<uint64_t>(n)
             ? g[c * nb + s]
             : make_float2(Op<MP>::ident(), 0.0f);
}

template <bool MP>
__device__ __forceinline__ void write_out(float* out_w, float* out_x,
                                          float* out_c, int64_t o, float best,
                                          float acc, float cnt) {
  if (MP) {
    out_w[o] = acc > 0.0f ? best : CUDART_INF_F;
    out_x[o] = acc;
  } else {
    out_w[o] = cnt > 0.0f ? best : -CUDART_INF_F;
    out_x[o] = acc;
    out_c[o] = cnt;
  }
}

// Prep: blocks [0, tiles) transpose F into G; the rest bin the runs longer
// than threshold, those longer than HUGE_RUN from the front of the list's
// entries, the others from the back.
__global__ void __launch_bounds__(THREADS) segment_relax_prep(
    const float* __restrict__ fw, const float* __restrict__ f2,
    float2* __restrict__ g, const int64_t* __restrict__ offsets,
    int* __restrict__ list, int cap, int nb, int n, int64_t len,
    int threshold, int tiles_v, int tiles) {
  __shared__ float tw[TILE][TILE + 1];
  __shared__ float tx[TILE][TILE + 1];
  const int b = blockIdx.x;
  if (b < tiles) {
    const int v0 = (b % tiles_v) * TILE;
    const int s0 = (b / tiles_v) * TILE;
    const int c = threadIdx.x % TILE;
    for (int i = threadIdx.x / TILE; i < TILE; i += THREADS / TILE) {
      const int s = s0 + i, v = v0 + c;
      if (s < nb && v < n) {
        const int64_t o = static_cast<int64_t>(s) * n + v;
        tw[i][c] = fw[o];
        tx[i][c] = f2[o];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x / TILE; i < TILE; i += THREADS / TILE) {
      const int v = v0 + i, s = s0 + c;
      if (s < nb && v < n) {
        g[static_cast<int64_t>(v) * nb + s] = make_float2(tw[c][i], tx[c][i]);
      }
    }
    return;
  }
  const int64_t v = static_cast<int64_t>(b - tiles) * THREADS + threadIdx.x;
  if (v >= n) return;
  int64_t lo, hi;
  run_bounds(offsets, v, len, lo, hi);
  if (hi - lo > threshold) {
    // the long runs number at most cap, so the two ends never meet
    if (hi - lo > HUGE_RUN) {
      const int j = atomicAdd(list + N_HUGE, 1);
      if (j < cap) list[HEAD + j] = static_cast<int>(v);
    } else {
      const int j = atomicAdd(list + N_LONG, 1);
      if (j < cap) list[HEAD + cap - 1 - j] = static_cast<int>(v);
    }
  }
}

// A short run: lane r of the group takes rows r, r + R, ...
template <bool MP>
__device__ void short_run(const float2* __restrict__ g,
                          const int64_t* __restrict__ col,
                          const float* __restrict__ w, int64_t v, int64_t lo,
                          int64_t hi, int r, int R, int nb, int n,
                          float* out_w, float* out_x, float* out_c) {
  for (int s = r; s < nb; s += R) {
    float best = Op<MP>::ident(), acc = 0.0f, cnt = 0.0f;
    int64_t cn[UNROLL];
    float wn[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool in = lo + u < hi;
      cn[u] = in ? col[lo + u] : int64_t(-1);
      wn[u] = in ? w[lo + u] : 0.0f;
    }
    for (int64_t e0 = lo; e0 < hi; e0 += UNROLL) {
      int64_t c[UNROLL];
      float wv[UNROLL];
      float2 x[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        c[u] = cn[u];
        wv[u] = wn[u];
      }
      // the next batch's metadata in flight behind this one's gathers
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t e = e0 + UNROLL + u;
        cn[u] = e < hi ? col[e] : int64_t(-1);
        wn[u] = e < hi ? w[e] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) x[u] = gather<MP>(g, c[u], s, nb, n);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (e0 + u < hi) {
          const float cd = Op<MP>::cand(x[u].x, wv[u]);
          if (Op<MP>::better(cd, best)) {
            best = cd;
            acc = 0.0f;
            cnt = 0.0f;
          }
          if (cd == best && isfinite(cd)) {
            acc += x[u].y;
            cnt += 1.0f;
          }
        }
      }
    }
    write_out<MP>(out_w, out_x, out_c, static_cast<int64_t>(s) * n + v, best,
                  acc, cnt);
  }
}

// A long run's col/w stream through shared memory, CHUNK arcs a round, in
// a ring of STAGES buffers: the copies of the next STAGES - 1 rounds are in
// flight while the current one is used. Round k's copies, one commit
// group per round (empty past the end, so the group count stays exact):
__device__ __forceinline__ void ring_issue(LongSmem& sm,
                                           const int64_t* __restrict__ col,
                                           const float* __restrict__ w,
                                           int64_t lo, int64_t hi,
                                           int64_t k) {
  const int64_t e = lo + k * CHUNK + threadIdx.x;
  if (e < hi) {
    cp_async8(&sm.col[k % STAGES][threadIdx.x], col + e);
    cp_async4(&sm.w[k % STAGES][threadIdx.x], w + e);
  }
  cp_commit();
}

// Wait for round k, start round k + STAGES - 1 in round k - 1's buffer
// (every thread is past round k - 1 at the barrier); returns k's buffer.
__device__ __forceinline__ int ring_next(LongSmem& sm,
                                         const int64_t* __restrict__ col,
                                         const float* __restrict__ w,
                                         int64_t lo, int64_t hi, int64_t k) {
  cp_wait<STAGES - 2>();
  __syncthreads();
  ring_issue(sm, col, w, lo, hi, k + STAGES - 1);
  return static_cast<int>(k % STAGES);
}

// The candidates of lane (stripe, row s)'s arcs t0 .. t0 + UNROLL_LONG - 1
// of round buffer buf starting at arc b0; x[u].y is the tie value.
template <bool MP>
__device__ __forceinline__ void round_cands(
    const LongSmem& sm, const float2* __restrict__ g, int buf, int64_t b0,
    int64_t hi, int stripe, int T, int t0, int s, bool act, int nb, int n,
    float (&cd)[UNROLL_LONG], float2 (&x)[UNROLL_LONG]) {
#pragma unroll
  for (int u = 0; u < UNROLL_LONG; ++u) {
    const int el = stripe * T + t0 + u;
    const bool in = act && t0 + u < T && b0 + el < hi;
    x[u] = in ? gather<MP>(g, sm.col[buf][el], s, nb, n)
              : make_float2(Op<MP>::ident(), 0.0f);
    cd[u] = Op<MP>::cand(x[u].x, in ? sm.w[buf][el] : 0.0f);
  }
}

// A long run: the whole block, one row tile of R rows after another.
// Lane (stripe, r) takes arcs stripe·T .. stripe·T + T - 1 of each round.
template <bool MP>
__device__ void long_run(LongSmem& sm, const float2* __restrict__ g,
                         const int64_t* __restrict__ col,
                         const float* __restrict__ w, int64_t v, int64_t lo,
                         int64_t hi, int R, int nb, int n, float* out_w,
                         float* out_x, float* out_c) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r = lane % R;
  const int stripe = (tid >> 5) * (32 / R) + lane / R;
  const int S = THREADS / R;  // stripes; each holds T = R arcs a round
  const int T = R;
  const int64_t rounds = (hi - lo + CHUNK - 1) / CHUNK;
  for (int s0 = 0; s0 < nb; s0 += R) {
    const int s = s0 + r;
    const bool act = s < nb;
    // pass 1: the min/max, exact in any order
    float best = Op<MP>::ident();
    for (int k = 0; k < STAGES - 1; ++k) ring_issue(sm, col, w, lo, hi, k);
    for (int64_t k = 0; k < rounds; ++k) {
      const int buf = ring_next(sm, col, w, lo, hi, k);
      for (int t0 = 0; t0 < T; t0 += UNROLL_LONG) {
        float cd[UNROLL_LONG];
        float2 x[UNROLL_LONG];
        round_cands<MP>(sm, g, buf, lo + k * CHUNK, hi, stripe, T, t0, s,
                        act, nb, n, cd, x);
#pragma unroll
        for (int u = 0; u < UNROLL_LONG; ++u) {
          if (Op<MP>::better(cd[u], best)) best = cd[u];
        }
      }
    }
    cp_wait<0>();
    sm.part[tid] = best;
    __syncthreads();
    if (tid < R) {
      float b = Op<MP>::ident();
      for (int q = 0; q < S; ++q) {
        const float p = sm.part[q * R + tid];
        if (Op<MP>::better(p, b)) b = p;
      }
      sm.best[tid] = b;
    }
    __syncthreads();
    // pass 2: the ties, compacted in arc order, added one at a time: each
    // (stripe, row) flags its ties and keeps the first values, and when the
    // round has any, lane r < R walks row s0 + r's slots stripe by stripe
    // and bit by bit, i.e. in arc order
    const float bs = sm.best[r];
    float acc = 0.0f, cnt = 0.0f;  // live in threads tid < R (row s0 + tid)
    for (int k = 0; k < STAGES - 1; ++k) ring_issue(sm, col, w, lo, hi, k);
    for (int64_t k = 0; k < rounds; ++k) {
      const int buf = ring_next(sm, col, w, lo, hi, k);
      unsigned flags = 0;
      int nt = 0;
      for (int t0 = 0; t0 < T; t0 += UNROLL_LONG) {
        float cd[UNROLL_LONG];
        float2 x[UNROLL_LONG];
        round_cands<MP>(sm, g, buf, lo + k * CHUNK, hi, stripe, T, t0, s,
                        act, nb, n, cd, x);
#pragma unroll
        for (int u = 0; u < UNROLL_LONG; ++u) {
          if (cd[u] == bs && isfinite(cd[u])) {
            flags |= 1u << (t0 + u);
            if (nt < TIE_SLOTS) sm.vals[tid * TIE_SLOTS + nt] = x[u].y;
            ++nt;
          }
        }
      }
      sm.flags[tid] = flags;
      if (__syncthreads_or(flags != 0) && tid < R && s0 + tid < nb) {
        for (int q = 0; q < S; ++q) {
          const int slot = q * R + tid;
          int j = 0;
          for (unsigned m = sm.flags[slot]; m != 0; m &= m - 1, ++j) {
            // past the kept values (a tie-heavy round), load it again
            acc += j < TIE_SLOTS
                       ? sm.vals[slot * TIE_SLOTS + j]
                       : gather<MP>(g, sm.col[buf][q * T + __ffs(m) - 1],
                                    s0 + tid, nb, n).y;
            cnt += 1.0f;
          }
        }
      }
    }
    cp_wait<0>();
    if (tid < R && s0 + tid < nb) {
      write_out<MP>(out_w, out_x, out_c,
                    static_cast<int64_t>(s0 + tid) * n + v, sm.best[tid], acc,
                    cnt);
    }
    __syncthreads();  // the ring and sm.best are reused next
  }
}

// Blocks [0, long_blocks) take the binned long runs one at a time from a
// shared counter, the huge ones first; each block after them takes
// THREADS/R consecutive runs, one per group of R lanes, and leaves the
// long ones.
template <bool MP>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS) segment_relax_main(
    const float2* __restrict__ g, const int64_t* __restrict__ col,
    const float* __restrict__ w, const int64_t* __restrict__ offsets,
    int* __restrict__ list, int cap, float* __restrict__ out_w,
    float* __restrict__ out_x, float* __restrict__ out_c, int nb, int n,
    int64_t len, int threshold, int R, int long_blocks) {
  __shared__ LongSmem sm;
  int64_t lo, hi;
  if (static_cast<int>(blockIdx.x) < long_blocks) {
    const int n_huge = min(list[N_HUGE], cap);
    const int todo = min(list[N_HUGE] + list[N_LONG], cap);
    while (true) {
      if (threadIdx.x == 0) {
        const int j = atomicAdd(list + NEXT, 1);
        sm.run = j >= todo ? -1
                 : list[HEAD + (j < n_huge ? j : cap - 1 - (j - n_huge))];
      }
      __syncthreads();
      const int64_t v = sm.run;
      __syncthreads();  // sm.run is rewritten by the next fetch
      if (v < 0) return;
      run_bounds(offsets, v, len, lo, hi);
      long_run<MP>(sm, g, col, w, v, lo, hi, R, nb, n, out_w, out_x, out_c);
    }
  }
  const int groups = THREADS / R;
  const int64_t v = static_cast<int64_t>(blockIdx.x - long_blocks) * groups +
                    threadIdx.x / R;
  if (v >= n) return;
  run_bounds(offsets, v, len, lo, hi);
  if (hi - lo > threshold) return;
  short_run<MP>(g, col, w, v, lo, hi, threadIdx.x % R, R, nb, n, out_w, out_x,
                out_c);
}

}  // namespace

// fw, f2: (nb, n) row-major (F.w and F.m for MFBF, F.w and F.p for MFBr);
// col (len,) int64 and w (len,) float32: the arcs grouped into runs;
// offsets (n + 1,) int64 non-decreasing. Scratch: g (n·nb float2), list
// (3 + cap ints), cap >= the number of runs longer than threshold. out_c
// is used by MFBr (centpath != 0) only.
extern "C" int segment_relax(int centpath, const float* fw, const float* f2,
                             const int64_t* col, const float* w,
                             const int64_t* offsets, float2* g, int* list,
                             int cap, float* out_w, float* out_x,
                             float* out_c, int nb, int n, long long len,
                             int threshold, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb <= 0 || n <= 0) return 0;
  if (threshold < 0 || cap < 0 || (centpath && out_c == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int R = 1;
  while (R < nb && R < 32) R *= 2;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(list, 0, HEAD * sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles_v = (n + TILE - 1) / TILE;
  const int tiles = tiles_v * ((nb + TILE - 1) / TILE);
  const int bins = (n + THREADS - 1) / THREADS;
  segment_relax_prep<<<tiles + bins, THREADS, 0, stream>>>(
      fw, f2, g, offsets, list, cap, nb, n, len, threshold, tiles_v, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int long_blocks =
      cap < LONG_BLOCKS_PER_SM * sms ? cap : LONG_BLOCKS_PER_SM * sms;
  const int groups = THREADS / R;
  const int blocks = long_blocks + (n + groups - 1) / groups;
  if (centpath) {
    segment_relax_main<false><<<blocks, THREADS, 0, stream>>>(
        g, col, w, offsets, list, cap, out_w, out_x, out_c, nb, n, len,
        threshold, R, long_blocks);
  } else {
    segment_relax_main<true><<<blocks, THREADS, 0, stream>>>(
        g, col, w, offsets, list, cap, out_w, out_x, out_c, nb, n, len,
        threshold, R, long_blocks);
  }
  return static_cast<int>(cudaGetLastError());
}
