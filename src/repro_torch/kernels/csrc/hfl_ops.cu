// Hand-written Hopper (sm_90a) kernels for the HFL round's hot path.
//
// Fuzzy scoring (the Eq. 21 normalisation and the frontier's gather fused
// into the launch), SIC rates (a thread-block cluster per edge) and local
// SGD (a thread-block cluster per lane, and a block per lane for the
// shapes the cluster kernel refuses), each behind a plain C entry point
// that launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().  The Python wrappers
// in kernels/hfl_ops.py check devices, types and shapes, allocate the
// outputs and raise on a non-zero return.
//
// Build (no --use_fast_math: the ranking parity of the fuzzy scores and
// the SIC rates depends on IEEE division, log10f, log2f and expf):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o build/hfl_ops.so hfl_ops.cu
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// ---------------------------------------------------------------------------
// Fused fuzzy scoring.
//
// Replaces: src/repro/kernels/hfl_ops.py::_score_kernel (:78), reached
// through _score_rows (:106) by score_matrix (:133) and score_candidates
// (:156).  The reference runs the Eq. 21 normalisation beside its Pallas
// call in plain XLA, which fuses it for free on a TPU; in eager PyTorch
// those ~20 small ops (log10, the global min/max, the gather, the
// broadcasts, the casts) cost far more host time than the kernel's device
// time.  So the normalisation and the frontier's gather run inside the
// launch here: score_norm_kernel then score_fused_kernel, behind one C
// call (hfl_score_fused), from the raw (N, M) gains, the (N,) counts, the
// (N,) int32 staleness and, on the frontier, the (N, K) int32 candidate
// edges.
//
// Bound on the H100: operations.  Each row reads 12 bytes and writes 4,
// but runs ~2.5k fp32 min/max/mul/add ops (9 memberships, the 27-rule
// Max-Min table, 5 x 201 Mamdani clips and the CoG sums) -- far above the
// card's ~20 ops/byte fp32 ridge point.  At the main path's sizes both
// launches are latency-bound: 0.013-0.014 ms of device time for the pair
// at CONFIG and at 4096 x 32 (H100 80GB HBM3, 700 W; chip_smoke.py, CUDA-
// graph replay), against ~0.07 ms for the torch chain and rows kernel it
// replaces; the rest of a call is the wrapper's host time.
//
// * score_norm_kernel (pass 1): a grid-stride reduction over the whole
//   (N, M) field -- min and max of 10 log10(max(g, 1e-30)) -- and over
//   staleness (its max), on the frontier too, as fuzzy.normalized_inputs
//   does.  Each block writes its partial (min dB, max dB, max staleness)
//   to a scratch buffer.
// * score_fused_kernel (pass 2): each block folds those partials (at most
//   kNormBlocksMax) -- min and max are exact in any order, so the result
//   is deterministic with no atomics -- then scores one row a thread: the
//   row's edge (its column, or cand_idx on the frontier), its Eq. 21
//   inputs, then score_row, the Mamdani pipeline that score_kernel (the
//   rows-only entry, kept as the counterpart of _score_rows) runs too.
// * Bit-equality: the normalisation repeats the torch ops it replaces on
//   the card in their order and float32 constants (clamp at 1e-30, log10f,
//   x 10, - lo, clamp the span at 1e-9 then 1e-12, IEEE divide, clamp to
//   [0, 1], x 100), with explicit __fmul_rn/__fdiv_rn/__fsub_rn so that no
//   multiply and add fuse into an FMA that torch rounds twice.  The row
//   pipeline keeps its fixed order: strengths use only min/max (exact in any
//   order); num and den are summed in the fixed order g = 0..200 with
//   explicit round-to-nearest mul/add, so the plain PyTorch version
//   (core/fuzzy.py) matches bit for bit.
// * A fleet: both launches take a grid row (blockIdx.y) a seed, each
//   seed's (N, M) gains, counts, staleness, candidate edges and rows at a
//   size_t seed stride, its own kNormBlocksMax-bounded partials.  A seed's
//   blocks do exactly what one seed's launch does, so each seed's scores
//   are the bits of its own call (no fleet-wide min/max).
// Layout: 256 threads a block, one (client, edge) row a thread.  The 5 x
// 201 output memberships (made once on the host in fp32), the 3 input
// triangles and the rule table are staged in shared memory per block; the
// CoG grid is g * 0.5, exact in fp32.
// ---------------------------------------------------------------------------

constexpr int kGrid = 201;
constexpr int kOut = 5;
constexpr int kRules = 27;
constexpr int kScoreBlock = 256;
// pass 1: at most this many blocks (partials), each thread taking at least
// kNormItems gains before another block is added
constexpr int kNormBlocksMax = 256;
constexpr int kNormItems = 4;

__device__ __forceinline__ float tri(float x, float a, float b, float c) {
  float up = __fdiv_rn(__fsub_rn(x, a), fmaxf(__fsub_rn(b, a), 1e-9f));
  float down = __fdiv_rn(__fsub_rn(c, x), fmaxf(__fsub_rn(c, b), 1e-9f));
  return fminf(fmaxf(fminf(up, down), 0.0f), 1.0f);
}

// The block's copy of the tables: tables = [3 input triangles (a, b, c) |
// 5 x 201 output memberships], rules = the 27-rule table.
struct ScoreSmem {
  float tri[9];
  float mu[kOut * kGrid];
  int rules[kRules];
};

__device__ __forceinline__ void stage_tables(ScoreSmem& s,
                                             const float* __restrict__ tables,
                                             const int* __restrict__ rules) {
  for (int i = threadIdx.x; i < kOut * kGrid; i += blockDim.x)
    s.mu[i] = tables[9 + i];
  if (threadIdx.x < 9) s.tri[threadIdx.x] = tables[threadIdx.x];
  if (threadIdx.x < kRules) s.rules[threadIdx.x] = rules[threadIdx.x];
}

// One row's NO* score from its normalised (cq, dq, ms): memberships, the
// Max-Min inference folded straight into the 5 output strengths (the
// output set is selected by value, so they stay in registers), the Mamdani
// clip + max aggregate and the centre of gravity over the grid.
__device__ __forceinline__ float score_row(const ScoreSmem& s, float v_cq,
                                           float v_dq, float v_ms) {
  float m_cq[3], m_dq[3], m_ms[3];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const float a = s.tri[3 * q], b = s.tri[3 * q + 1], c = s.tri[3 * q + 2];
    m_cq[q] = tri(v_cq, a, b, c);
    m_dq[q] = tri(v_dq, a, b, c);
    m_ms[q] = tri(v_ms, a, b, c);
  }
  float st[kOut];
#pragma unroll
  for (int o = 0; o < kOut; ++o) st[o] = 0.0f;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float deg = fminf(fminf(m_cq[i], m_dq[j]), m_ms[k]);
        const int set = s.rules[9 * i + 3 * j + k];
#pragma unroll
        for (int o = 0; o < kOut; ++o)
          st[o] = (set == o) ? fmaxf(st[o], deg) : st[o];
      }
  float num = 0.0f, den = 0.0f;
  for (int g = 0; g < kGrid; ++g) {
    float agg = fminf(s.mu[g], st[0]);
#pragma unroll
    for (int o = 1; o < kOut; ++o)
      agg = fmaxf(agg, fminf(s.mu[o * kGrid + g], st[o]));
    num = __fadd_rn(num, __fmul_rn(static_cast<float>(g) * 0.5f, agg));
    den = __fadd_rn(den, agg);
  }
  return __fdiv_rn(num, fmaxf(den, 1e-9f));
}

// The rows-only entry: (R,) normalised cq/dq/ms -> (R,) scores.
__global__ void score_kernel(const float* __restrict__ cq,
                             const float* __restrict__ dq,
                             const float* __restrict__ ms,
                             const float* __restrict__ tables,
                             const int* __restrict__ rules,
                             float* __restrict__ out, int rows) {
  __shared__ ScoreSmem s;
  stage_tables(s, tables, rules);
  __syncthreads();
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  out[r] = score_row(s, cq[r], dq[r], ms[r]);
}

// 10 log10(max(g, 1e-30)): torch's clamp_min, log10 (log10f for float) and
// the multiply by 10, each rounded once.
__device__ __forceinline__ float gain_db(float g) {
  return __fmul_rn(10.0f, log10f(fmaxf(g, 1e-30f)));
}

// core/fuzzy.py::normalize with a float32 denominator (already clamped at
// 1e-12): clamp(v / denom, 0, 1) * 100.
__device__ __forceinline__ float eq21(float v, float denom) {
  return __fmul_rn(fminf(fmaxf(__fdiv_rn(v, denom), 0.0f), 1.0f), 100.0f);
}

// Min (op 0) or max (op 1) of v over the block; every thread gets it.
template <int kMax>
__device__ __forceinline__ float block_fold(float v, float* s_warp) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : fminf(v, o);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();   // s_warp may still be read from a previous fold
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  v = s_warp[0];
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w)
    v = kMax ? fmaxf(v, s_warp[w]) : fminf(v, s_warp[w]);
  return v;
}

// Pass 1: partials[b], partials[P + b], partials[2P + b] = block b's min
// dB, max dB and max staleness (as float: the conversion is monotone, so
// the max of the floats is the float of the max), P = gridDim.x, for the
// seed blockIdx.y (its field of total = N * M gains, N staleness values
// and 3P partials).
__global__ void score_norm_kernel(const float* __restrict__ gains,
                                  const int* __restrict__ stale,
                                  float* __restrict__ partials, int total,
                                  int n) {
  __shared__ float s_warp[kScoreBlock / 32];
  const size_t seed = blockIdx.y;
  gains += seed * total;
  stale += seed * n;
  partials += seed * 3 * gridDim.x;
  float lo = CUDART_INF_F, hi = -CUDART_INF_F, smax = -CUDART_INF_F;
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const float d = gain_db(gains[i]);
    lo = fminf(lo, d);
    hi = fmaxf(hi, d);
  }
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride)
    smax = fmaxf(smax, static_cast<float>(stale[i]));
  lo = block_fold<0>(lo, s_warp);
  hi = block_fold<1>(hi, s_warp);
  smax = block_fold<1>(smax, s_warp);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = lo;
    partials[gridDim.x + blockIdx.x] = hi;
    partials[2 * gridDim.x + blockIdx.x] = smax;
  }
}

// Pass 2: fold the n_partials partials, then score rows r < n * w, w = k
// (the frontier: edge cand_idx[r]) or m (dense: edge r % m).  data_denom is
// max(data_max, 1e-12) in float32, as fuzzy.normalize makes it.  A
// candidate edge outside [0, m) scores NaN.  blockIdx.y is the seed, at
// the strides pass 1 uses.
__global__ void score_fused_kernel(const float* __restrict__ gains,
                                   const float* __restrict__ counts,
                                   const int* __restrict__ stale,
                                   const int* __restrict__ cand_idx,
                                   const float* __restrict__ partials,
                                   int n_partials,
                                   const float* __restrict__ tables,
                                   const int* __restrict__ rules,
                                   float* __restrict__ out, int n, int m,
                                   int w, float data_denom) {
  __shared__ ScoreSmem s;
  __shared__ float s_warp[kScoreBlock / 32];
  const size_t seed = blockIdx.y;
  gains += seed * n * m;
  counts += seed * n;
  stale += seed * n;
  if (cand_idx) cand_idx += seed * n * w;
  partials += seed * 3 * n_partials;
  out += seed * n * w;
  stage_tables(s, tables, rules);
  float lo = CUDART_INF_F, hi = -CUDART_INF_F, smax = -CUDART_INF_F;
  for (int q = threadIdx.x; q < n_partials; q += blockDim.x) {
    lo = fminf(lo, partials[q]);
    hi = fmaxf(hi, partials[n_partials + q]);
    smax = fmaxf(smax, partials[2 * n_partials + q]);
  }
  lo = block_fold<0>(lo, s_warp);   // its barriers also publish the tables
  hi = block_fold<1>(hi, s_warp);
  smax = block_fold<1>(smax, s_warp);
  // clamp_min(hi - lo, 1e-9), then normalize's clamp_min(., 1e-12);
  // clamp_min(max staleness, 1) as float, then the same 1e-12
  const float span = fmaxf(fmaxf(__fsub_rn(hi, lo), 1e-9f), 1e-12f);
  const float s_denom = fmaxf(fmaxf(smax, 1.0f), 1e-12f);

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n * w) return;
  const int i = r / w;
  const int e = cand_idx ? cand_idx[r] : r - i * w;
  if (e < 0 || e >= m) {
    out[r] = CUDART_NAN_F;
    return;
  }
  const float db = gain_db(gains[static_cast<size_t>(i) * m + e]);
  out[r] = score_row(s, eq21(__fsub_rn(db, lo), span),
                     eq21(counts[i], data_denom),
                     eq21(static_cast<float>(stale[i]), s_denom));
}

// ---------------------------------------------------------------------------
// NOMA SIC rates, each edge over its own clients.
//
// Replaces: src/repro/kernels/hfl_ops.py::_sic_kernel (:185, via sic_rates
// :216).  The reference (and the port's first, all-pairs kernel) runs the
// O(N^2) pairwise "decoded after me" test over all N clients of each edge;
// on the main path the mask is a one-hot association, at most
// clients_per_edge clients an edge, and every pair with an unmasked client
// adds an exact +0.0.
// Bound on the H100: the bytes of the (N, M) gains, mask and rates for a
// one-hot mask; for a dense one the 2 sum_e n_e^2 compare/add operations
// over each edge's n_e masked clients.
//
// The redesign:
// * Reads the caller's layout: power (N,) fp32, gains (N, M) fp32 and mask
//   (N, M) bool, both row-major, and writes the (N, M) rates in place --
//   no host transposes, casts or copies (the all-pairs wrapper made three).
// * One thread-block cluster of c CTAs per edge (c in {1, 2, 4, 8}, chosen
//   by the wrapper from N: kernels/hfl_ops.py::sic_cluster_size, the most
//   CTAs that keep a block's worth of clients each),
//   launched through cudaLaunchKernelEx.  CTA r compacts its contiguous
//   slice of the edge's clients, kSicItems per thread, with warp ballots
//   into its shared-memory list of (rx, client) in ascending client order,
//   and writes 0.0 for its unmasked clients.
// * The CTAs exchange their counts through distributed shared memory; the
//   edge's list is the concatenation of theirs in rank order, which is
//   ascending client order.  CTA r takes an even share of the list's
//   positions as its i's (wherever they live), G = 1, 2 or 4 consecutive
//   ones a thread (as many as keep its threads busy: G independent sums
//   hide the add's latency), and sums each one's interference over the
//   whole list, staged kSicChunk entries at a time from the owners'
//   shared memory into its own and read four at a time.
// * The weaker-than rule is the all-pairs kernel's: rx_j < rx_i, or on an
//   exact tie j > i -- in list positions, so the loop runs `<` before a
//   thread's positions and `<=` after them.  Each test is a PTX set
//   (1.0f or 0.0f into a register) and an fma adding x * that: a compare
//   into a predicate instead left the loop waiting on the few predicate
//   registers.
//   rx = p * g, exactly the all-pairs (p * g) * mask for a set mask.
//
// Invariant: each client's interference is summed with __fadd_rn in
// ascending j over the edge's masked clients only.  Every term the all-pairs
// kernel adds that the compaction drops is an exact +0.0 (an unmasked j has
// rx_j = +0.0; a j not weaker adds 0.0), and x + 0.0 == x for the
// non-negative partial sums, so each sum -- and so each rate -- is the same
// bits the all-pairs kernel gives, for finite inputs (the fma form too:
// 1 * x and 0 * x are exact).  Work per edge: O(N) reads and n_e^2 tests (<= 16
// at 4096 x 32 one-hot), against N^2 before.
// What bounds it now (H100 80GB HBM3, 700 W; chip_smoke.py, CUDA-graph
// replay): at the main path's one-hot mask, the launch and two cluster
// barriers over a strided read of each edge's column -- ~4 us at CONFIG,
// ~10 us at 4096 x 32, against the all-pairs kernel's ~0.2 ms there; at
// a dense 50% mask (4097 x 32), the compare-and-add rate of the pair loop,
// ~0.043 ms at 8 CTAs an edge, ~10x its operation bound.
// A fleet: the clusters of one seed form a grid row (blockIdx.y), each
// reading its seed's (N,) power and (N, M) gains and mask and writing its
// (N, M) rates at a size_t seed stride; the cluster size depends on N
// alone, so each seed's rates are the bits of its own launch.
// ---------------------------------------------------------------------------

constexpr int kSicThreads = 256;
constexpr int kSicWarps = kSicThreads / 32;
constexpr int kSicItems = 4;
constexpr int kSicChunk = 2048;
constexpr int kSicMaxCluster = 8;

// An edge's compacted list, spread over the cluster: rank q holds positions
// [off[q], off[q + 1]) as (rx, client) in its shared memory.
struct SicList {
  float* rx;         // this CTA's entries (mapped to a peer's by rank)
  int* idx;
  const int* off;    // [c + 1]
  float* chunk;      // this CTA's staging buffer, kSicChunk floats
  int c, total, m, e;

  __device__ int owner(int t) const {
    int q = 0;
    while (q + 1 < c && off[q + 1] <= t) ++q;
    return q;
  }
};

// 1.0f where a < b (a <= b), else 0.0f: PTX set, one instruction into a
// register.  Comparing into predicates instead leaves a compare and the
// add it guards waiting on one of a few predicate registers, which holds
// the loop to about one instruction a cycle an SM.
__device__ __forceinline__ float lt_one(float a, float b) {
  float d;
  asm("set.lt.f32.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float le_one(float a, float b) {
  float d;
  asm("set.le.f32.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// acc + x where take is 1.0f, acc where it is 0.0f, rounded once: take * x
// is exact (x, or +0.0 for a finite x >= 0), so this is __fadd_rn(acc, x)
// or acc + 0.0 == acc, the all-pairs kernel's bits.
__device__ __forceinline__ float add_if(float take, float x, float acc) {
  return __fmaf_rn(take, x, acc);
}

// Acc[u] += each list entry x at position t that is weaker than position
// p0 + u: x < rx_u before it, x <= rx_u after it (an exact tie decodes the
// lower client first).  Ascending t, one rounding an add: the all-pairs
// kernel's order.
template <int G>
__device__ __forceinline__ void sic_weaker_sum(const float* chunk, int cs,
                                               int ce, int p0,
                                               const float (&rx)[G],
                                               float (&acc)[G]) {
  // before p0: strictly weaker, four entries a shared-memory read
  const int ea = min(ce, p0);
  int t = cs;
  for (; t + 4 <= ea; t += 4) {
    const float4 v = *reinterpret_cast<const float4*>(chunk + (t - cs));
    const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int u = 0; u < G; ++u)
        acc[u] = add_if(lt_one(x[k], rx[u]), x[k], acc[u]);
  }
  for (; t < ea; ++t) {
    const float x = chunk[t - cs];
#pragma unroll
    for (int u = 0; u < G; ++u) acc[u] = add_if(lt_one(x, rx[u]), x, acc[u]);
  }
  // the thread's own G positions: the exact rule
  for (t = max(cs, p0); t < min(ce, p0 + G); ++t) {
    const float x = chunk[t - cs];
#pragma unroll
    for (int u = 0; u < G; ++u)
      if (x < rx[u] || (x == rx[u] && t > p0 + u))
        acc[u] = __fadd_rn(acc[u], x);
  }
  // after them: weaker or tied
  t = max(cs, p0 + G);
  for (; t < ce && ((t - cs) & 3); ++t) {
    const float x = chunk[t - cs];
#pragma unroll
    for (int u = 0; u < G; ++u) acc[u] = add_if(le_one(x, rx[u]), x, acc[u]);
  }
  for (; t + 4 <= ce; t += 4) {
    const float4 v = *reinterpret_cast<const float4*>(chunk + (t - cs));
    const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int u = 0; u < G; ++u)
        acc[u] = add_if(le_one(x[k], rx[u]), x[k], acc[u]);
  }
  for (; t < ce; ++t) {
    const float x = chunk[t - cs];
#pragma unroll
    for (int u = 0; u < G; ++u) acc[u] = add_if(le_one(x, rx[u]), x, acc[u]);
  }
}

// The rates of list positions [a, b), G consecutive positions a thread:
// the whole list staged kSicChunk entries at a time from the owners'
// shared memory, each position's interference summed over it.
template <int G>
__device__ __forceinline__ void sic_share(cooperative_groups::cluster_group& cl,
                                          const SicList& l, int a, int b,
                                          float bandwidth_hz, float noise_w,
                                          float* __restrict__ out) {
  for (int base = a; base < b; base += kSicThreads * G) {
    const int p0 = base + threadIdx.x * G;
    float rx[G], acc[G];
    int idx[G];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      rx[u] = 0.0f;
      acc[u] = 0.0f;
      idx[u] = 0;
      if (p0 + u < b) {
        const int q = l.owner(p0 + u);
        rx[u] = cl.map_shared_rank(l.rx, q)[p0 + u - l.off[q]];
        idx[u] = cl.map_shared_rank(l.idx, q)[p0 + u - l.off[q]];
      }
    }
    for (int cs = 0; cs < l.total; cs += kSicChunk) {
      const int ce = min(l.total, cs + kSicChunk);
      __syncthreads();   // the previous chunk has been read
      for (int t = cs + threadIdx.x; t < ce; t += kSicThreads) {
        const int q = l.owner(t);
        l.chunk[t - cs] = cl.map_shared_rank(l.rx, q)[t - l.off[q]];
      }
      __syncthreads();
      if (p0 < b) sic_weaker_sum<G>(l.chunk, cs, ce, p0, rx, acc);
    }
#pragma unroll
    for (int u = 0; u < G; ++u)
      if (p0 + u < b) {
        const float sinr = __fdiv_rn(rx[u], __fadd_rn(acc[u], noise_w));
        out[static_cast<size_t>(idx[u]) * l.m + l.e] =
            __fmul_rn(bandwidth_hz, log2f(__fadd_rn(1.0f, sinr)));
      }
  }
}

__global__ void __launch_bounds__(kSicThreads)
    sic_cluster_kernel(const float* __restrict__ power,
                       const float* __restrict__ gains,
                       const unsigned char* __restrict__ mask,
                       float* __restrict__ out, int n, int m, int slice,
                       float bandwidth_hz, float noise_w) {
  namespace cg = cooperative_groups;
  cg::cluster_group cl = cg::this_cluster();
  const int c = static_cast<int>(cl.dim_blocks().x);
  const int r = static_cast<int>(cl.block_rank());
  const int e = blockIdx.x / c;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t seed = blockIdx.y;
  power += seed * n;
  gains += seed * n * m;
  mask += seed * n * m;
  out += seed * n * m;

  extern __shared__ __align__(16) float sic_smem[];
  float* s_rx = sic_smem;                                  // [slice]
  int* s_idx = reinterpret_cast<int*>(sic_smem + slice);   // [slice]
  __shared__ __align__(16) float s_chunk[kSicChunk];
  __shared__ int s_warp[kSicItems * kSicWarps];
  __shared__ int s_count;
  __shared__ int s_off[kSicMaxCluster + 1];

  // 1. compact this CTA's slice [i0, i1) of the edge's clients
  const int i0 = min(n, r * slice), i1 = min(n, i0 + slice);
  const unsigned lanes_below = (1u << lane) - 1u;
  int count = 0;
  for (int base = i0; base < i1; base += kSicThreads * kSicItems) {
    bool on[kSicItems];
    float rx[kSicItems];
#pragma unroll
    for (int u = 0; u < kSicItems; ++u) {
      const int i = base + u * kSicThreads + threadIdx.x;
      on[u] = false;
      rx[u] = 0.0f;
      if (i < i1) {
        const size_t at = static_cast<size_t>(i) * m + e;
        on[u] = mask[at] != 0;
        rx[u] = __fmul_rn(power[i], gains[at]);
        if (!on[u]) out[at] = 0.0f;
      }
    }
    unsigned bal[kSicItems];
#pragma unroll
    for (int u = 0; u < kSicItems; ++u) {
      bal[u] = __ballot_sync(0xffffffffu, on[u]);
      if (lane == 0) s_warp[u * kSicWarps + warp] = __popc(bal[u]);
    }
    __syncthreads();
    // list order is (u, warp, lane): ascending client index
    int run = count;
#pragma unroll
    for (int u = 0; u < kSicItems; ++u) {
      int pre = run;
      for (int w = 0; w < kSicWarps; ++w) {
        const int k = s_warp[u * kSicWarps + w];
        pre += (w < warp) ? k : 0;
        run += k;
      }
      if (on[u]) {
        const int pos = pre + __popc(bal[u] & lanes_below);
        s_rx[pos] = rx[u];
        s_idx[pos] = base + u * kSicThreads + threadIdx.x;
      }
    }
    count = run;
    __syncthreads();   // s_warp is reused
  }
  if (threadIdx.x == 0) s_count = count;
  cl.sync();   // every CTA's list and count are complete

  // 2. the edge's list offsets: rank q's entries are positions
  //    [s_off[q], s_off[q + 1])
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int q = 0; q < c; ++q) {
      s_off[q] = acc;
      acc += *cl.map_shared_rank(&s_count, q);
    }
    s_off[c] = acc;
  }
  __syncthreads();
  const int total = s_off[c];

  // 3. this CTA's share of the positions, each summed over the whole list;
  //    G consecutive positions a thread, as many as the share needs to
  //    keep every thread busy
  const int a = static_cast<int>(static_cast<long long>(total) * r / c);
  const int b = static_cast<int>(static_cast<long long>(total) * (r + 1) / c);
  const SicList list{s_rx, s_idx, s_off, s_chunk, c, total, m, e};
  if (b - a > 2 * kSicThreads)
    sic_share<4>(cl, list, a, b, bandwidth_hz, noise_w, out);
  else if (b - a > kSicThreads)
    sic_share<2>(cl, list, a, b, bandwidth_hz, noise_w, out);
  else
    sic_share<1>(cl, list, a, b, bandwidth_hz, noise_w, out);
  // no CTA exits while a peer may still read its list
  cl.sync();
}

// ---------------------------------------------------------------------------
// Fused local SGD, one block per lane (the route for shapes that the
// cluster kernel below refuses).
//
// Replaces: src/repro/kernels/hfl_ops.py::_sgd_kernel (via local_sgd_step)
// at shapes whose per-CTA slice of the weights does not fit shared memory
// at any cluster size (kernels/hfl_ops.py::sgd_route): a very wide input
// or output layer.  Not on the main path.
// Layout: one block of 256 threads per lane, weights in global memory,
// updated in place in the output buffers (which start as a copy of the
// inputs); the step's activations and gradients -- h1p, h2p, dh2, dh1
// (B x H each) and the logits / dlogits (B x V) -- in dynamic shared
// memory.  Each of the tau1 steps computes dl, dh2 and dh1 from the
// step's old weights, synchronises, then applies all six updates, and
// synchronises again before the next step reads them.  It uses K of the
// 132 SMs and runs each forward output as one long dependent FMA chain
// over L2 loads: 1.0 ms at the paper config, where the cluster kernel
// takes its place.
// ---------------------------------------------------------------------------

constexpr int kSgdThreads = 256;

__global__ void sgd_kernel(float* __restrict__ w1, float* __restrict__ b1,
                           float* __restrict__ w2, float* __restrict__ b2,
                           float* __restrict__ w3, float* __restrict__ b3,
                           const float* __restrict__ bx,
                           const int* __restrict__ by, int k, int tau1,
                           int nb, int d_in, int h, int v, float lr,
                           float inv_b) {
  extern __shared__ float smem[];
  float* h1p = smem;
  float* h2p = h1p + nb * h;
  float* dh2 = h2p + nb * h;
  float* dh1 = dh2 + nb * h;
  float* dl = dh1 + nb * h;
  const int lane = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  float* W1 = w1 + static_cast<size_t>(lane) * d_in * h;
  float* B1 = b1 + static_cast<size_t>(lane) * h;
  float* W2 = w2 + static_cast<size_t>(lane) * h * h;
  float* B2 = b2 + static_cast<size_t>(lane) * h;
  float* W3 = w3 + static_cast<size_t>(lane) * h * v;
  float* B3 = b3 + static_cast<size_t>(lane) * v;

  for (int t = 0; t < tau1; ++t) {
    const size_t step = static_cast<size_t>(t) * k + lane;
    const float* x = bx + step * nb * d_in;
    const int* y = by + step * nb;
    // forward: h1p = x @ W1 + b1
    for (int idx = tid; idx < nb * h; idx += nt) {
      const int b = idx / h, j = idx - b * h;
      const float* xr = x + static_cast<size_t>(b) * d_in;
      float acc = 0.0f;
      for (int q = 0; q < d_in; ++q)
        acc = fmaf(xr[q], W1[static_cast<size_t>(q) * h + j], acc);
      h1p[idx] = acc + B1[j];
    }
    __syncthreads();
    // h2p = relu(h1p) @ W2 + b2
    for (int idx = tid; idx < nb * h; idx += nt) {
      const int b = idx / h, j = idx - b * h;
      float acc = 0.0f;
      for (int q = 0; q < h; ++q)
        acc = fmaf(fmaxf(h1p[b * h + q], 0.0f), W2[q * h + j], acc);
      h2p[idx] = acc + B2[j];
    }
    __syncthreads();
    // logits = relu(h2p) @ W3 + b3
    for (int idx = tid; idx < nb * v; idx += nt) {
      const int b = idx / v, j = idx - b * v;
      float acc = 0.0f;
      for (int q = 0; q < h; ++q)
        acc = fmaf(fmaxf(h2p[b * h + q], 0.0f), W3[q * v + j], acc);
      dl[idx] = acc + B3[j];
    }
    __syncthreads();
    // dl = (softmax(logits) - onehot) / B, one thread per row
    for (int b = tid; b < nb; b += nt) {
      float* row = dl + b * v;
      float zmax = row[0];
      for (int j = 1; j < v; ++j) zmax = fmaxf(zmax, row[j]);
      float sum = 0.0f;
      for (int j = 0; j < v; ++j) {
        const float e = expf(row[j] - zmax);
        row[j] = e;
        sum += e;
      }
      const int label = y[b];
      for (int j = 0; j < v; ++j)
        row[j] = (row[j] / sum - (j == label ? 1.0f : 0.0f)) * inv_b;
    }
    __syncthreads();
    // dh2 = (dl @ W3^T) * (h2p > 0)
    for (int idx = tid; idx < nb * h; idx += nt) {
      const int b = idx / h, j = idx - b * h;
      float acc = 0.0f;
      for (int q = 0; q < v; ++q) acc = fmaf(dl[b * v + q], W3[j * v + q], acc);
      dh2[idx] = h2p[idx] > 0.0f ? acc : 0.0f;
    }
    __syncthreads();
    // dh1 = (dh2 @ W2^T) * (h1p > 0)
    for (int idx = tid; idx < nb * h; idx += nt) {
      const int b = idx / h, j = idx - b * h;
      float acc = 0.0f;
      for (int q = 0; q < h; ++q) acc = fmaf(dh2[b * h + q], W2[j * h + q], acc);
      dh1[idx] = h1p[idx] > 0.0f ? acc : 0.0f;
    }
    // every gradient input above was computed from this step's old weights
    __syncthreads();
    for (int idx = tid; idx < d_in * h; idx += nt) {
      const int q = idx / h, j = idx - q * h;
      float acc = 0.0f;
      for (int b = 0; b < nb; ++b)
        acc = fmaf(x[static_cast<size_t>(b) * d_in + q], dh1[b * h + j], acc);
      W1[idx] = __fsub_rn(W1[idx], __fmul_rn(lr, acc));
    }
    for (int j = tid; j < h; j += nt) {
      float acc = 0.0f;
      for (int b = 0; b < nb; ++b) acc += dh1[b * h + j];
      B1[j] = __fsub_rn(B1[j], __fmul_rn(lr, acc));
    }
    for (int idx = tid; idx < h * h; idx += nt) {
      const int q = idx / h, j = idx - q * h;
      float acc = 0.0f;
      for (int b = 0; b < nb; ++b)
        acc = fmaf(fmaxf(h1p[b * h + q], 0.0f), dh2[b * h + j], acc);
      W2[idx] = __fsub_rn(W2[idx], __fmul_rn(lr, acc));
    }
    for (int j = tid; j < h; j += nt) {
      float acc = 0.0f;
      for (int b = 0; b < nb; ++b) acc += dh2[b * h + j];
      B2[j] = __fsub_rn(B2[j], __fmul_rn(lr, acc));
    }
    for (int idx = tid; idx < h * v; idx += nt) {
      const int q = idx / v, j = idx - q * v;
      float acc = 0.0f;
      for (int b = 0; b < nb; ++b)
        acc = fmaf(fmaxf(h2p[b * h + q], 0.0f), dl[b * v + j], acc);
      W3[idx] = __fsub_rn(W3[idx], __fmul_rn(lr, acc));
    }
    for (int j = tid; j < v; j += nt) {
      float acc = 0.0f;
      for (int b = 0; b < nb; ++b) acc += dl[b * v + j];
      B3[j] = __fsub_rn(B3[j], __fmul_rn(lr, acc));
    }
    // the next step reads the updated weights
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// Fused local SGD, one thread-block cluster per lane.
//
// Replaces: src/repro/kernels/hfl_ops.py::_sgd_kernel (via local_sgd_step),
// on every shape whose slices fit (kernels/hfl_ops.py::sgd_route).
// Bound on the H100: bytes.  At the paper config (K = 16 lanes, 784 -> 128
// -> 128 -> 10, B = 32, tau1 = 1) the function reads and writes each
// lane's 118,282 fp32 params and reads its 32 x 784 minibatch: 16.7 MB,
// 5.0 us at 3.35 TB/s, against 264 MFLOP (3.9 us at the 67 TFLOP/s fp32
// peak).  A lane-step is ~16 MFLOP, CUDA-core sized once it is spread over
// the card, so the kernel stays in fp32 FMAs (no tensor cores, no TF32)
// and spreads each lane over a cluster:
//
// * A cluster of c CTAs per lane, c in {1, 2, 4, 8} chosen by the wrapper
//   from the shape (kernels/hfl_ops.py::sgd_cluster_size): at the paper
//   config c = 8, 16 x 8 = 128 CTAs on the 132 SMs.  CTA r owns rows
//   [r*ceil(D/c), ...) of W1 (98 x 128 fp32 = 50 KB at the paper config)
//   and hidden units [r*H/c, (r+1)*H/c) of b1, W2 (columns) and b2.  They
//   live in shared memory for all tau1 steps and are written back once, as
//   the TPU kernel keeps a lane in VMEM.  W3 and b3 (H x V) are small:
//   every CTA holds them and computes the logits, the softmax
//   cross-entropy and the W3 update alike, and rank 0 writes them.
// * W1 is split by rows so that a CTA needs only its own columns of x (32
//   x 98 at the paper config), copied once into shared memory for the
//   forward and once more for dW1, each a single batch of cp.async copies.
//   The forward over those rows gives a partial h1p (B x H) that the
//   cluster reduce-scatters: CTA r sums its H/c columns over the ranks in
//   rank order.  Then the activations cross CTAs through distributed shared
//   memory: every CTA gathers the full relu(h1), computes its columns of
//   h2p, and gathers the full relu(h2).  dh2 is needed only on the own
//   columns; dh1 = dh2 W2^T is summed the same way from each CTA's partial
//   over its W2 columns, and the full dh1 gathered for the rows of dW1.
//   Remote reads are float4 where H/c allows, all of a thread's issued
//   before it uses any.  Five cluster barriers a step.
// * A CTA needs 104 KB at the paper config, so two fit an SM: the H100
//   then holds 30 clusters of 8 at once, against fewer than the 16 lanes
//   at one CTA an SM, which would run them in two waves (chip_smoke.py's
//   [compare] line prints both counts).
// * Every product is one block_gemm: 4 x 4 outputs a thread, the reduced
//   dimension split over up to 32 lanes of a warp and summed by shuffles
//   where there are fewer tiles than threads; float4 operand reads and
//   output rows where they are contiguous (x's columns and W2's are kept
//   transposed for that), so that a warp's lanes fall on distinct banks.
// * The kernel reads the old weights and writes the new ones to separate
//   outputs, so the caller's tensors are left as they are.
// What bounds it now (H100 80GB HBM3, 700 W): latency.  61-64 us at the
// paper config, 12-13x its bound; a step is ~20 short phases between
// barriers.
// ---------------------------------------------------------------------------

constexpr int kClusterThreads = 256;
constexpr int kMaxCluster = 8;

// A block product out = A Bm over M x N outputs: 4 x 4 outputs a thread,
// the reduced dimension k split over ks lanes of a warp (a power of two,
// up to 32) and summed by shuffles.  A(m, k) = A[m * am + k * ak], Bm(k, n)
// = Bm[k * bk + n * bn].  Tiles past what 256 threads hold at once take
// further passes.
struct Tiling {
  int M, N, tn, tiles, ks, per_pass, s;
  __device__ Tiling(int m, int n, int k) : M(m), N(n) {
    tn = (N + 3) / 4;
    tiles = ((M + 3) / 4) * tn;
    ks = 1;
    while (ks < 32 && 2 * ks * tiles <= kClusterThreads && 2 * ks <= k)
      ks *= 2;
    per_pass = kClusterThreads / ks;
    s = threadIdx.x & (ks - 1);
  }
  __device__ int tile(int base) const { return base + threadIdx.x / ks; }
};

// acc += this thread's share of its tile's products: k = s, s + ks, ...;
// kVecA / kVecB read the tile's 4 values of A / Bm as one float4 (where
// they are contiguous and aligned), which keeps the 32 lanes of a warp on
// distinct banks instead of 4 to a bank.
template <bool kVecA, bool kVecB>
__device__ __forceinline__ void tile_products(float (&acc)[4][4], int K,
                                              int s, int ks, const float* A,
                                              const int (&ao)[4], int ak,
                                              const float* Bm,
                                              const int (&bo)[4], int bk) {
#pragma unroll 4
  for (int kk = s; kk < K; kk += ks) {
    float a[4], b[4];
    if constexpr (kVecA) {
      const float4 v = *reinterpret_cast<const float4*>(A + ao[0] + kk * ak);
      a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = A[ao[i] + kk * ak];
    }
    if constexpr (kVecB) {
      const float4 v = *reinterpret_cast<const float4*>(Bm + kk * bk + bo[0]);
      b[0] = v.x, b[1] = v.y, b[2] = v.z, b[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bm[kk * bk + bo[j]];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ bool aligned16(const float* p, int stride) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && stride % 4 == 0;
}

// Where a block product's outputs go: out(m, n) = out[m * om + n * on]
// takes acc (+ bias[n] where bias is set), or acc where mask(m, n) > 0
// and 0 elsewhere (mask laid out as out), or out(m, n) - lr * acc.
enum GemmMode { kStore, kMasked, kUpdate };
struct GemmOut {
  float* out;
  int om, on;
  GemmMode mode;
  const float* bias;
  const float* mask;
  float lr;
};

__device__ __forceinline__ GemmOut store_to(float* out, int om,
                                            const float* bias = nullptr) {
  return {out, om, 1, kStore, bias, nullptr, 0.0f};
}

__device__ __forceinline__ void block_gemm(int M, int N, int K, const float* A,
                                        int am, int ak, const float* Bm,
                                        int bk, int bn, GemmOut o) {
  const Tiling tl(M, N, K);
  const bool vec_a = am == 1 && M % 4 == 0 && aligned16(A, ak);
  const bool vec_b = bn == 1 && N % 4 == 0 && aligned16(Bm, bk);
  const bool vec_o = o.on == 1 && N % 4 == 0 && aligned16(o.out, o.om) &&
                     (o.mode != kMasked || aligned16(o.mask, o.om)) &&
                     (o.bias == nullptr || aligned16(o.bias, 0));
  for (int base = 0; base < tl.tiles; base += tl.per_pass) {
    const int t = tl.tile(base);
    const int m0 = (t / tl.tn) * 4, n0 = (t % tl.tn) * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    if (t < tl.tiles) {
      int ao[4], bo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ao[i] = min(m0 + i, M - 1) * am;
        bo[i] = min(n0 + i, N - 1) * bn;
      }
      if (vec_a && vec_b)
        tile_products<true, true>(acc, K, tl.s, tl.ks, A, ao, ak, Bm, bo, bk);
      else if (vec_a)
        tile_products<true, false>(acc, K, tl.s, tl.ks, A, ao, ak, Bm, bo, bk);
      else if (vec_b)
        tile_products<false, true>(acc, K, tl.s, tl.ks, A, ao, ak, Bm, bo, bk);
      else
        tile_products<false, false>(acc, K, tl.s, tl.ks, A, ao, ak, Bm, bo,
                                    bk);
    }
    for (int off = tl.ks / 2; off > 0; off /= 2)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] += __shfl_xor_sync(0xffffffffu, acc[i][j], off);
    if (t >= tl.tiles || tl.s != 0) continue;
    if (vec_o) {   // a row of the tile is one float4
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = m0 + i;
        if (m >= M) continue;
        float4* dst = reinterpret_cast<float4*>(o.out + m * o.om + n0);
        float4 a = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        if (o.mode == kUpdate) {
          const float4 w = *dst;
          a = make_float4(__fsub_rn(w.x, __fmul_rn(o.lr, a.x)),
                          __fsub_rn(w.y, __fmul_rn(o.lr, a.y)),
                          __fsub_rn(w.z, __fmul_rn(o.lr, a.z)),
                          __fsub_rn(w.w, __fmul_rn(o.lr, a.w)));
        } else if (o.mode == kMasked) {
          const float4 mk =
              *reinterpret_cast<const float4*>(o.mask + m * o.om + n0);
          a = make_float4(mk.x > 0.0f ? a.x : 0.0f, mk.y > 0.0f ? a.y : 0.0f,
                          mk.z > 0.0f ? a.z : 0.0f, mk.w > 0.0f ? a.w : 0.0f);
        } else if (o.bias) {
          const float4 bb = *reinterpret_cast<const float4*>(o.bias + n0);
          a = make_float4(a.x + bb.x, a.y + bb.y, a.z + bb.z, a.w + bb.w);
        }
        *dst = a;
      }
      continue;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = m0 + i, n = n0 + j;
        if (m >= M || n >= N) continue;
        float* dst = o.out + m * o.om + n * o.on;
        if (o.mode == kUpdate)
          *dst = __fsub_rn(*dst, __fmul_rn(o.lr, acc[i][j]));
        else if (o.mode == kMasked)
          *dst = o.mask[m * o.om + n * o.on] > 0.0f ? acc[i][j] : 0.0f;
        else
          *dst = o.bias ? acc[i][j] + o.bias[n] : acc[i][j];
      }
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Start copying the rows x cols floats at src (row stride ld) transposed
// into dst: dst[q * dld + b] = src[b * ld + q], 4 bytes a copy.
__device__ __forceinline__ void copy_transposed(float* dst, int dld,
                                                const float* src, size_t ld,
                                                int rows, int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
    const int b = i / cols, q = i - b * cols;
    cp_async4(dst + q * dld + b, src + b * ld + q);
  }
}

// Start copying rows x cols floats at src (row stride ld) into dst (row
// stride dld) by cp.async, 16 bytes a copy where every row start is 16-byte
// aligned and cols a multiple of 4, else 4; cp_async_wait_all ends it.
__device__ __forceinline__ void copy_block(float* dst, int dld,
                                           const float* src, size_t ld,
                                           int rows, int cols) {
  const bool vec = (cols % 4 == 0) && (dld % 4 == 0) && (ld % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(src) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(dst) % 16 == 0);
  if (vec) {
    const int per_row = cols / 4;
    for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
      const int r = i / per_row, c4 = (i - r * per_row) * 4;
      cp_async16(dst + r * dld + c4, src + r * ld + c4);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols, c = i - r * cols;
      cp_async4(dst + r * dld + c, src + r * ld + c);
    }
  }
}

// The all-gather of the cluster's column slices: dst[b * h + j] = f(rank
// j / hc's src[b * hc + j % hc]) for b < nb, j < h; f is relu or the
// identity.  Four remote reads of a thread in flight at once.
template <bool kRelu>
__device__ __forceinline__ void gather_slices(
    cooperative_groups::cluster_group& cl, float* dst, float* src,
    int nb, int h, int hc) {
  const int w = hc % 4 == 0 ? 4 : 1;   // floats a read
  const int hw = h / w, hcw = hc / w, n = nb * hw, nt = blockDim.x;
  for (int base = threadIdx.x; base < n; base += 4 * nt) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * nt;
      if (i >= n) break;
      const int b = i / hw, jw = i - b * hw, owner = jw / hcw;
      const float* p =
          cl.map_shared_rank(src, owner) + b * hc + (jw - owner * hcw) * w;
      v[u] = w == 4 ? *reinterpret_cast<const float4*>(p)
                    : make_float4(*p, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + u * nt;
      if (i >= n) break;
      float4 x = v[u];
      if (kRelu) {
        x.x = fmaxf(x.x, 0.0f);
        x.y = fmaxf(x.y, 0.0f);
        x.z = fmaxf(x.z, 0.0f);
        x.w = fmaxf(x.w, 0.0f);
      }
      if (w == 4)
        *reinterpret_cast<float4*>(dst + i * 4) = x;
      else
        dst[i] = x.x;
    }
  }
}

// The reduce-scatter of the cluster's (nb x h) partials onto this CTA's
// columns [j0, j0 + hc): epi(b, jj, sum over the ranks in rank order of
// their src[b * h + j0 + jj]).  All of a thread's remote reads of one
// output group are in flight at once.
template <typename Epi>
__device__ __forceinline__ void reduce_slices(
    cooperative_groups::cluster_group& cl, float* src, int nb, int h,
    int hc, int j0, int c, Epi epi) {
  const int w = hc % 4 == 0 ? 4 : 1;
  const int hcw = hc / w;
  for (int i = threadIdx.x; i < nb * hcw; i += blockDim.x) {
    const int b = i / hcw, jj = (i - b * hcw) * w;
    const int off = b * h + j0 + jj;
    float4 v[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      if (q >= c) break;
      const float* p = cl.map_shared_rank(src, q) + off;
      v[q] = w == 4 ? *reinterpret_cast<const float4*>(p)
                    : make_float4(*p, 0.0f, 0.0f, 0.0f);
    }
    float4 s = v[0];
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q) {
      if (q >= c) break;
      s.x += v[q].x;
      s.y += v[q].y;
      s.z += v[q].z;
      s.w += v[q].w;
    }
    epi(b, jj, s.x);
    if (w == 4) {
      epi(b, jj + 1, s.y);
      epi(b, jj + 2, s.z);
      epi(b, jj + 3, s.w);
    }
  }
}

// dl = (softmax(logits) - onehot) * inv_b in place over nb rows of v
// logits, a warp a row: the max and the sum by shuffles.
__device__ __forceinline__ void softmax_xent(float* dl, const int* y, int nb,
                                             int v, float inv_b) {
  const int lane = threadIdx.x & 31, nw = blockDim.x / 32;
  for (int b = threadIdx.x / 32; b < nb; b += nw) {
    float* row = dl + b * v;
    float zmax = -3.402823466e+38f;   // -FLT_MAX
    for (int j = lane; j < v; j += 32) zmax = fmaxf(zmax, row[j]);
    for (int off = 16; off > 0; off /= 2)
      zmax = fmaxf(zmax, __shfl_xor_sync(0xffffffffu, zmax, off));
    float sum = 0.0f;
    for (int j = lane; j < v; j += 32) {
      const float e = expf(row[j] - zmax);
      row[j] = e;
      sum += e;
    }
    for (int off = 16; off > 0; off /= 2)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const int label = y[b];
    for (int j = lane; j < v; j += 32)
      row[j] = (row[j] / sum - (j == label ? 1.0f : 0.0f)) * inv_b;
  }
}

// bias[j] -= lr * sum_b g[b * n + j] for j < n, a warp a column.
__device__ __forceinline__ void bias_step(float* bias, const float* g, int nb,
                                          int n, float lr) {
  const int lane = threadIdx.x & 31, nw = blockDim.x / 32;
  for (int j = threadIdx.x / 32; j < n; j += nw) {
    float acc = 0.0f;
    for (int b = lane; b < nb; b += 32) acc += g[b * n + j];
    for (int off = 16; off > 0; off /= 2)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) bias[j] = __fsub_rn(bias[j], __fmul_rn(lr, acc));
  }
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Floats of one CTA's shared memory, each buffer rounded up to 16 bytes,
// in the kernel's order: one region that holds x's columns of the own W1
// rows, transposed (ceil(D/c) x B, stride rounded to 4), or relu(h2), then
// the partial dh1 (B x H); the own W1 rows (ceil(D/c) x H); b1, W2 and b2 on the own
// hidden units (H/c of them); the full W3 and b3; one B x H buffer for the
// partial h1p, then relu(h1), then the full dh1; the own slices of h1p,
// h2p, dh2 and dh1 (B x H/c each); the logits / dl (B x V).  W2's columns
// are stored transposed (H/c x H), so that dh2 W2^T reads them along rows.
__host__ __device__ constexpr int sgd_rows(int d_in, int c) {
  return (d_in + c - 1) / c;
}

__host__ __device__ constexpr int sgd_region_floats(int nb, int d_in, int h,
                                                    int c) {
  return round4(nb * h > round4(nb) * sgd_rows(d_in, c)
                    ? nb * h
                    : round4(nb) * sgd_rows(d_in, c));
}

__host__ __device__ constexpr int sgd_cluster_smem_floats(int nb, int d_in,
                                                          int h, int v,
                                                          int c) {
  return sgd_region_floats(nb, d_in, h, c) + round4(sgd_rows(d_in, c) * h) +
         2 * round4(h / c) + round4(h * (h / c)) + round4(h * v) + round4(v) +
         round4(nb * h) + 4 * round4(nb * (h / c)) + round4(nb * v);
}

__global__ void __launch_bounds__(kClusterThreads, 2)
    sgd_cluster_kernel(const float* __restrict__ w1,
                       const float* __restrict__ b1,
                       const float* __restrict__ w2,
                       const float* __restrict__ b2,
                       const float* __restrict__ w3,
                       const float* __restrict__ b3, float* __restrict__ w1o,
                       float* __restrict__ b1o, float* __restrict__ w2o,
                       float* __restrict__ b2o, float* __restrict__ w3o,
                       float* __restrict__ b3o, const float* __restrict__ bx,
                       const int* __restrict__ by, int k, int tau1, int nb,
                       int d_in, int h, int v, float lr, float inv_b) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.dim_blocks().x);
  const int r = static_cast<int>(cluster.block_rank());
  const int lane = blockIdx.x / c;
  const int hc = h / c, j0 = r * hc;
  const int rows = sgd_rows(d_in, c), q0 = r * rows;
  const int dc = max(0, min(rows, d_in - q0));   // this CTA's W1 rows
  const int nbs = round4(nb);      // row stride of x's columns, transposed
  const int tid = threadIdx.x, nt = blockDim.x;

  extern __shared__ __align__(16) float smem[];
  float* sR = smem;                  // x's columns / relu(h2) / partial dh1
  float* sW1 = sR + sgd_region_floats(nb, d_in, h, c);  // [rows][h]
  float* sB1 = sW1 + round4(rows * h);                  // [hc]
  float* sB2 = sB1 + round4(hc);                        // [hc]
  float* sW2t = sB2 + round4(hc);                       // [hc][h]
  float* sW3 = sW2t + round4(h * hc);                   // [h][v]
  float* sB3 = sW3 + round4(h * v);                     // [v]
  float* sH = sB3 + round4(v);       // [nb][h] partial h1p / relu(h1) / dh1
  float* sH1p = sH + round4(nb * h);                    // [nb][hc]
  float* sH2p = sH1p + round4(nb * hc);                 // [nb][hc]
  float* sDH2 = sH2p + round4(nb * hc);                 // [nb][hc]
  float* sDH1 = sDH2 + round4(nb * hc);                 // [nb][hc]
  float* sDL = sDH1 + round4(nb * hc);                  // [nb][v]

  // the lane's slices, all copies in flight at once
  copy_block(sW1, h, w1 + (static_cast<size_t>(lane) * d_in + q0) * h, h, dc,
             h);
  copy_block(sB1, hc, b1 + static_cast<size_t>(lane) * h + j0, 0, 1, hc);
  copy_block(sB2, hc, b2 + static_cast<size_t>(lane) * h + j0, 0, 1, hc);
  copy_block(sW3, h * v, w3 + static_cast<size_t>(lane) * h * v, 0, 1,
             h * v);
  copy_block(sB3, v, b3 + static_cast<size_t>(lane) * v, 0, 1, v);
  // W2's own columns, stored transposed: row jj of sW2t is column j0 + jj
  const float* W2 = w2 + static_cast<size_t>(lane) * h * h + j0;
#pragma unroll 4
  for (int i = tid; i < h * hc; i += nt) {
    const int q = i / hc, j = i - q * hc;
    sW2t[j * h + q] = W2[q * h + j];
  }

  for (int t = 0; t < tau1; ++t) {
    const size_t step = static_cast<size_t>(t) * k + lane;
    const float* xr = bx + step * nb * d_in + q0;   // x's own columns
    const int* y = by + step * nb;
    copy_transposed(sR, nbs, xr, d_in, nb, dc);
    cp_async_wait_all();
    __syncthreads();
    // the partial h1p over the own rows of W1: x[:, own] W1[own, :]
    block_gemm(nb, h, dc, sR, 1, nbs, sW1, h, 1, store_to(sH, h));
    cluster.sync();
    // h1p[:, own cols] = sum of the partials + b1
    reduce_slices(cluster, sH, nb, h, hc, j0, c, [&](int b, int j, float s) {
      sH1p[b * hc + j] = s + sB1[j];
    });
    // every peer has read this CTA's partial; sH1p is complete
    cluster.sync();
    gather_slices<true>(cluster, sH, sH1p, nb, h, hc);   // relu(h1)
    __syncthreads();
    // h2p[:, own] = relu(h1) @ W2[:, own] + b2[own]
    block_gemm(nb, hc, h, sH, h, 1, sW2t, 1, h, store_to(sH2p, hc, sB2));
    cluster.sync();
    gather_slices<true>(cluster, sR, sH2p, nb, h, hc);   // relu(h2)
    __syncthreads();
    // logits = relu(h2) @ W3 + b3, in every CTA
    block_gemm(nb, v, h, sR, h, 1, sW3, v, 1, store_to(sDL, v, sB3));
    __syncthreads();
    // dl = (softmax(logits) - onehot) / B
    softmax_xent(sDL, y, nb, v, inv_b);
    __syncthreads();
    // dh2[:, own] = (dl @ W3[own, :]^T) * (h2p > 0), from the old W3
    block_gemm(nb, hc, v, sDL, v, 1, sW3 + j0 * v, 1, v,
               {sDH2, hc, 1, kMasked, nullptr, sH2p, 0.0f});
    __syncthreads();
    // W3 -= lr * relu(h2)^T dl; b3 -= lr * sum_b dl (every CTA alike)
    block_gemm(h, v, nb, sR, 1, h, sDL, v, 1,
               {sW3, v, 1, kUpdate, nullptr, nullptr, lr});
    bias_step(sB3, sDL, nb, v, lr);
    __syncthreads();
    // the partial dh1 over the own columns of the old W2, over relu(h2):
    // dh2[:, own] W2[:, own]^T
    block_gemm(nb, h, hc, sDH2, hc, 1, sW2t, h, 1, store_to(sR, h));
    __syncthreads();
    // W2[:, own] -= lr * relu(h1)^T dh2[:, own]; b2[own] -= lr * sum_b dh2
    block_gemm(h, hc, nb, sH, 1, h, sDH2, hc, 1,
               {sW2t, 1, h, kUpdate, nullptr, nullptr, lr});
    bias_step(sB2, sDH2, nb, hc, lr);
    cluster.sync();
    // dh1[:, own cols] = (sum of the partials) * (h1p > 0)
    reduce_slices(cluster, sR, nb, h, hc, j0, c, [&](int b, int j, float s) {
      sDH1[b * hc + j] = sH1p[b * hc + j] > 0.0f ? s : 0.0f;
    });
    // every peer has read this CTA's partial; sDH1 is complete
    cluster.sync();
    copy_transposed(sR, nbs, xr, d_in, nb, dc);       // x's columns again
    gather_slices<false>(cluster, sH, sDH1, nb, h, hc);   // the full dh1
    bias_step(sB1, sDH1, nb, hc, lr);
    cp_async_wait_all();
    __syncthreads();
    // W1[own, :] -= lr * x[:, own]^T dh1
    block_gemm(dc, h, nb, sR, nbs, 1, sH, h, 1,
               {sW1, h, 1, kUpdate, nullptr, nullptr, lr});
    __syncthreads();
  }
  // no peer reads this CTA's shared memory after this
  cluster.sync();

  float* W1o = w1o + (static_cast<size_t>(lane) * d_in + q0) * h;
  float* W2o = w2o + static_cast<size_t>(lane) * h * h;
  for (int i = tid; i < dc * h; i += nt) W1o[i] = sW1[i];
  for (int i = tid; i < h * hc; i += nt) {
    const int q = i / hc, j = i - q * hc;
    W2o[q * h + j0 + j] = sW2t[j * h + q];
  }
  for (int j = tid; j < hc; j += nt) {
    b1o[lane * h + j0 + j] = sB1[j];
    b2o[lane * h + j0 + j] = sB2[j];
  }
  if (r == 0) {
    for (int i = tid; i < h * v; i += nt) w3o[lane * h * v + i] = sW3[i];
    for (int j = tid; j < v; j += nt) b3o[lane * v + j] = sB3[j];
  }
}

// The launch of k clusters of ``cluster`` CTAs; ``attr`` holds the
// cluster dimension for the returned config.
cudaLaunchConfig_t sgd_cluster_config(cudaLaunchAttribute* attr, int k,
                                      int cluster, int smem_bytes,
                                      cudaStream_t stream) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k * cluster);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Refuse what the kernel cannot run: a cluster size outside {1, 2, 4, 8}
// or not dividing h, or less shared memory than its layout needs.
cudaError_t sgd_cluster_check(int nb, int d_in, int h, int v, int cluster,
                              int smem_bytes) {
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) ||
      h % cluster)
    return cudaErrorInvalidValue;
  const long long need =
      4LL * sgd_cluster_smem_floats(nb, d_in, h, v, cluster);
  if (smem_bytes < need) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(sgd_cluster_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes);
}

}  // namespace

extern "C" {

const char* hfl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int hfl_score_rows(const float* cq, const float* dq, const float* ms,
                   const float* tables, const int* rules, float* out,
                   int rows, void* stream) {
  const int blocks = (rows + kScoreBlock - 1) / kScoreBlock;
  score_kernel<<<blocks, kScoreBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      cq, dq, ms, tables, rules, out, rows);
  return static_cast<int>(cudaGetLastError());
}

// The fused score of ``seeds`` seeds, each with its own (N, M) gains,
// (N,) counts and staleness and, on the frontier, (N, K) cand_idx, stacked
// along a leading axis: the Eq. 21 reduction into ``partials`` (3 x
// n_partials floats a seed, n_partials in [1, kNormBlocksMax]), then the
// scores of each seed's n x w rows into ``out``: w = k on the frontier
// (cand_idx int32), w = m dense (cand_idx null).
int hfl_score_fused(const float* gains, const float* counts, const int* stale,
                    const int* cand_idx, const float* tables,
                    const int* rules, float* partials, int n_partials,
                    float* out, int n, int m, int k, int seeds,
                    float data_denom, void* stream) {
  if (n_partials < 1 || n_partials > kNormBlocksMax || n < 1 || m < 1 ||
      seeds < 1 || seeds > 65535 || (cand_idx != nullptr && k < 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  score_norm_kernel<<<dim3(n_partials, seeds), kScoreBlock, 0, st>>>(
      gains, stale, partials, n * m, n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int w = cand_idx ? k : m;
  const int blocks = (n * w + kScoreBlock - 1) / kScoreBlock;
  score_fused_kernel<<<dim3(blocks, seeds), kScoreBlock, 0, st>>>(
      gains, counts, stale, cand_idx, partials, n_partials, tables, rules,
      out, n, m, w, data_denom);
  return static_cast<int>(cudaGetLastError());
}

// SIC rates of every edge of ``seeds`` seeds (power (S, N), gains and
// mask (S, N, M)): m clusters of ``cluster`` CTAs a seed, a grid row a
// seed, each CTA holding a slice of ceil(n / cluster) clients' (rx, index)
// in dynamic shared memory.
int hfl_sic_rates(const float* power, const float* gains,
                  const unsigned char* mask, float* out, int n, int m,
                  int seeds, int cluster, float bandwidth_hz, float noise_w,
                  void* stream) {
  if (cluster < 1 || cluster > kSicMaxCluster || (cluster & (cluster - 1)) ||
      n < 1 || m < 1 || seeds < 1 || seeds > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slice = (n + cluster - 1) / cluster;
  const int smem = 8 * slice;
  // opt in on every launch: without it the dynamic part may use only 48 KB
  // less the static shared memory
  cudaError_t err = cudaFuncSetAttribute(
      sic_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(m * cluster, seeds);
  cfg.blockDim = dim3(kSicThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, sic_cluster_kernel, power, gains, mask, out,
                           n, m, slice, bandwidth_hz, noise_w);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int hfl_local_sgd(float* w1, float* b1, float* w2, float* b2, float* w3,
                  float* b3, const float* bx, const int* by, int k, int tau1,
                  int nb, int d_in, int h, int v, float lr, float inv_b,
                  int smem_bytes, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      sgd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  sgd_kernel<<<k, kSgdThreads, smem_bytes,
               static_cast<cudaStream_t>(stream)>>>(
      w1, b1, w2, b2, w3, b3, bx, by, k, tau1, nb, d_in, h, v, lr, inv_b);
  return static_cast<int>(cudaGetLastError());
}

// Old weights in w1..b3 (K, ...), new ones written to w1o..b3o; k clusters
// of ``cluster`` CTAs.
int hfl_local_sgd_cluster(const float* w1, const float* b1, const float* w2,
                          const float* b2, const float* w3, const float* b3,
                          float* w1o, float* b1o, float* w2o, float* b2o,
                          float* w3o, float* b3o, const float* bx,
                          const int* by, int k, int tau1, int nb, int d_in,
                          int h, int v, int cluster, float lr, float inv_b,
                          int smem_bytes, void* stream) {
  cudaError_t err = sgd_cluster_check(nb, d_in, h, v, cluster, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = sgd_cluster_config(
      &attr, k, cluster, smem_bytes, static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&cfg, sgd_cluster_kernel, w1, b1, w2, b2, w3, b3,
                           w1o, b1o, w2o, b2o, w3o, b3o, bx, by, k, tau1, nb,
                           d_in, h, v, lr, inv_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of the cluster kernel the card can hold at once at this
// shape (cudaOccupancyMaxActiveClusters), into *out.
int hfl_sgd_max_active_clusters(int k, int nb, int d_in, int h, int v,
                                int cluster, int smem_bytes, int* out) {
  cudaError_t err = sgd_cluster_check(nb, d_in, h, v, cluster, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      sgd_cluster_config(&attr, k, cluster, smem_bytes, nullptr);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(out, sgd_cluster_kernel, &cfg));
}

}  // extern "C"
