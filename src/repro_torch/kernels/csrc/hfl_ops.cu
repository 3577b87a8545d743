// Hand-written Hopper (sm_90a) kernels for the HFL round's hot path.
//
// Fuzzy scoring, SIC rates and local SGD (a thread-block cluster per lane,
// and a block per lane for the shapes the cluster kernel refuses), each
// behind a plain C entry point that launches on the caller's stream,
// allocates nothing and returns cudaGetLastError().  The Python wrappers
// in kernels/hfl_ops.py check devices, types and shapes, allocate the
// outputs and raise on a non-zero return.
//
// Build (no --use_fast_math: the ranking parity of the fuzzy scores and
// the SIC rates depends on IEEE division, log2f and expf):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o build/hfl_ops.so hfl_ops.cu
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// Fused fuzzy scoring.
//
// Replaces: src/repro/kernels/hfl_ops.py::_score_kernel (via _score_rows).
// Bound on the H100: operations.  Each row reads 12 bytes and writes 4, but
// runs ~2.5k fp32 min/max/mul/add ops (9 memberships, the 27-rule Max-Min
// table, 5 x 201 Mamdani clips and the CoG sums) -- far above the card's
// ~20 ops/byte fp32 ridge point.
// Layout: one thread per (client, edge) row, 256 rows a block.  The 5 x 201
// output memberships (made once on the host in fp32), the 3 input
// triangles and the rule table are staged in shared memory per block; the
// CoG grid is g * 0.5, exact in fp32.  Strengths use only min/max (exact in
// any order); num and den are summed in the fixed order g = 0..200 with
// explicit round-to-nearest mul/add (no FMA contraction), so the plain
// PyTorch version (core/fuzzy.py::score_rows) matches bit for bit.
// ---------------------------------------------------------------------------

constexpr int kGrid = 201;
constexpr int kOut = 5;
constexpr int kRules = 27;
constexpr int kScoreBlock = 256;

__device__ __forceinline__ float tri(float x, float a, float b, float c) {
  float up = __fdiv_rn(__fsub_rn(x, a), fmaxf(__fsub_rn(b, a), 1e-9f));
  float down = __fdiv_rn(__fsub_rn(c, x), fmaxf(__fsub_rn(c, b), 1e-9f));
  return fminf(fmaxf(fminf(up, down), 0.0f), 1.0f);
}

__global__ void score_kernel(const float* __restrict__ cq,
                             const float* __restrict__ dq,
                             const float* __restrict__ ms,
                             const float* __restrict__ tables,
                             const int* __restrict__ rules,
                             float* __restrict__ out, int rows) {
  // tables = [3 input triangles (a, b, c) | 5 x 201 output memberships]
  __shared__ float s_tri[9];
  __shared__ float s_mu[kOut * kGrid];
  __shared__ int s_rules[kRules];
  for (int i = threadIdx.x; i < kOut * kGrid; i += blockDim.x)
    s_mu[i] = tables[9 + i];
  if (threadIdx.x < 9) s_tri[threadIdx.x] = tables[threadIdx.x];
  if (threadIdx.x < kRules) s_rules[threadIdx.x] = rules[threadIdx.x];
  __syncthreads();

  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float v_cq = cq[r], v_dq = dq[r], v_ms = ms[r];
  float m_cq[3], m_dq[3], m_ms[3];
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const float a = s_tri[3 * s], b = s_tri[3 * s + 1], c = s_tri[3 * s + 2];
    m_cq[s] = tri(v_cq, a, b, c);
    m_dq[s] = tri(v_dq, a, b, c);
    m_ms[s] = tri(v_ms, a, b, c);
  }
  // Max-Min inference folded straight into the 5 output strengths; the
  // output set is selected by value, so the strengths stay in registers
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
        const int set = s_rules[9 * i + 3 * j + k];
#pragma unroll
        for (int o = 0; o < kOut; ++o)
          st[o] = (set == o) ? fmaxf(st[o], deg) : st[o];
      }
  // Mamdani clip + max aggregate + centre of gravity over the grid
  float num = 0.0f, den = 0.0f;
  for (int g = 0; g < kGrid; ++g) {
    float agg = fminf(s_mu[g], st[0]);
#pragma unroll
    for (int o = 1; o < kOut; ++o)
      agg = fmaxf(agg, fminf(s_mu[o * kGrid + g], st[o]));
    num = __fadd_rn(num, __fmul_rn(static_cast<float>(g) * 0.5f, agg));
    den = __fadd_rn(den, agg);
  }
  out[r] = __fdiv_rn(num, fmaxf(den, 1e-9f));
}

// ---------------------------------------------------------------------------
// NOMA SIC rates.
//
// Replaces: src/repro/kernels/hfl_ops.py::_sic_kernel (via sic_rates).
// Bound on the H100: operations.  For each edge the pairwise "decoded after
// me" test is O(N^2) compare/select/add work on O(N) bytes.
// Layout: grid (M, ceil(N / 128)), one thread per client i of one edge.  A
// loop inside the block walks the j tiles through shared memory and keeps
// the interference sum in a register -- it replaces the TPU kernel's
// sequential j grid axis and its VMEM scratch, since blocks cannot carry
// state between each other.  Gains and mask come transposed to contiguous
// (M, N) rows; the ragged last tile is masked.  rx = p * g * mask in the
// reference's order; j is strictly weaker than i when rx_j < rx_i, or on an
// exact tie when j > i.
// ---------------------------------------------------------------------------

constexpr int kSicBlock = 128;

__global__ void sic_kernel(const float* __restrict__ power,
                           const float* __restrict__ gains_t,
                           const float* __restrict__ mask_t,
                           float* __restrict__ out_t, int n,
                           float bandwidth_hz, float noise_w) {
  __shared__ float s_rx[kSicBlock];
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  const int i = blockIdx.y * kSicBlock + threadIdx.x;
  float rx_i = 0.0f, m_i = 0.0f;
  if (i < n) {
    m_i = mask_t[row + i];
    rx_i = __fmul_rn(__fmul_rn(power[i], gains_t[row + i]), m_i);
  }
  float intf = 0.0f;
  for (int j0 = 0; j0 < n; j0 += kSicBlock) {
    const int j = j0 + threadIdx.x;
    s_rx[threadIdx.x] =
        (j < n) ? __fmul_rn(__fmul_rn(power[j], gains_t[row + j]),
                            mask_t[row + j])
                : 0.0f;
    __syncthreads();
    const int tile = min(kSicBlock, n - j0);
    for (int t = 0; t < tile; ++t) {
      const float rx_j = s_rx[t];
      const bool weaker = (rx_j < rx_i) || (rx_j == rx_i && j0 + t > i);
      intf = __fadd_rn(intf, weaker ? rx_j : 0.0f);
    }
    __syncthreads();
  }
  if (i < n) {
    const float sinr = __fdiv_rn(rx_i, __fadd_rn(intf, noise_w));
    out_t[row + i] = __fmul_rn(
        __fmul_rn(bandwidth_hz, log2f(__fadd_rn(1.0f, sinr))), m_i);
  }
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

int hfl_sic_rates(const float* power, const float* gains_t,
                  const float* mask_t, float* out_t, int n, int m,
                  float bandwidth_hz, float noise_w, void* stream) {
  const dim3 grid(m, (n + kSicBlock - 1) / kSicBlock);
  sic_kernel<<<grid, kSicBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      power, gains_t, mask_t, out_t, n, bandwidth_hz, noise_w);
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
