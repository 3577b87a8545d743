// Hand-written Hopper (sm_90a) kernels for the HFL round's hot path.
//
// Three kernels, each behind a plain C entry point that launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().  The
// Python wrappers in kernels/hfl_ops.py check devices, types and shapes,
// allocate the outputs and raise on a non-zero return.
//
// Build (no --use_fast_math: the ranking parity of the fuzzy scores and
// the SIC rates depends on IEEE division, log2f and expf):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o build/hfl_ops.so hfl_ops.cu
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
// Fused local SGD.
//
// Replaces: src/repro/kernels/hfl_ops.py::_sgd_kernel (via local_sgd_step).
// Bound on the H100: bytes at the paper's width (each lane's 477 KB of
// params read and written, ~16.5 MFLOP a lane-step), but this first
// version runs far from either bound: one block per lane, so at K = 16
// lanes it occupies 16 of the 132 SMs, and its fp32 loops use no tensor
// cores.
// Layout: one block of 256 threads per lane.  w1 alone is D x H fp32
// (784 x 128 = 401 KB), over the 227 KB of shared memory a block can use,
// so the weights stay in global memory (L2-resident: K lanes x 477 KB).
// The step's activations and gradients -- h1p, h2p, dh2, dh1 (B x H each)
// and the logits / dlogits (B x V) -- live in dynamic shared memory (66 KB
// at B = 32, H = 128, V = 10).  Each of the tau1 steps computes dl, dh2 and
// dh1 from the step's old weights, synchronises, then applies all six
// updates in place to the output buffers (which start as a copy of the
// inputs), and synchronises again before the next step reads them.
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

}  // extern "C"
