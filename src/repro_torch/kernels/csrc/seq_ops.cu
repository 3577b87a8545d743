// Hand-written Hopper (sm_90a) kernels for the model substrate's sequence
// mixers: sliding-window flash attention and the diagonal linear
// recurrence of the RG-LRU.
//
// Each kernel sits behind a plain C entry point that launches on the
// caller's stream, allocates nothing and returns cudaGetLastError().  The
// Python wrappers in kernels/seq_ops.py check devices, types, shapes and
// shared memory, allocate the outputs and raise on a non-zero return.
// dtype codes: 0 = float32, 1 = bfloat16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// ---------------------------------------------------------------------------
// Flash attention forward: causal / sliding-window / prefix-LM / chunked /
// full, GQA; full attention also over a key length of its own
// (cross-attention: S_q queries over S_kv keys).
//
// Replaces: src/repro/kernels/flash_attention.py::_attn_kernel (via
// flash_attention / ops.flash_attention), and computes the two mask kinds
// the reference leaves to XLA (models/attention.py::mask_logits): prefix
// (causal, or key < prefix_len) and chunked (causal, and key / chunk ==
// query / chunk).
// Bound on the H100: operations.  Per (b, h) the kernel does 4 * S * W * D
// flops (W the keys a query sees, 2048 at recurrentgemma's window) on
// O(S * D) bytes -- at D = 256 about 500 flops a byte, above the card's
// ridge point.  This first version runs them as fp32 FMAs on the CUDA
// cores (no tensor cores), so it stays far below the bf16 tensor-core
// bound; it keeps the other half of flash right: the (S, S) scores never
// reach device memory, and each K/V tile is read once per q-tile.
// Layout: one block of 256 threads per (q-tile of 64 rows, head, batch).
// Hopper blocks run in no order, so the TPU's sequential K grid axis is a
// loop inside the block over the K/V tiles from the window's (or the first
// row's chunk's) first tile to the diagonal (or the prefix's last tile, if
// that is later); tiles that hold no allowed key for any row are never
// loaded.  Q (scaled by D^-1/2 in fp32, as the TPU kernel does), K,
// V and the probabilities are staged in fp32 dynamic shared memory: at
// D = 256 that is 209 KB of the 227 KB a block can use (rows of Q and K
// padded by one float so the two thread rows of a warp hit distinct
// banks).  Thread (ty, tx) owns rows 4ty..4ty+3 of the tile and the score
// columns tx + 16j; the row max and sum of the online softmax reduce over
// the 16 lanes of a half-warp by shuffles.  The output accumulator (4 rows
// x D/16 columns a thread) stays in registers.  GQA: head h reads KV head
// h / (H / KV), so MQA needs no head broadcast.  Masking follows the TPU
// kernel: NEG_INF scores, masked probabilities zeroed, denominator clamped
// at 1e-30; a ragged S is masked (rows past S_q, keys past S_kv).  The
// queries and the keys each have their own length (s_len, s_kv): equal for
// every mask but full attention (check_mask), where whisper's decoder
// attends to 1500 encoder frames; the grid covers the queries, the loop
// the keys, and the one test a key sees for being past S_kv is the one a
// ragged S already had.
// ---------------------------------------------------------------------------

constexpr int kFlashBQ = 64;
constexpr int kFlashBK = 64;
constexpr int kFlashThreads = 256;
constexpr int kFlashMaxD = 256;
constexpr int kRowsPerThread = kFlashBQ / 16;   // 4
constexpr int kColsPerThread = kFlashBK / 16;   // 4
constexpr int kOutCols = kFlashMaxD / 16;        // 16
constexpr float kNegInf = -1.0e38f;

// The mask of a row, reduced to the bounds of the keys it may see: [lo,
// hi], and any key before the prefix (flash_bounds sets them once a row).
__device__ __forceinline__ bool flash_allowed(int kpos, int s_kv, int lo,
                                              int hi, int prefix) {
  return kpos < s_kv && kpos >= lo && (kpos <= hi || kpos < prefix);
}

// Causal caps hi at the row, a window raises lo, a chunk bounds both
// (check_mask lets at most one of window, prefix and chunk be set).
__device__ __forceinline__ void flash_bounds(int qpos, int s_kv, int causal,
                                             int window, int chunk, int& lo,
                                             int& hi) {
  lo = window > 0 ? qpos - window + 1 : 0;
  hi = causal ? qpos : s_kv - 1;
  if (chunk > 0) {
    lo = qpos / chunk * chunk;
    hi = min(hi, lo + chunk - 1);
  }
}

template <typename T>
__global__ void __launch_bounds__(kFlashThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int s_len,
                 int s_kv, int n_heads, int n_kv, int d, int causal,
                 int window, int prefix, int chunk, int q_off, float scale) {
  extern __shared__ float smem[];
  const int ldq = d + 1;
  const int ldp = kFlashBK + 1;
  float* qs = smem;                      // BQ x (d + 1)
  float* ks = qs + kFlashBQ * ldq;       // BK x (d + 1)
  float* vs = ks + kFlashBK * ldq;       // BK x d
  float* ps = vs + kFlashBK * d;         // BQ x (BK + 1)

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kFlashBQ;
  const int head = blockIdx.y, b = blockIdx.z;
  const int kvh = head / (n_heads / n_kv);
  // (B, S, H, D) / (B, S, KV, D) row-major: position p of this head is at
  // base + p * row
  const size_t q_row = static_cast<size_t>(n_heads) * d;
  const size_t kv_row = static_cast<size_t>(n_kv) * d;
  const T* qb = q + (static_cast<size_t>(b) * s_len * n_heads + head) * d;
  const T* kb = k + (static_cast<size_t>(b) * s_kv * n_kv + kvh) * d;
  const T* vb = v + (static_cast<size_t>(b) * s_kv * n_kv + kvh) * d;
  T* ob = o + (static_cast<size_t>(b) * s_len * n_heads + head) * d;

  for (int idx = tid; idx < kFlashBQ * d; idx += kFlashThreads) {
    const int r = idx / d, c = idx - r * d;
    const int pos = q0 + r;
    qs[r * ldq + c] =
        pos < s_len ? to_f32(qb[pos * q_row + c]) * scale : 0.0f;
  }

  const int nd = d / 16;
  float acc[kRowsPerThread][kOutCols];
  float m_run[kRowsPerThread], l_run[kRowsPerThread];
  int k_lo[kRowsPerThread], k_hi[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    flash_bounds(q_off + q0 + ty * kRowsPerThread + i, s_kv, causal, window,
                 chunk, k_lo[i], k_hi[i]);
    m_run[i] = kNegInf;
    l_run[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kOutCols; ++j) acc[i][j] = 0.0f;
  }

  // K/V tiles that can hold an allowed key for some row of this q-tile (its
  // rows sit at the absolute positions a0 + row)
  const int a0 = q_off + q0;
  int kt_lo = 0;
  int kt_hi = (s_kv - 1) / kFlashBK;
  if (causal)
    kt_hi = min(kt_hi, max(a0 + kFlashBQ - 1, prefix - 1) / kFlashBK);
  if (window > 0 && a0 - window + 1 > 0) kt_lo = (a0 - window + 1) / kFlashBK;
  if (chunk > 0) kt_lo = a0 / chunk * chunk / kFlashBK;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kFlashBK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int idx = tid; idx < kFlashBK * d; idx += kFlashThreads) {
      const int r = idx / d, c = idx - r * d;
      const int pos = k0 + r;
      const bool in = pos < s_kv;
      ks[r * ldq + c] = in ? to_f32(kb[pos * kv_row + c]) : 0.0f;
      vs[r * d + c] = in ? to_f32(vb[pos * kv_row + c]) : 0.0f;
    }
    __syncthreads();

    float sc[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float qv[kRowsPerThread], kv[kColsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        qv[i] = qs[(ty * kRowsPerThread + i) * ldq + c];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        kv[j] = ks[(tx + 16 * j) * ldq + c];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j)
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

    // online softmax, one row at a time over the half-warp that holds it
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = ty * kRowsPerThread + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (!flash_allowed(kpos, s_kv, k_lo[i], k_hi[i], prefix))
          sc[i][j] = kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_cur = fmaxf(m_run[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const float p = flash_allowed(kpos, s_kv, k_lo[i], k_hi[i], prefix)
                            ? expf(sc[i][j] - m_cur)
                            : 0.0f;
        ps[r * ldp + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = expf(m_run[i] - m_cur);
      l_run[i] = l_run[i] * alpha + sum;
      m_run[i] = m_cur;
#pragma unroll
      for (int j = 0; j < kOutCols; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // P is complete

#pragma unroll 4
    for (int kk = 0; kk < kFlashBK; ++kk) {
      float pv[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        pv[i] = ps[(ty * kRowsPerThread + i) * ldp + kk];
#pragma unroll
      for (int j = 0; j < kOutCols; ++j) {
        if (j < nd) {
          const float vv = vs[kk * d + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
            acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int qpos = q0 + ty * kRowsPerThread + i;
    if (qpos >= s_len) continue;
    const float denom = fmaxf(l_run[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kOutCols; ++j)
      if (j < nd)
        ob[qpos * q_row + tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T>
int launch_flash(const void* q, const void* k, const void* v, void* o, int b,
                 int s_len, int s_kv, int n_heads, int n_kv, int d,
                 int causal, int window, int prefix, int chunk, int q_off,
                 float scale, int smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s_len + kFlashBQ - 1) / kFlashBQ, n_heads, b);
  flash_kernel<T><<<grid, kFlashThreads, smem_bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s_len, s_kv, n_heads,
      n_kv, d, causal, window, prefix, chunk, q_off, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Diagonal linear recurrence h_t = exp(log_a_t) * h_{t-1} + x_t.
//
// Replaces: src/repro/kernels/linear_recurrence.py::_linrec_kernel (via
// linear_recurrence / ops.linear_recurrence).
// Bound on the H100: bytes.  Each element is read twice (log_a, x) and
// written once (fp32 h): 12 bytes at fp32 inputs for 3 flops and an exp;
// at recurrentgemma-9b's prefill (B = 2, S = 4096, C = 4096) 403 MB, 0.120
// ms at 3.35 TB/s.  To reach that rate HBM needs some 20-25 KB of loads in
// flight on each SM (Little's law at ~0.8 us); a thread that issues the
// loads of its own next steps keeps far less than that in flight.  So:
//
// * A block is one warp and takes 32 channels of one batch row, one lane a
//   channel: 128 bytes of a time step in fp32.  B * C = 8192 channels make
//   256 blocks, all resident at once (two or three an SM).
// * The block keeps a ring of kLinrecStages tiles of kLinrecTile time
//   steps x 32 channels of log_a and x in shared memory, filled by
//   cp.async copies kLinrecStages - 1 tiles ahead of the scan (one commit
//   group a tile): 56 KB of loads in flight a block in fp32.  A copy is
//   16 bytes where the row (C * itemsize) and both pointers allow it, else
//   8 or 4; bf16 with an odd C is copied 2 bytes at a time through
//   registers (kernels/seq_ops.py::linrec_vector_bytes picks the width).
// * The scan's arithmetic is unchanged: each lane walks its channel with
//   the carry in a register, exp, then an IEEE multiply and add without
//   FMA contraction -- the plain version's, so the kernel is bit-equal to
//   it.  A block is a lone warp on its scheduler, so only its own
//   instruction-level parallelism hides latency: the exps of a whole tile,
//   which do not depend on the carry, come first, then the carry's chain.
//   Outputs are stored straight from the scan, 128 bytes a warp a step.
// * No carry crosses blocks.  Not in this version: a chunked two-pass scan
//   for B * C too small to fill the card, which would reassociate the
//   product and give up bit-equality.
// Measured at the main shape (H100 80GB HBM3, 700 W): 0.227 ms, 53% of
// the byte bound, below what one streaming elementwise pass over the same
// bytes reaches (chip_smoke.py's [seq] line prints both): the 128-byte
// row pieces, 16 KB apart, that each block reads and writes cost DRAM
// efficiency that a wider layout would have to win back.
// ---------------------------------------------------------------------------

constexpr int kLinrecChannels = 32;
constexpr int kLinrecTile = 32;
constexpr int kLinrecStages = 8;

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy VEC bytes from global to shared: cp.async for 4, 8 and 16 (the last
// bypassing L1), a load and a store through a register for 2.
template <int VEC>
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  if constexpr (VEC == 2) {
    *static_cast<unsigned short*>(dst) =
        *static_cast<const unsigned short*>(src);
  } else {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    if constexpr (VEC == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src)
                   : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                   "l"(src), "n"(VEC)
                   : "memory");
  }
}

template <typename T>
constexpr int linrec_smem_bytes() {
  return 2 * kLinrecStages * kLinrecTile * kLinrecChannels *
         static_cast<int>(sizeof(T));
}

// One block's scan; kFull: all kLinrecChannels channels of the block exist,
// so that the checks of the ragged last block fold away.
template <typename T, int VEC, bool kFull>
__device__ __forceinline__ void linrec_block(const T* __restrict__ log_a,
                                             const T* __restrict__ x,
                                             float* __restrict__ out,
                                             int s_len, int c,
                                             unsigned char* ring) {
  constexpr int kTileElems = kLinrecTile * kLinrecChannels;
  constexpr int kPerVec = VEC / static_cast<int>(sizeof(T));
  constexpr int kVecsPerRow = kLinrecChannels / kPerVec;
  T* s_la = reinterpret_cast<T*>(ring);
  T* s_x = s_la + kLinrecStages * kTileElems;
  const int lane = threadIdx.x;
  const int c0 = blockIdx.x * kLinrecChannels;
  const int n_ch = kFull ? kLinrecChannels : min(kLinrecChannels, c - c0);
  // the row's channels in whole copies: exact, as VEC divides C * itemsize
  const int row_vecs = (n_ch + kPerVec - 1) / kPerVec;
  const size_t base = static_cast<size_t>(blockIdx.y) * s_len * c + c0;
  const int n_tiles = (s_len + kLinrecTile - 1) / kLinrecTile;

  // one commit group a tile, empty past the last, so that the count of
  // groups in flight is the same in every iteration
  auto load_tile = [&](int tile) {
    if (tile < n_tiles) {
      const int slot = tile % kLinrecStages;
      const int t0 = tile * kLinrecTile;
      for (int i = lane; i < kLinrecTile * kVecsPerRow;
           i += kLinrecChannels) {
        const int row = i / kVecsPerRow, vec = i - row * kVecsPerRow;
        if (t0 + row < s_len && (kFull || vec < row_vecs)) {
          const size_t g =
              base + static_cast<size_t>(t0 + row) * c + vec * kPerVec;
          const int sm = slot * kTileElems + row * kLinrecChannels +
                         vec * kPerVec;
          copy_async<VEC>(s_la + sm, log_a + g);
          copy_async<VEC>(s_x + sm, x + g);
        }
      }
    }
    cp_async_commit();
  };

  for (int tile = 0; tile < kLinrecStages - 1; ++tile) load_tile(tile);
  float* o = out + base + lane;
  const bool live = kFull || lane < n_ch;
  float h = 0.0f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kLinrecStages - 2>();
    // the tile is in, and every lane is done with the slot refilled next
    __syncwarp();
    load_tile(tile + kLinrecStages - 1);
    const int slot = tile % kLinrecStages;
    const T* la = s_la + slot * kTileElems + lane;
    const T* xv = s_x + slot * kTileElems + lane;
    const int t0 = tile * kLinrecTile;
    float* ot = o + static_cast<size_t>(t0) * c;
    const int steps = min(kLinrecTile, s_len - t0);
    // the tile's exps first, independent of the carry, so that they
    // overlap; then the carry's chain of multiply and add
    float e[kLinrecTile], xs[kLinrecTile];
#pragma unroll
    for (int u = 0; u < kLinrecTile; ++u) {
      e[u] = expf(to_f32(la[u * kLinrecChannels]));
      xs[u] = to_f32(xv[u * kLinrecChannels]);
    }
    // lanes past the last channel run the chain without storing; the
    // branch sits outside the unrolled chain so that it stays straight code
    if (live) {
#pragma unroll
      for (int u = 0; u < kLinrecTile; ++u) {
        if (u < steps) {
          h = __fadd_rn(__fmul_rn(e[u], h), xs[u]);
          ot[static_cast<size_t>(u) * c] = h;
        }
      }
    }
  }
  cp_async_wait<0>();
}

// kFull: C is a multiple of kLinrecChannels (the launcher's choice), so
// every block is full; a branch between the two inside one kernel was
// slower at the main shape.
template <typename T, int VEC, bool kFull>
__global__ void __launch_bounds__(kLinrecChannels)
    linrec_kernel(const T* __restrict__ log_a, const T* __restrict__ x,
                  float* __restrict__ out, int s_len, int c) {
  extern __shared__ __align__(16) unsigned char ring[];
  linrec_block<T, VEC, kFull>(log_a, x, out, s_len, c, ring);
}

template <typename T, int VEC, bool kFull>
int launch_linrec_grid(const void* log_a, const void* x, float* out, int b,
                       int s_len, int c, cudaStream_t stream) {
  constexpr int smem = linrec_smem_bytes<T>();
  const cudaError_t err = cudaFuncSetAttribute(
      linrec_kernel<T, VEC, kFull>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((c + kLinrecChannels - 1) / kLinrecChannels, b);
  linrec_kernel<T, VEC, kFull><<<grid, kLinrecChannels, smem, stream>>>(
      static_cast<const T*>(log_a), static_cast<const T*>(x), out, s_len, c);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int launch_linrec_vec(const void* log_a, const void* x, float* out, int b,
                      int s_len, int c, cudaStream_t stream) {
  if (c % kLinrecChannels == 0)
    return launch_linrec_grid<T, VEC, true>(log_a, x, out, b, s_len, c,
                                            stream);
  return launch_linrec_grid<T, VEC, false>(log_a, x, out, b, s_len, c,
                                           stream);
}

template <typename T>
int launch_linrec(const void* log_a, const void* x, float* out, int b,
                  int s_len, int c, int vec, cudaStream_t stream) {
  switch (vec) {
    case 16:
      return launch_linrec_vec<T, 16>(log_a, x, out, b, s_len, c, stream);
    case 8:
      return launch_linrec_vec<T, 8>(log_a, x, out, b, s_len, c, stream);
    case 4:
      return launch_linrec_vec<T, 4>(log_a, x, out, b, s_len, c, stream);
    default:
      if constexpr (sizeof(T) == 2)
        if (vec == 2)
          return launch_linrec_vec<T, 2>(log_a, x, out, b, s_len, c, stream);
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q (B, S, H, D), k/v (B, S_kv, KV, D) -> o (B, S, H, D).  ``prefix`` and
// ``chunk`` are 0 when unused; kernels/seq_ops.py::check_mask lets at most
// one of window, prefix and chunk be set, the last two only with
// ``causal``, and S_kv differ from S only without any of them or for a
// block of queries; ``q_off`` is query row 0's absolute position (q_off + S
// <= S_kv under a mask), 0 for a whole sequence.
int seq_flash_attention(const void* q, const void* k, const void* v, void* o,
                        int b, int s_len, int s_kv, int n_heads, int n_kv,
                        int d, int causal, int window, int prefix, int chunk,
                        int q_off, float scale, int dtype, int smem_bytes,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_flash<__nv_bfloat16>(q, k, v, o, b, s_len, s_kv, n_heads,
                                       n_kv, d, causal, window, prefix, chunk,
                                       q_off, scale, smem_bytes, st);
  return launch_flash<float>(q, k, v, o, b, s_len, s_kv, n_heads, n_kv, d,
                             causal, window, prefix, chunk, q_off, scale,
                             smem_bytes, st);
}

// log_a, x (B, S, C) float32 or bfloat16 -> out (B, S, C) float32; ``vec``
// the bytes of one ring copy (16, 8, 4, or 2 for bfloat16), which must
// divide C * itemsize and both input pointers' alignment.
int seq_linear_recurrence(const void* log_a, const void* x, float* out,
                          int b, int s_len, int c, int dtype, int vec,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_linrec<__nv_bfloat16>(log_a, x, out, b, s_len, c, vec, st);
  return launch_linrec<float>(log_a, x, out, b, s_len, c, vec, st);
}

}  // extern "C"
