// Flash attention forward for bf16 inputs on Hopper's tensor cores
// (sm_90a): causal / sliding-window / prefix-LM / chunked / full, GQA;
// full attention also over a key length of its own (cross-attention).
//
// Replaces: src/repro/kernels/flash_attention.py::_attn_kernel (via
// flash_attention / ops.flash_attention) for bf16 q, k, v at d_head 64, 128
// and 256, and computes the two mask kinds the reference leaves to XLA
// (models/attention.py::mask_logits): prefix (causal, or key < prefix_len:
// paligemma's patches) and chunked (causal, and key / chunk == query /
// chunk: llama4's local layers), and full attention of S_q queries over
// S_kv keys (whisper's cross-attention: 448 decoder tokens over 1500
// encoder frames).  kernels/seq_ops.py picks this kernel or
// seq_ops.cu's CUDA-core flash_kernel by dtype and head dim alone
// (flash_route).
//
// Bound on the H100: operations.  The function needs 4 * D flops for each
// (query, key) pair the mask allows and head: at recurrentgemma-9b's
// prefill (B = 2, S = 4096, H = 16, KV = 1, D = 256, causal, window 2048)
// that is 206.2 GFLOP, 0.2085 ms at the 989 TFLOP/s bf16 dense peak,
// against 0.043 ms for its 143 MB of q, k, v and o at 3.35 TB/s.  So the
// design is about keeping the tensor cores fed:
//
// * Both products run on the tensor cores through wgmma, bf16 x bf16 with
//   fp32 accumulation.  S = Q K^T is wgmma.m64n64k16 with Q and K read
//   from shared memory, both K-major (D / 16 steps).  O += P V is
//   wgmma.m64n{D}k16 with P in registers and V from shared memory; V is
//   stored (key, d), so its descriptor is MN-major and the instruction's
//   transpose bit is set.  The fp32 S accumulator of a thread holds the
//   same (row, column) pairs as the bf16 A fragment of the next wgmma, so
//   P goes from S to the second product in registers, 16 keys at a time.
// * Block: 128 query rows of one (head, batch), two warpgroups of 64 rows
//   each; while one runs its softmax on the CUDA cores the other can use
//   the tensor cores.  Thread 0 issues the TMA copies
//   (cp.async.bulk.tensor) of the Q tile and of a 2-stage K/V ring with
//   full/empty mbarriers: tile j + 2 is requested as soon as both
//   warpgroups have released tile j, so the next tile is in flight while
//   the current one is computed.  There is no producer warpgroup: with
//   one (384 threads, setmaxnreg 24 / 240) ptxas held the consumer code at
//   D = 256 to about 204 registers whatever setmaxnreg asked, spilled 372
//   bytes and serialised every wgmma (0.89 ms at the main shape).  A
//   thread here uses 240 (the 64 x 256 fp32 O accumulator is 128, S 32,
//   the two P terms of two steps 16); 256 threads may use 255.
// * Shared memory: Q (128 x D bf16, 64 KB at D = 256) and two stages of K
//   and V (4 x 32 KB): 197,760 bytes with the barriers and the slack to
//   align the tiles to 1024 bytes, under the 232,448 a block may use; one
//   block per SM.  Every tile uses the 128-byte swizzle that wgmma reads
//   without bank conflicts.  A TMA box of that swizzle is at most 64 bf16
//   wide, so a row of D is D / 64 boxes, each a contiguous (rows x 64)
//   slab.  The tensor maps are 4-D over the (B, S, H, D) layout, so no
//   transpose is materialised, and TMA fills zeros past S: a ragged S
//   needs no guarded loads.  The Q map has S_q rows and the K and V maps
//   S_kv: the grid covers ceil(S_q / 128) q-tiles, the loop ceil(S_kv / 64)
//   K/V tiles, and the last K/V tile is masked by S_kv (1500 = 23 * 64 +
//   28) by the test that already masked a ragged S, so neither mask
//   instantiation gains an instruction in its loop.
// * Work skipped: a block loops over the K/V tiles from the window's first
//   tile (or the chunk start of its first row) to the diagonal (or the
//   prefix's last tile, if that is later); each warpgroup skips the tiles
//   that hold no allowed key for its own 64 rows.  Only tiles that straddle
//   the diagonal past the prefix, the window's edge, a chunk boundary or S
//   are masked.  Blocks are numbered so that the q-tiles with the most K/V
//   tiles under a causal mask start first; with chunks the later q-tiles of
//   a chunk carry the most, which this order does not know (it only costs
//   time).
// * Masks: two instantiations a head dim.  Causal and window alone (every
//   layer but paligemma's and llama4's local ones) keep the mask test this
//   loop was tuned with; the prefix and chunked masks take kMasks, where
//   each row's mask is reduced once to the bounds of the keys it may see
//   and an element's test is three compares.  One loop for all four masks
//   cost 5-7% at D = 128 and 256 on the causal and window shapes (ptxas
//   allocates the loop otherwise), and a division an element for the chunk
//   test 21-46% (both measured in turns on an H100 80GB HBM3 at 700 W).
// * Numerics: scores in fp32, scaled by D^-1/2 * log2(e) and exponentiated
//   with ex2.approx (D^-1/2 is a power of two at D = 64 and 256).  Masked
//   scores are -inf and their probabilities exactly 0; the denominator
//   sums the fp32 probabilities and is clamped at 1e-30, as in the TPU
//   kernel.  The tensor cores take bf16, so P goes into the second product
//   as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), which sum to p
//   within a relative 2^-17: P V costs two products.  P rounded once to
//   bf16 (unit roundoff 2^-9) moves each weight by up to 2^-9 relative, and
//   a row that sees few keys with large weights moves by up to
//   2^-9 * max |v - o|; measured at the main shape, that was 2 bf16 ulps
//   of the output (1.56e-2), outside the bf16 limit the kernel is held to.
//   The row max and the final row sum reduce over the 4 threads of a quad
//   (shuffles 1 and 2).
//
// ptxas (CUDA 12.9, sm_90a, -O3): 240 registers a thread at D = 256, 158
// at 128, 128 at 64; no spills, no stack frame.
//
// Not in this version: overlapping a warpgroup's products with each other
// or with its softmax (leaving the P V product of tile j in flight while
// the S product of tile j + 1 runs needs 32 more registers than a thread
// has), ordering the two warpgroups' products (ping-pong), and storing O
// through shared memory and TMA (each thread stores 4-byte pairs).
//
// The C entry point encodes the three tensor maps on the host
// (cuTensorMapEncodeTiled, fetched with cudaGetDriverEntryPoint so the
// library needs no -lcuda), launches on the caller's stream, allocates
// nothing and returns a CUDA error code.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kBQ = 128;        // query rows a block: two warpgroups of 64
constexpr int kBK = 64;         // keys a K/V tile
constexpr int kStages = 2;      // K/V ring depth
constexpr int kThreads = 256;   // two warpgroups of 64 query rows
constexpr int kBox = 64;        // bf16 columns a TMA box (128 bytes)
constexpr int kRowBytes = 128;  // one row of a box in shared memory
constexpr int kBarBytes = 128;  // the mbarriers
constexpr int kAlign = 1024;    // the 128-byte swizzle's atom

constexpr int smem_bytes_for(int d) {
  return kBQ * d * 2 + 2 * kStages * kBK * d * 2 + kBarBytes + kAlign;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ---------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait for the phase of the given parity to complete.  Every wait of this
// kernel ends within microseconds; one that has not ended after 2^26 polls
// (seconds) traps, so a broken pipeline fails the launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (n == (1u << 26)) __trap();
  }
}

// -- TMA ---------------------------------------------------------------------

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; completion is counted on ``bar`` in bytes.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// -- wgmma -------------------------------------------------------------------

// Shared-memory matrix descriptors for tiles written by TMA with the
// 128-byte swizzle: 8-row groups of 128-byte rows, 1024 bytes apart (SBO).
// K-major (Q, K: the reduction dim contiguous): LBO is unused.  MN-major
// (V: d contiguous): LBO steps to the next 64 columns, the next box.
__device__ __forceinline__ uint64_t desc_encode(uint32_t x) {
  return static_cast<uint64_t>((x & 0x3FFFF) >> 4);
}

__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return desc_encode(addr) | (desc_encode(16) << 16) |
         (desc_encode(8 * kRowBytes) << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return desc_encode(addr) | (desc_encode(kBK * kRowBytes) << 16) |
         (desc_encode(8 * kRowBytes) << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that an
// asynchronous wgmma owns across the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// S (64 x 64 fp32) += Q (64 x 16, smem) K^T (16 x 64, smem); ``accumulate`` 0
// overwrites S.
__device__ __forceinline__ void wgmma_qk(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O (64 x N fp32) += P (64 x 16 bf16, the A fragment in 4 registers) V (16 x N,
// smem, MN-major: the transpose bit is set), N = D = 64, 128, 256.
__device__ __forceinline__ void wgmma_pv(float (&d)[32],
                                         const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[64],
                                         const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[128],
                                         const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// -- the kernel --------------------------------------------------------------

// 2^x in one instruction (relative error about 2^-22; 0 for -inf)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool allowed(int qpos, int kpos, int s_kv,
                                        int causal, int window) {
  return kpos < s_kv && (!causal || kpos <= qpos) &&
         (window <= 0 || kpos > qpos - window);
}

// kMasks: the prefix or chunked mask (``prefix`` or ``chunk`` > 0);
// without it both are 0 and unread.  s_len: the queries' length; s_kv: the
// keys' (equal but for full attention, or for a block of queries).  q_off:
// the absolute position of query row 0 (a rank's block of a
// context-parallel prefill; 0 otherwise): every mask reads the absolute row
// q_off + row, the loads and the store the block's own rows.  kOffset:
// q_off is read (else it is 0, and the kernel compiles as it did before it
// took one).
template <int D, bool kMasks, bool kOffset>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o, int batch, int s_len,
                       int s_kv, int n_heads, int n_kv, int causal,
                       int window, int prefix, int chunk, int q_off_arg,
                       float scale_log2) {
  const int q_off = kOffset ? q_off_arg : 0;
  constexpr int kChunks = D / kBox;
  constexpr int kQBytes = kBQ * D * 2;
  constexpr int kTileBytes = kBK * D * 2;   // one K or one V tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + kAlign - 1) & ~(kAlign - 1);
  const uint32_t sk = sq + kQBytes;                    // kStages K tiles
  const uint32_t sv = sk + kStages * kTileBytes;       // kStages V tiles
  const uint32_t bar = sv + kStages * kTileBytes;
  // barriers, 8 bytes each: Q full; K full, V full, K empty, V empty for
  // each stage
  const uint32_t q_full = bar;
  const auto k_full = [bar](int s) { return bar + 8 * (1 + s); };
  const auto v_full = [bar](int s) { return bar + 8 * (1 + kStages + s); };
  const auto k_empty = [bar](int s) { return bar + 8 * (1 + 2 * kStages + s); };
  const auto v_empty = [bar](int s) { return bar + 8 * (1 + 3 * kStages + s); };

  // heaviest q-tiles first: the q-tile is the slowest index, from the end
  const int n_qt = (s_len + kBQ - 1) / kBQ;
  const int per_qt = n_heads * batch;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / per_qt;
  const int head = static_cast<int>(blockIdx.x) % per_qt % n_heads;
  const int b = static_cast<int>(blockIdx.x) % per_qt / n_heads;
  const int kvh = head / (n_heads / n_kv);
  const int q0 = qt * kBQ;
  const int a0 = q_off + q0;   // the block's first row, absolute

  // the K/V tiles that can hold an allowed key for some row of the block
  int kt_hi = (s_kv - 1) / kBK;
  if (causal)
    kt_hi = min(kt_hi, (max(q_off + min(q0 + kBQ, s_len),
                            kMasks ? prefix : 0) - 1) / kBK);
  int kt_lo = 0;
  if (window > 0 && a0 - window + 1 > 0) kt_lo = (a0 - window + 1) / kBK;
  if (kMasks && chunk > 0) kt_lo = a0 / chunk * chunk / kBK;
  const int n_tiles = kt_hi - kt_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 2);   // one arrival per warpgroup
      mbar_init(v_empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  // thread 0 issues every copy: Q and the first kStages K/V tiles now, tile
  // j + kStages once both warpgroups have released tile j's stage
  const auto load_k = [&](int j) {
    const int s = j % kStages;
    mbar_expect_tx(k_full(s), kTileBytes);
    for (int c = 0; c < kChunks; ++c)
      tma_load_4d(sk + s * kTileBytes + c * kBK * kRowBytes, &tk, k_full(s),
                  c * kBox, kvh, (kt_lo + j) * kBK, b);
  };
  const auto load_v = [&](int j) {
    const int s = j % kStages;
    mbar_expect_tx(v_full(s), kTileBytes);
    for (int c = 0; c < kChunks; ++c)
      tma_load_4d(sv + s * kTileBytes + c * kBK * kRowBytes, &tv, v_full(s),
                  c * kBox, kvh, (kt_lo + j) * kBK, b);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, kQBytes);
    for (int c = 0; c < kChunks; ++c)
      tma_load_4d(sq + c * kBQ * kRowBytes, &tq, q_full, c * kBox, head, q0, b);
    for (int j = 0; j < min(kStages, n_tiles); ++j) {
      load_k(j);
      load_v(j);
    }
  }
  const auto refill = [&](int j, uint32_t parity) {
    if (threadIdx.x != 0 || j + kStages >= n_tiles) return;
    mbar_wait(k_empty(j % kStages), parity);
    load_k(j + kStages);
    mbar_wait(v_empty(j % kStages), parity);
    load_v(j + kStages);
  };

  // -- each warpgroup: 64 query rows ---------------------------------------
  const int tw = threadIdx.x % 128;
  const int warp = tw / 32, lane = tw % 32;
  // this thread's accumulator rows (row, row + 8) and first column pair;
  // arow and the warpgroup's wq_lo, wq_hi are absolute
  const int row = q0 + 64 * wg + 16 * warp + lane / 4;
  const int arow = q_off + row;
  const int col = 2 * (lane % 4);
  const int wq_lo = a0 + 64 * wg, wq_hi = wq_lo + 63;
  int w_lo = kt_lo, w_hi = kt_hi;
  if (causal) w_hi = min(w_hi, max(wq_hi, kMasks ? prefix - 1 : 0) / kBK);
  if (window > 0) w_lo = max(w_lo, max(wq_lo - window + 1, 0) / kBK);
  if (kMasks && chunk > 0) w_lo = max(w_lo, wq_lo / chunk * chunk / kBK);

  // kMasks: the keys each of this thread's two rows may see, the mask
  // reduced once to bounds: [k_lo, k_hi], and any key before the prefix.
  // Causal caps k_hi at the row, a window raises k_lo, a chunk bounds both
  // (check_mask lets at most one of window, prefix and chunk be set)
  int k_lo[2], k_hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = arow + 8 * r;
    k_lo[r] = window > 0 ? qpos - window + 1 : 0;
    k_hi[r] = causal ? qpos : s_kv - 1;
    if (chunk > 0) {
      k_lo[r] = qpos / chunk * chunk;
      k_hi[r] = min(k_hi[r], k_lo[r] + chunk - 1);
    }
  }
  // the largest k_lo of the warpgroup's rows (its last row's): a tile with a
  // key below it needs the mask
  const int wk_lo = window > 0  ? wq_hi - window + 1
                    : chunk > 0 ? wq_hi / chunk * chunk
                                : 0;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.0f, 0.0f};   // this thread's share of the row sums
  const uint32_t q_rows = sq + 64 * wg * kRowBytes;

  mbar_wait(q_full, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const uint32_t parity = (j / kStages) & 1;
    const int kt = kt_lo + j, k0 = kt * kBK;
    if (kt < w_lo || kt > w_hi) {
      // no allowed key for these 64 rows: release the tiles once they are
      // in (an empty barrier must not run ahead of its phase)
      mbar_wait(k_full(s), parity);
      if (tw == 0) mbar_arrive(k_empty(s));
      mbar_wait(v_full(s), parity);
      if (tw == 0) mbar_arrive(v_empty(s));
      refill(j, parity);
      continue;
    }

    // S = Q K^T
    float sc[kBK / 2];
    const uint32_t k_tile = sk + s * kTileBytes;
    mbar_wait(k_full(s), parity);
    wgmma_fence();
    const uint64_t dq = desc_kmajor(q_rows);
    const uint64_t dk = desc_kmajor(k_tile);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // step kk: box kk / 4, 16 columns (32 bytes) into it, in 16-byte units
      wgmma_qk(sc, dq + ((kk / 4) * kBQ * kRowBytes + (kk % 4) * 32) / 16,
               dk + ((kk / 4) * kBK * kRowBytes + (kk % 4) * 32) / 16,
               kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    if (tw == 0) mbar_arrive(k_empty(s));

    // online softmax in the exp2 domain; masks only on edge tiles, those
    // where some (row, key) pair of the warpgroup's rows is not allowed: a
    // key past S_kv, past the first row's diagonal but not in the prefix, or
    // below the last row's window or chunk (a key past a row's chunk is
    // past its diagonal)
    const bool edge =
        kMasks ? k0 + kBK > s_kv ||
                     (causal && k0 + kBK - 1 > max(wq_lo, prefix - 1)) ||
                     k0 < wk_lo
               : k0 + kBK > s_kv || (causal && k0 + kBK - 1 > wq_lo) ||
                     (window > 0 && k0 <= wq_hi - window);
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      float x = sc[i] * scale_log2;
      if (edge) {
        const int r = (i / 2) % 2;
        const int kpos = k0 + 8 * (i / 4) + col + i % 2;
        if (kMasks ? kpos >= s_kv || kpos < k_lo[r] ||
                         (kpos > k_hi[r] && kpos >= prefix)
                   : !allowed(arow + 8 * r, kpos, s_kv, causal, window))
          x = -INFINITY;
      }
      sc[i] = x;
    }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i)
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      base[r] = mx[r] == -INFINITY ? 0.0f : mx[r];
      const float alpha = fast_exp2(m_run[r] - base[r]);
      l_run[r] *= alpha;
#pragma unroll
      for (int i = 2 * r; i < D / 2; i += 4) {
        acc[i] *= alpha;
        acc[i + 1] *= alpha;
      }
      m_run[r] = mx[r];
    }

    // O += P V, 16 keys (one step) at a time.  P goes in as two bf16 terms,
    // p = hi + lo to 2^-17, in the A-fragment order of the S accumulator.
    // A step's fragments are made just before its two products and kept
    // until they are done; two buffers let step kk + 1 be made while step
    // kk runs, and the wait before step kk + 2 frees step kk's buffer.
    const uint32_t v_tile = sv + s * kTileBytes;
    mbar_wait(v_full(s), parity);
    const uint64_t dv = desc_mnmajor(v_tile);
    uint32_t pf[2][8];   // [buffer][hi 0..3, lo 4..7]
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t(&f)[8] = pf[kk % 2];
      if (kk >= 2) {
        wgmma_wait<1>();
        fence_regs(f);
      }
#pragma unroll
      for (int i = 8 * kk; i < 8 * kk + 8; i += 2) {
        const int r = (i / 2) % 2;
        const float p0 = fast_exp2(sc[i] - base[r]);
        const float p1 = fast_exp2(sc[i + 1] - base[r]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(
            p0 - __low2float(hi), p1 - __high2float(hi));
        f[(i - 8 * kk) / 2] = *reinterpret_cast<const uint32_t*>(&hi);
        f[4 + (i - 8 * kk) / 2] = *reinterpret_cast<const uint32_t*>(&lo);
        l_run[r] += p0 + p1;
      }
      wgmma_fence();
      // step kk: 16 rows (2048 bytes) down the tile, in 16-byte units
      wgmma_pv(acc, &f[0], dv + kk * 16 * kRowBytes / 16);
      wgmma_pv(acc, &f[4], dv + kk * 16 * kRowBytes / 16);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pf[0]);
    fence_regs(pf[1]);
    if (tw == 0) mbar_arrive(v_empty(s));
    refill(j, parity);
  }

  // epilogue: finish the row sums over the quad, normalise, store
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row + 8 * r;
    if (qpos >= s_len) continue;
    const float inv = 1.0f / fmaxf(l_run[r], 1e-30f);
    __nv_bfloat16* orow =
        o + (static_cast<size_t>(b * s_len + qpos) * n_heads + head) * D + col;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * nb) =
          __floats2bfloat162_rn(acc[4 * nb + 2 * r] * inv,
                                acc[4 * nb + 2 * r + 1] * inv);
  }
}

// -- host --------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D map of a (B, S, heads, D) bf16 tensor whose box is 64 columns of
// ``rows`` positions of one head, 128-byte swizzled; zeros past S.
int encode_bshd(CUtensorMap* map, const void* ptr, int b, int s_len,
                int heads, int d, int rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(s_len),
                              static_cast<cuuint64_t>(b)};
  const cuuint64_t row = static_cast<cuuint64_t>(heads) * d * 2;
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(d) * 2, row,
                                 row * s_len};
  const cuuint32_t box[4] = {kBox, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D, bool kMasks, bool kOffset>
int run_flash_wgmma(const CUtensorMap& tq, const CUtensorMap& tk,
                    const CUtensorMap& tv, void* o, int b, int s_len,
                    int s_kv, int n_heads, int n_kv, int causal, int window,
                    int prefix, int chunk, int q_off, float scale,
                    int smem_bytes, cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma_kernel<D, kMasks, kOffset>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const unsigned blocks =
      static_cast<unsigned>((s_len + kBQ - 1) / kBQ) * n_heads * b;
  flash_wgmma_kernel<D, kMasks, kOffset>
      <<<blocks, kThreads, smem_bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), b, s_len, s_kv, n_heads,
      n_kv, causal, window, prefix, chunk, q_off,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_flash_wgmma(const void* q, const void* k, const void* v, void* o,
                       int b, int s_len, int s_kv, int n_heads, int n_kv,
                       int causal, int window, int prefix, int chunk,
                       int q_off, float scale, int smem_bytes,
                       cudaStream_t stream) {
  if (smem_bytes < smem_bytes_for(D))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int err = encode_bshd(&tq, q, b, s_len, n_heads, D, kBQ);
  if (err == 0) err = encode_bshd(&tk, k, b, s_kv, n_kv, D, kBK);
  if (err == 0) err = encode_bshd(&tv, v, b, s_kv, n_kv, D, kBK);
  if (err != 0) return err;
  const bool masks = prefix > 0 || chunk > 0;
  if (q_off != 0)
    return masks ? run_flash_wgmma<D, true, true>(
                       tq, tk, tv, o, b, s_len, s_kv, n_heads, n_kv, causal,
                       window, prefix, chunk, q_off, scale, smem_bytes, stream)
                 : run_flash_wgmma<D, false, true>(
                       tq, tk, tv, o, b, s_len, s_kv, n_heads, n_kv, causal,
                       window, 0, 0, q_off, scale, smem_bytes, stream);
  return masks ? run_flash_wgmma<D, true, false>(
                     tq, tk, tv, o, b, s_len, s_kv, n_heads, n_kv, causal,
                     window, prefix, chunk, 0, scale, smem_bytes, stream)
               : run_flash_wgmma<D, false, false>(
                     tq, tk, tv, o, b, s_len, s_kv, n_heads, n_kv, causal,
                     window, 0, 0, 0, scale, smem_bytes, stream);
}

}  // namespace

extern "C" {

// bf16 q (B, S, H, D), k/v (B, S_kv, KV, D) -> o (B, S, H, D); D in {64,
// 128, 256}; 16-byte aligned pointers (TMA).  ``prefix`` and ``chunk`` are 0
// when unused (kernels/seq_ops.py::check_mask: at most one of window, prefix
// and chunk, the last two only with ``causal``, and S_kv != S only without
// any of them or for a block of queries).  ``q_off``: query row 0's
// absolute position (q_off + S <= S_kv under a mask), 0 for a whole
// sequence.
int seq_flash_attention_wgmma(const void* q, const void* k, const void* v,
                              void* o, int b, int s_len, int s_kv,
                              int n_heads, int n_kv, int d, int causal,
                              int window, int prefix, int chunk, int q_off,
                              float scale, int smem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_flash_wgmma<64>(q, k, v, o, b, s_len, s_kv, n_heads,
                                    n_kv, causal, window, prefix, chunk,
                                    q_off, scale, smem_bytes, st);
    case 128:
      return launch_flash_wgmma<128>(q, k, v, o, b, s_len, s_kv, n_heads,
                                     n_kv, causal, window, prefix, chunk,
                                     q_off, scale, smem_bytes, st);
    case 256:
      return launch_flash_wgmma<256>(q, k, v, o, b, s_len, s_kv, n_heads,
                                     n_kv, causal, window, prefix, chunk,
                                     q_off, scale, smem_bytes, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
