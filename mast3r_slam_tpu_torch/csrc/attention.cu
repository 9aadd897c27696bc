// Scaled-dot-product attention forward, bf16 in and out, head dim 64, for
// Hopper (sm_90a).  Bound through ctypes by ops/attention.py.
//
// Replaces: mast3r_slam_tpu/ops/attention.py  sdpa_fused / _fused_kernel,
// which holds a whole (N, M) f32 logits block per (batch, head) in TPU VMEM.
// At N = M = 768 that block is 2.4 MB: it does not fit in the 227 KB of shared
// memory a Hopper block may use.
//
// What bounds it on the H100: the two matrix products, 4*N*M*D flops per
// (batch, head).  At the encoder's shape (B*H = 16, N = M = 768, D = 64) that
// is 2.42 GFLOP, 2.4 us at the 989 TFLOP/s bf16 peak, against 6.3 MB of q, k,
// v and out (1.9 us at 3.35 TB/s): compute-bound, and at this size the
// softmax's exponentials (N*M per head, 16 a clock on an SM) weigh as much
// as the products.
//
// Design (the FlashAttention-3 shape):
// - One CTA per (batch*head, 64 query rows): one consumer warpgroup owns the
//   64 rows, one producer warp issues TMA loads.  At 768 queries that is 12
//   CTAs a head, 192 for the encoder and 144 for the decoder; 74 KB of
//   shared memory and 160 threads let 2 CTAs share an SM, so every tile is
//   resident at once and one CTA's softmax overlaps the other's products.
// - The producer loads Q once, then K and V tiles of 128 keys into a
//   2-stage ring with full/empty mbarriers.  Tensor maps are 4-D (D, rows,
//   head, batch) with the caller's strides, so q/k/v may be strided views
//   (a fused qkv projection, heads split without a copy); the 128-byte
//   swizzle matches one 64-wide bf16 row, and the wgmma descriptors name the
//   same swizzle.  Rows past N or M arrive as zeros; keys past M are masked
//   to -inf in registers (a zero logit is not a masked one).
// - S = Q K^T: wgmma m64n128k16 with both operands in shared memory, both
//   K-major.  The online softmax stays in the accumulator's registers: a
//   row lives in the 4 threads of a quad, so its max needs two shuffles.
// - O += P V: P is rounded to bf16 in registers and fed as wgmma's register
//   A operand (the accumulator layout is the A layout); V is the B operand
//   in shared memory, MN-major through the descriptor's transpose bit.  O
//   stays in registers and is written once, in (B, N, H, D) memory order.
// Numerics follow sdpa_xla: f32 logits times D^-1/2, max-subtracted f32
// exponentials (exp2 of log2e-scaled logits), weights cast to bf16 before
// the PV product, f32 sums, output cast to bf16.  One difference: the
// weights are rounded to bf16 before the division by the row sum (online
// softmax), where sdpa_xla rounds after.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int D = 64;            // head dim: one 128-byte swizzle row
constexpr int BQ = 64;           // query rows per CTA: one consumer warpgroup
constexpr int BK = 128;          // keys per K/V tile
constexpr int STAGES = 2;        // K/V ring depth
constexpr int MAX_DEVICES = 64;  // cards a process may launch on
constexpr int CONSUMERS = 128;   // one warpgroup
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int Q_BYTES = BQ * D * 2;
constexpr int KV_BYTES = BK * D * 2;
constexpr int SWIZZLE_ATOM = 1024;       // 8 rows of 128 bytes
// Q, K ring, V ring, then the mbarriers; 1 KB of slack to align the tiles
// to the swizzle atom
constexpr int TILE_BYTES = Q_BYTES + 2 * STAGES * KV_BYTES;
constexpr int SMEM_BYTES = SWIZZLE_ATOM + TILE_BYTES + 8 * (1 + 2 * STAGES);
static_assert(2 * (SMEM_BYTES + 1024) <= 228 * 1024, "two CTAs must share an SM");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4)
       | (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16)
       | (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32)
       | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }

// keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma's issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 128, f32) = (scale_d ? d : 0) + A (64 x 16) * B (16 x 128); A and B
// in shared memory, both K-major
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, bf16 in registers) * B (16 x 64); B in
// shared memory, MN-major (transposed)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__global__ void __launch_bounds__(THREADS, 2)
attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o, int H, int N, int M,
                       float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + SWIZZLE_ATOM - 1) & ~(SWIZZLE_ATOM - 1u);
  const uint32_t sQ = base;
  const uint32_t sK = sQ + Q_BYTES;             // STAGES tiles
  const uint32_t sV = sK + STAGES * KV_BYTES;   // STAGES tiles
  const uint32_t bar_q = sV + STAGES * KV_BYTES;
  const uint32_t bar_full = bar_q + 8;          // STAGES barriers
  const uint32_t bar_empty = bar_full + 8 * STAGES;

  const int h = blockIdx.y % H;
  const int b = blockIdx.y / H;
  const int q0 = blockIdx.x * BQ;
  const int n_tiles = (M + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // producer: one lane keeps the ring full
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(bar_q, Q_BYTES);
      tma_load_4d(sQ, &tq, bar_q, 0, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        // the consumers are done with the tile this stage held before
        if (i >= STAGES) mbar_wait(bar_empty + 8 * s, (i / STAGES - 1) & 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * KV_BYTES);
        tma_load_4d(sK + s * KV_BYTES, &tk, bar_full + 8 * s, 0, i * BK, h, b);
        tma_load_4d(sV + s * KV_BYTES, &tv, bar_full + 8 * s, 0, i * BK, h, b);
      }
    }
    return;
  }

  // consumer warpgroup: thread (warp, lane) holds rows r and r + 8 of the
  // warp's 16, and of every 8 columns the two at c, c + 1
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r = warp * 16 + lane / 4;
  const int c = (lane % 4) * 2;
  const float neg_inf = __int_as_float(0xff800000);

  float oacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) oacc[i] = 0.f;
  float m_run[2] = {neg_inf, neg_inf};  // running max, log2-scaled
  float l_run[2] = {0.f, 0.f};          // this thread's share of the row sums

  mbar_wait(bar_q, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    mbar_wait(bar_full + 8 * s, (i / STAGES) & 1);
    __syncwarp();  // wgmma's .aligned forms want the warp converged
    const uint32_t kt = sK + s * KV_BYTES;
    const uint32_t vt = sV + s * KV_BYTES;

    // S = Q K^T over 64 rows x 128 keys, four k16 steps along D (32 bytes
    // each within the swizzled 128-byte rows)
    float sacc[64];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n128k16_ss(sacc, sw128_desc(sQ + 32 * kk, 16, SWIZZLE_ATOM),
                          sw128_desc(kt + 32 * kk, 16, SWIZZLE_ATOM), kk);
    wg_commit();
    wg_wait_all();
    fence_regs(sacc);

    if ((i + 1) * BK > M) {  // keys past M
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (i * BK + 8 * j + c + (e & 1) >= M) sacc[4 * j + e] = neg_inf;
    }

    // online softmax over the tile, in registers
    float mx[2] = {neg_inf, neg_inf};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sacc[4 * j], sacc[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
    }
    float alpha[2], m_new[2];
#pragma unroll
    for (int hrow = 0; hrow < 2; ++hrow) {
      mx[hrow] = fmaxf(mx[hrow], __shfl_xor_sync(0xffffffffu, mx[hrow], 1));
      mx[hrow] = fmaxf(mx[hrow], __shfl_xor_sync(0xffffffffu, mx[hrow], 2));
      m_new[hrow] = fmaxf(m_run[hrow], mx[hrow] * scale_log2);
      alpha[hrow] = exp2_approx(m_run[hrow] - m_new[hrow]);
      m_run[hrow] = m_new[hrow];
    }
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2_approx(fmaf(sacc[4 * j + e], scale_log2, -m_new[e >> 1]));
        sacc[4 * j + e] = p;
        psum[e >> 1] += p;
      }
#pragma unroll
    for (int hrow = 0; hrow < 2; ++hrow) l_run[hrow] = l_run[hrow] * alpha[hrow] + psum[hrow];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      oacc[4 * j] *= alpha[0];
      oacc[4 * j + 1] *= alpha[0];
      oacc[4 * j + 2] *= alpha[1];
      oacc[4 * j + 3] *= alpha[1];
    }

    // P in bf16, laid out as wgmma's A fragments: keys 16t..16t+15 are the
    // accumulator's column blocks 2t and 2t+1
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int t = 0; t < BK / 16; ++t) {
      pa[t][0] = pack_bf16(sacc[8 * t], sacc[8 * t + 1]);
      pa[t][1] = pack_bf16(sacc[8 * t + 2], sacc[8 * t + 3]);
      pa[t][2] = pack_bf16(sacc[8 * t + 4], sacc[8 * t + 5]);
      pa[t][3] = pack_bf16(sacc[8 * t + 6], sacc[8 * t + 7]);
    }

    // O += P V: eight k16 steps along the keys, 16 rows (2 KB) of V each
    wg_fence();
    fence_regs(oacc);
#pragma unroll
    for (int t = 0; t < BK / 16; ++t)
      wgmma_m64n64k16_rs(oacc, pa[t],
                         sw128_desc(vt + t * 16 * 128, SWIZZLE_ATOM, SWIZZLE_ATOM));
    wg_commit();
    wg_wait_all();
    fence_regs(oacc);
    mbar_arrive(bar_empty + 8 * s);
  }

  // normalise and write rows r and r + 8, (B, N, H, D) memory order
#pragma unroll
  for (int hrow = 0; hrow < 2; ++hrow) {
    float l = l_run[hrow];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
    const int n = q0 + r + 8 * hrow;
    if (n < N) {
      __nv_bfloat16* row = o + ((static_cast<size_t>(b) * N + n) * H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(row + 8 * j + c) =
            pack_bf16(oacc[4 * j + 2 * hrow] * inv, oacc[4 * j + 2 * hrow + 1] * inv);
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver call: taken from the driver through the
// runtime, so the library needs no -lcuda
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a 4-D map (D, rows, head, batch) of a bf16 tensor with element strides
// (s_row, s_head, s_batch), boxes of `box_rows` rows; rows past `rows` read
// as zeros
CUresult make_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr, int B, int H,
                  int rows, long long s_row, long long s_head, long long s_batch,
                  int box_rows) {
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                        static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_row) * 2,
                           static_cast<cuuint64_t>(s_head) * 2,
                           static_cast<cuuint64_t>(s_batch) * 2};
  cuuint32_t box[4] = {static_cast<cuuint32_t>(D), static_cast<cuuint32_t>(box_rows), 1, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
             strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace

// q: (B, H, N, 64), k/v: (B, H, M, 64) bf16 with unit stride on the last
// axis and the given element strides (batch, head, row) on the others, each
// a multiple of 8 (16 bytes, as TMA needs); 16-byte aligned.  o: (B, N, H,
// 64) contiguous.  Launches on `stream`; returns cudaGetLastError(), or
// 1000 + the CUresult of a tensor map the driver refused, or 999 if the
// driver has no cuTensorMapEncodeTiled.
extern "C" int attention_bf16_d64(const void* q, const void* k, const void* v, void* o,
                                  int B, int H, int N, int M,
                                  long long qsb, long long qsh, long long qsn,
                                  long long ksb, long long ksh, long long ksm,
                                  long long vsb, long long vsh, long long vsm,
                                  float scale, void* stream) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return 999;
  CUtensorMap tq, tk, tv;
  CUresult rc = make_map(enc, &tq, q, B, H, N, qsn, qsh, qsb, BQ);
  if (rc == CUDA_SUCCESS) rc = make_map(enc, &tk, k, B, H, M, ksm, ksh, ksb, BK);
  if (rc == CUDA_SUCCESS) rc = make_map(enc, &tv, v, B, H, M, vsm, vsh, vsb, BK);
  if (rc != CUDA_SUCCESS) return 1000 + static_cast<int>(rc);
  // the attribute is the current device's: set it once on each card
  static bool attr_set[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (device >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (!attr_set[device]) {
    e = cudaFuncSetAttribute(attention_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    attr_set[device] = true;
  }
  dim3 grid((N + BQ - 1) / BQ, B * H);
  attention_wgmma_kernel<<<grid, THREADS, SMEM_BYTES,
                           reinterpret_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, reinterpret_cast<__nv_bfloat16*>(o), H, N, M,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// dynamic shared memory a CTA takes (bytes), for the smoke run's log
extern "C" int attention_smem_bytes() { return SMEM_BYTES; }
