// Scaled-dot-product attention forward, bf16 in and out, head dim 64, for
// Hopper (sm_90a).  Bound through ctypes by ops/attention.py.
//
// Replaces: mast3r_slam_tpu/ops/attention.py  sdpa_fused / _fused_kernel,
// which holds a whole (N, M) f32 logits block per (batch, head) in TPU VMEM.
// At N = M = 768 that block is 2.4 MB: it does not fit in the 227 KB of shared
// memory a Hopper block may use, and one block per (batch, head) would put
// 12-16 blocks on 132 SMs.
//
// What bounds it on the H100: the two matrix products, 4*N*M*D flops per
// (batch, head).  At the encoder's shape (B*H = 16, N = M = 768, D = 64) that
// is 2.42 GFLOP, 2.4 us at the 989 TFLOP/s bf16 peak, against 6.3 MB of q, k,
// v and out (1.9 us at 3.35 TB/s): compute-bound.
//
// Design: one block of 4 warps per 64 query rows of one (batch, head); each
// warp owns 16 rows.  The block walks K/V in tiles of 64 keys through shared
// memory (rows padded against bank conflicts).  Both products run on the
// tensor cores through the WMMA bf16 16x16x16 fragments with f32
// accumulation; between them each warp runs an
// online (running max and running sum) f32 softmax over its own rows, so no
// logits leave the SM and no warp waits for another except at tile loads.
// Numerics follow sdpa_xla: f32 logits times D^-1/2, max-subtracted f32
// exponentials, weights cast to bf16 before the PV product, f32 sums, output
// cast to bf16.  One difference: the weights are rounded to bf16 before the
// division by the row sum (online softmax), where sdpa_xla rounds after.
// This simple form is the first kernel; wgmma and TMA come later.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int D = 64;         // head dim
constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int WARPS = BQ / 16;
constexpr int THREADS = WARPS * 32;
// Shared-memory rows are padded by 16 bytes (8 bf16 / 4 f32), so the 8 rows
// one fragment load touches start on different banks instead of all on
// bank 0 (128- and 256-byte strides conflict 8 ways).  WMMA wants ldm a
// multiple of 8 (bf16) / 4 (f32) and 32-byte aligned tile pointers; both
// hold for 16-row tile offsets at these strides.
constexpr int LDH = D + 8;    // bf16 tile row stride (elements); D == BK
constexpr int LDF = BK + 4;   // f32 logits row stride (elements)
// The Q tile is read once into registers, so the f32 logits tile reuses its
// space: logits/Q (f32, 17 KB) + K, V, weights (bf16, 9 KB each) = 44 KB,
// under the 48 KB a block gets without opting in.
constexpr int S_BYTES = BQ * LDF * 4;
constexpr int T_BYTES = BK * LDH * 2;
constexpr int SMEM_BYTES = S_BYTES + 3 * T_BYTES;
static_assert(BQ * LDH * 2 <= S_BYTES, "Q tile must fit in the logits tile");
static_assert(SMEM_BYTES <= 48 * 1024, "over the default shared memory");

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Copy `rows` rows of 64 bf16 (starting at global row r0, of `limit` valid
// rows) into shared memory rows of stride LDH, 16 bytes a thread; rows past
// `limit` are zeros.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int limit, int rows) {
  constexpr int CHUNKS_PER_ROW = D / 8;
  for (int c = threadIdx.x; c < rows * CHUNKS_PER_ROW; c += THREADS) {
    const int r = c / CHUNKS_PER_ROW;
    const int col = (c % CHUNKS_PER_ROW) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < limit)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + col);
    *reinterpret_cast<uint4*>(dst + r * LDH + col) = val;
  }
}

__global__ void __launch_bounds__(THREADS)
attention_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int N, int M, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ss = reinterpret_cast<float*>(smem);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);  // aliases Ss
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + S_BYTES);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + S_BYTES + T_BYTES);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + S_BYTES + 2 * T_BYTES);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const __nv_bfloat16* qb = q + (size_t)bh * N * D;
  const __nv_bfloat16* kb = k + (size_t)bh * M * D;
  const __nv_bfloat16* vb = v + (size_t)bh * M * D;
  const float neg_inf = __int_as_float(0xff800000);

  load_tile(Qs, qb, q0, N, BQ);
  __syncthreads();

  // this warp's 16 query rows stay in registers as 4 A fragments
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * LDH + kk * 16, LDH);

  // per lane: running max / sum of each of the warp's 16 rows (uniform
  // across lanes) and the output columns `lane` and `lane + 32`
  float m_r[16], l_r[16], o_r[16][2];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    m_r[r] = neg_inf;
    l_r[r] = 0.f;
    o_r[r][0] = 0.f;
    o_r[r][1] = 0.f;
  }

  float* S_w = Ss + warp * 16 * LDF;           // this warp's logits rows
  __nv_bfloat16* P_w = Ps + warp * 16 * LDH;   // this warp's weight rows

  for (int k0 = 0; k0 < M; k0 += BK) {
    // every warp is done with the previous K/V tile (and, on the first
    // trip, with the Q tile under the logits)
    __syncthreads();
    load_tile(Ks, kb, k0, M, BK);
    load_tile(Vs, vb, k0, M, BK);
    __syncthreads();

    // S = Q K^T for 16 rows x 64 keys
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> kf;
        wmma::load_matrix_sync(kf, Ks + j * 16 * LDH + kk * 16, LDH);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(S_w + j * 16, sf, LDF, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax, one row at a time across the warp's 32 lanes
    const bool in0 = k0 + lane < M;
    const bool in1 = k0 + lane + 32 < M;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float s0 = in0 ? S_w[r * LDF + lane] * scale : neg_inf;
      const float s1 = in1 ? S_w[r * LDF + lane + 32] * scale : neg_inf;
      const float m_new = fmaxf(m_r[r], warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m_r[r] - m_new);
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      P_w[r * LDH + lane] = __float2bfloat16(p0);
      P_w[r * LDH + lane + 32] = __float2bfloat16(p1);
      l_r[r] = l_r[r] * alpha + warp_sum(p0 + p1);
      m_r[r] = m_new;
      o_r[r][0] *= alpha;
      o_r[r][1] *= alpha;
    }
    __syncwarp();

    // PV for 16 rows x 64 dims, written over this warp's logits rows
#pragma unroll
    for (int dd = 0; dd < D / 16; ++dd) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> vf;
        wmma::load_matrix_sync(pf, P_w + j * 16, LDH);
        wmma::load_matrix_sync(vf, Vs + j * 16 * LDH + dd * 16, LDH);
        wmma::mma_sync(acc, pf, vf, acc);
      }
      wmma::store_matrix_sync(S_w + dd * 16, acc, LDF, wmma::mem_row_major);
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      o_r[r][0] += S_w[r * LDF + lane];
      o_r[r][1] += S_w[r * LDF + lane + 32];
    }
    __syncwarp();
  }

  __nv_bfloat16* ob = o + (size_t)bh * N * D;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = q0 + warp * 16 + r;
    if (row < N) {
      const float inv = 1.f / l_r[r];
      ob[(size_t)row * D + lane] = __float2bfloat16(o_r[r][0] * inv);
      ob[(size_t)row * D + lane + 32] = __float2bfloat16(o_r[r][1] * inv);
    }
  }
}

}  // namespace

// q: (BH, N, 64), k/v: (BH, M, 64), o: (BH, N, 64), all contiguous bf16.
// Launches on `stream` and returns cudaGetLastError().
extern "C" int attention_bf16_d64(const void* q, const void* k, const void* v,
                                  void* o, int bh, int n, int m, float scale,
                                  void* stream) {
  dim3 grid((n + BQ - 1) / BQ, bh);
  attention_fwd_kernel<<<grid, THREADS, SMEM_BYTES,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(q),
      reinterpret_cast<const __nv_bfloat16*>(k),
      reinterpret_cast<const __nv_bfloat16*>(v),
      reinterpret_cast<__nv_bfloat16*>(o), n, m, scale);
  return static_cast<int>(cudaGetLastError());
}
