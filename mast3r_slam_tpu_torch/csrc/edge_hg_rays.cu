// Per-edge ray+distance normal-equation blocks of the global Sim(3) solve,
// for Hopper (sm_90a).  Bound through ctypes by ops/edge_hg.py.
//
// Replaces: mast3r_slam_tpu/ops/edge_hg_pallas.py  edge_hg_rays_pallas /
// _kernel.  For every edge e and pixel n, with P = s R(q) Xj + t (Tij[e] =
// [t, q(xyzw), s]), build the four rows [J | err] of the ray+distance
// residual (rj - ri, |P| - |Xi|), weight each by w = huber(sw e) sw^2
// (sw = sq / sigma_ray for the ray rows, sq / sigma_dist for the distance
// row), and accumulate Mloc[e] = sum_n sum_rows w B B^T (8x8, f32, local
// frame).  Norms are sqrt(max(|x|^2, 1e-12)), so points under sq = 0 may be
// zero or garbage and add exactly nothing.  All arithmetic is scalar f32 FMA:
// no tensor cores, no TF32 (the TPU kernel ran at Precision.HIGHEST).
//
// What bounds it on the H100: bytes.  Each pixel-edge reads Xi and Xj (12 B
// each) and sq (4 B), 28 B, and costs about 400 flops (four rows of 8
// products and 36 FMAs into the symmetric accumulator, plus the transform,
// norms and weights).  At 32 edges x 196,608 pixels that is 176 MB, 53 us at
// 3.35 TB/s, against 2.5 GFLOP, 38 us at the 67 TFLOP/s f32 rate.
//
// Design.  The TPU kernel carried the 8x8 sum across a sequential grid axis
// of pixel tiles; Hopper's blocks run in no order, so the reduction across
// blocks is a second pass, and a deterministic one:
//   1. edge_hg_partial: grid (tiles, E), 256 threads, each block 4096 pixels
//      (by default) of one edge.  A thread walks its pixels with a stride of
//      256 (neighbouring lanes on neighbouring pixels), keeps the 36 unique
//      entries of the symmetric block in registers, then the block sums them
//      by warp shuffles and, across its 8 warps, through shared memory in a
//      fixed order, and writes 36 partial sums to scratch (E, tiles, 36).
//   2. edge_hg_finish: one block per edge sums its tiles' partials in tile
//      order and writes the full symmetric (8, 8) block.
// Points are pixel-major (E, N, 3): the layout the solve's gathers produce.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NU = 36;  // unique entries of a symmetric 8x8
constexpr float EPS = 1e-12f;

// acc[k] += w b_i b_j over the upper triangle i <= j, k in row-major order
__device__ __forceinline__ void accumulate(float (&acc)[NU], const float (&b)[8],
                                           float w) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float wb = w * b[i];
#pragma unroll
    for (int j = i; j < 8; ++j) {
      acc[k] = fmaf(wb, b[j], acc[k]);
      ++k;
    }
  }
}

__device__ __forceinline__ float huber_w(float sw, float e, float k) {
  const float r = fabsf(sw * e);
  const float hub = r < k ? 1.0f : k / fmaxf(r, EPS);
  return hub * sw * sw;
}

__global__ void __launch_bounds__(THREADS)
edge_hg_partial(const float* __restrict__ tij, const float* __restrict__ xi,
                const float* __restrict__ xj, const float* __restrict__ sq,
                float* __restrict__ partial, int N, int pixels_per_block,
                float inv_sigma_ray, float inv_sigma_dist, float huber_k) {
  const int e = blockIdx.y;
  const int tile = blockIdx.x;
  const int tiles = gridDim.x;

  const float* T = tij + (int64_t)e * 8;
  const float tx = T[0], ty = T[1], tz = T[2];
  const float qx = T[3], qy = T[4], qz = T[5], qw = T[6], s = T[7];
  const float r00 = 1.0f - 2.0f * (qy * qy + qz * qz);
  const float r01 = 2.0f * (qx * qy - qz * qw);
  const float r02 = 2.0f * (qx * qz + qy * qw);
  const float r10 = 2.0f * (qx * qy + qz * qw);
  const float r11 = 1.0f - 2.0f * (qx * qx + qz * qz);
  const float r12 = 2.0f * (qy * qz - qx * qw);
  const float r20 = 2.0f * (qx * qz - qy * qw);
  const float r21 = 2.0f * (qy * qz + qx * qw);
  const float r22 = 1.0f - 2.0f * (qx * qx + qy * qy);

  float acc[NU];
#pragma unroll
  for (int k = 0; k < NU; ++k) acc[k] = 0.0f;

  const int64_t base = (int64_t)e * N;
  const int start = tile * pixels_per_block;
  const int end = min(N, start + pixels_per_block);
  for (int n = start + threadIdx.x; n < end; n += THREADS) {
    const int64_t p = base + n;
    const float xi0 = __ldg(xi + 3 * p), xi1 = __ldg(xi + 3 * p + 1),
                xi2 = __ldg(xi + 3 * p + 2);
    const float xj0 = __ldg(xj + 3 * p), xj1 = __ldg(xj + 3 * p + 1),
                xj2 = __ldg(xj + 3 * p + 2);
    const float w_sq = __ldg(sq + p);

    const float p0 = s * (r00 * xj0 + r01 * xj1 + r02 * xj2) + tx;
    const float p1 = s * (r10 * xj0 + r11 * xj1 + r12 * xj2) + ty;
    const float p2 = s * (r20 * xj0 + r21 * xj1 + r22 * xj2) + tz;

    const float ni = sqrtf(fmaxf(xi0 * xi0 + xi1 * xi1 + xi2 * xi2, EPS));
    const float nj = sqrtf(fmaxf(p0 * p0 + p1 * p1 + p2 * p2, EPS));
    const float inv_ni = 1.0f / ni;
    const float inv_nj = 1.0f / nj;
    const float rj0 = p0 * inv_nj, rj1 = p1 * inv_nj, rj2 = p2 * inv_nj;
    const float e0 = rj0 - xi0 * inv_ni;
    const float e1 = rj1 - xi1 * inv_ni;
    const float e2 = rj2 - xi2 * inv_ni;
    const float e3 = nj - ni;

    // dr/dP = (I - rj rj^T) / |P|
    const float d00 = (1.0f - rj0 * rj0) * inv_nj;
    const float d01 = (-rj0 * rj1) * inv_nj;
    const float d02 = (-rj0 * rj2) * inv_nj;
    const float d11 = (1.0f - rj1 * rj1) * inv_nj;
    const float d12 = (-rj1 * rj2) * inv_nj;
    const float d22 = (1.0f - rj2 * rj2) * inv_nj;

    const float sw_ray = w_sq * inv_sigma_ray;
    const float sw_dist = w_sq * inv_sigma_dist;

    // rows [J_t(3) | J_rot(3) = -[rj]x row | J_s | err]
    const float b0[8] = {d00, d01, d02, 0.0f, rj2, -rj1, 0.0f, e0};
    const float b1[8] = {d01, d11, d12, -rj2, 0.0f, rj0, 0.0f, e1};
    const float b2[8] = {d02, d12, d22, rj1, -rj0, 0.0f, 0.0f, e2};
    const float b3[8] = {rj0, rj1, rj2, 0.0f, 0.0f, 0.0f, nj, e3};
    accumulate(acc, b0, huber_w(sw_ray, e0, huber_k));
    accumulate(acc, b1, huber_w(sw_ray, e1, huber_k));
    accumulate(acc, b2, huber_w(sw_ray, e2, huber_k));
    accumulate(acc, b3, huber_w(sw_dist, e3, huber_k));
  }

  // block reduction in a fixed order: lanes by shuffles, warps in order
  __shared__ float red[WARPS][NU];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NU; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < NU) {
    float v = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += red[w][threadIdx.x];
    partial[((int64_t)e * tiles + tile) * NU + threadIdx.x] = v;
  }
}

__global__ void edge_hg_finish(const float* __restrict__ partial,
                               float* __restrict__ out, int tiles) {
  const int e = blockIdx.x;
  const int k = threadIdx.x;
  if (k >= NU) return;
  float v = 0.0f;
  for (int t = 0; t < tiles; ++t) v += partial[((int64_t)e * tiles + t) * NU + k];
  // k -> (i, j), i <= j, in the order accumulate() writes them
  int i = 0, r = k;
  while (r >= 8 - i) {
    r -= 8 - i;
    ++i;
  }
  const int j = i + r;
  out[(int64_t)e * 64 + i * 8 + j] = v;
  out[(int64_t)e * 64 + j * 8 + i] = v;
}

}  // namespace

// tij: (E, 8) f32; xi, xj: (E, N, 3) f32; sq: (E, N) f32, all contiguous.
// partial: scratch of (E, ceil(N / pixels_per_block), 36) f32; out: (E, 8, 8)
// f32.  E <= 65535, N >= 1.  Launches both passes on `stream` and returns
// cudaGetLastError().
extern "C" int edge_hg_rays_f32(const void* tij, const void* xi, const void* xj,
                                const void* sq, void* partial, void* out, int E,
                                int N, int pixels_per_block, float inv_sigma_ray,
                                float inv_sigma_dist, float huber_k,
                                void* stream) {
  const int tiles = (N + pixels_per_block - 1) / pixels_per_block;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  edge_hg_partial<<<dim3(tiles, E), THREADS, 0, st>>>(
      reinterpret_cast<const float*>(tij), reinterpret_cast<const float*>(xi),
      reinterpret_cast<const float*>(xj), reinterpret_cast<const float*>(sq),
      reinterpret_cast<float*>(partial), N, pixels_per_block, inv_sigma_ray,
      inv_sigma_dist, huber_k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  edge_hg_finish<<<E, 64, 0, st>>>(reinterpret_cast<const float*>(partial),
                                   reinterpret_cast<float*>(out), tiles);
  return static_cast<int>(cudaGetLastError());
}
