// Per-edge ray+distance normal-equation blocks of the global Sim(3) solve,
// for Hopper (sm_90a).  Bound through ctypes by ops/edge_hg.py.
//
// Replaces: mast3r_slam_tpu/ops/edge_hg_pallas.py  edge_hg_rays_pallas /
// _kernel.  For every edge e and pixel n, with P = s R(q) Xj + t (Tij[e] =
// [t, q(xyzw), s]), build the four rows [J | err] of the ray+distance
// residual (rj - ri, |P| - |Xi|), weight each by w = huber(sw e) sw^2
// (sw = sq / sigma_ray for the ray rows, sq / sigma_dist for the distance
// row), and accumulate Mloc[e] = sum_n sum_rows w B B^T (8x8, f32, local
// frame).  Norms clamp |x|^2 at 1e-12, so points under sq = 0 may be zero
// or garbage and add exactly nothing.  All arithmetic is scalar f32: no
// tensor cores, no TF32 (the TPU kernel ran at Precision.HIGHEST).
//
// What bounds it on the H100: bytes, with instruction issue close behind.
// A pixel-edge reads Xi and Xj (12 B each) and sq (4 B), 28 B: at 32 edges
// x 196,608 pixels 176 MB, 52.6 us at 3.35 TB/s.  Its arithmetic is about
// 200 SASS instructions a pixel-edge (chip_smoke.py phase 2 reads the
// pixel loop's instruction, FFMA and MUFU counts with cuobjdump), about 40
// us if all 4 schedulers of all 132 SMs issued every clock; at 16 warps an
// SM they issue about 60 % of clocks, and the card reads 0.0675 ms (PERF.md
// kernel table).  So the rows issue what they need and no more:
//   - each ray row has 6 entries that can be non-zero (J_t 3, two of
//     -[rj]x, err), the distance row 5 (rj 3, |P|, err): 78 FMAs into the
//     accumulator and 23 weight products, the zeros left out at compile
//     time (add_row's column masks); Mloc[3:6, 6] and its mirror, which no
//     row reaches, are sums of nothing, exact zeros;
//   - 1/|x| is one MUFU.RSQ (rsqrt.approx) and |x| = |x|^2 / |x|; the
//     Huber factor k / r one MUFU.RCP (rcp.approx) and a product.  Their
//     relative errors (about 2^-22) reach the blocks at under 1e-6 on the
//     solve's scale, against a 3e-5 bound: no Newton step, no division or
//     square-root subroutine.
//
// Design: one launch, deterministic.
//   - A cooperative launch of as many blocks as the card holds at once
//     (edge_hg_rays_slots: 2 blocks of 256 threads an SM, registers capped
//     at 128), each walking (edge, tile) items, where the wrapper picks the
//     tiles an edge so that the items fill those blocks (8 tiles an edge at
//     32 edges).  Every SM works from start to end, whatever E.  (A
//     cluster of 8 blocks an edge, summed through distributed shared
//     memory, needs no scratch, but the card cannot hold 32 such clusters
//     at once: at 32 edges the last ones ran in a second wave.)
//   - A block's threads walk its tile with a stride of 256 (neighbouring
//     lanes on neighbouring pixels: a warp's three loads of an array fall
//     on three whole 128-byte lines, used in full from L1), two pixels at a
//     time, the next two pixels' 14 loads issued before this pair's
//     arithmetic (register double-buffering).
//   - Each item's 36 sums are reduced in a fixed order (warp shuffles, then
//     the 8 warps in order through shared memory) into partial[item]; after
//     grid.sync() each edge's tiles are summed in tile order.  The same
//     bits on every call.
//   - The launch is cudaLaunchKernelEx with the cooperative attribute,
//     which a stream capture records as a cooperative kernel node: the
//     global solve's device program (ops/global_gn.py) replays it inside
//     its WHILE node.
//   - Each run adds one to a device counter (`runs`, block 0's thread 0),
//     so a replayed graph's runs are counted where the kernel runs.
// Points are pixel-major (E, N, 3): the layout the solve's gathers produce.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NU = 36;      // unique entries of a symmetric 8x8
constexpr float EPS = 1e-12f;

// columns [J_t 0-2 | J_rot 3-5 | J_s 6 | err 7] that can be non-zero
constexpr unsigned RAY0 = 0xB7u;  // 0 1 2 . 4 5 . 7   (-[rj]x row 0: 0, rz, -ry)
constexpr unsigned RAY1 = 0xAFu;  // 0 1 2 3 . 5 . 7   (-rz, 0, rx)
constexpr unsigned RAY2 = 0x9Fu;  // 0 1 2 3 4 . . 7   (ry, -rx, 0)
constexpr unsigned DIST = 0xC7u;  // 0 1 2 . . . 6 7   (rj, |P|)

__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// acc[k] += w b_i b_j over the upper triangle i <= j (k in row-major
// order), only where bits i and j of MASK are set: the rest is never emitted
template <unsigned MASK>
__device__ __forceinline__ void add_row(float (&acc)[NU], const float (&b)[8], float w) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float wb = w * b[i];
#pragma unroll
    for (int j = i; j < 8; ++j, ++k)
      if ((MASK >> i & 1u) && (MASK >> j & 1u)) acc[k] = fmaf(wb, b[j], acc[k]);
  }
}

// 1 inside |r| < k, k / |r| outside; times sw^2
__device__ __forceinline__ float huber_w(float sw, float sw2, float e, float k) {
  const float r = fabsf(sw * e);
  return (r < k ? 1.0f : k * rcp_approx(r)) * sw2;
}

struct Edge {
  float r00, r01, r02, r10, r11, r12, r20, r21, r22;  // s R(q)
  float tx, ty, tz;
};

struct Pixel {
  float xi0, xi1, xi2, xj0, xj1, xj2, sq;
};

// pixel n of an edge (xi, xj, sq point at its first pixel); past the
// tile's end (ok false) the edge's last pixel with sq = 0, which adds
// exact zeros: no predicated loads and no branch around the arithmetic
__device__ __forceinline__ Pixel load_pixel(const float* __restrict__ xi,
                                            const float* __restrict__ xj,
                                            const float* __restrict__ sq, int n, int last,
                                            bool ok) {
  const int p = min(n, last);
  Pixel x;
  x.xi0 = __ldg(xi + 3 * p);
  x.xi1 = __ldg(xi + 3 * p + 1);
  x.xi2 = __ldg(xi + 3 * p + 2);
  x.xj0 = __ldg(xj + 3 * p);
  x.xj1 = __ldg(xj + 3 * p + 1);
  x.xj2 = __ldg(xj + 3 * p + 2);
  x.sq = ok ? __ldg(sq + p) : 0.0f;
  return x;
}

__device__ __forceinline__ void add_pixel(float (&acc)[NU], const Pixel& x, const Edge& T,
                                          float inv_sigma_ray, float inv_sigma_dist,
                                          float huber_k) {
  const float p0 = fmaf(T.r00, x.xj0, fmaf(T.r01, x.xj1, fmaf(T.r02, x.xj2, T.tx)));
  const float p1 = fmaf(T.r10, x.xj0, fmaf(T.r11, x.xj1, fmaf(T.r12, x.xj2, T.ty)));
  const float p2 = fmaf(T.r20, x.xj0, fmaf(T.r21, x.xj1, fmaf(T.r22, x.xj2, T.tz)));

  const float ni2 = fmaxf(fmaf(x.xi0, x.xi0, fmaf(x.xi1, x.xi1, x.xi2 * x.xi2)), EPS);
  const float nj2 = fmaxf(fmaf(p0, p0, fmaf(p1, p1, p2 * p2)), EPS);
  const float inv_ni = rsqrt_approx(ni2);
  const float inv_nj = rsqrt_approx(nj2);
  const float rj0 = p0 * inv_nj, rj1 = p1 * inv_nj, rj2 = p2 * inv_nj;
  const float e0 = fmaf(-x.xi0, inv_ni, rj0);
  const float e1 = fmaf(-x.xi1, inv_ni, rj1);
  const float e2 = fmaf(-x.xi2, inv_ni, rj2);
  const float nj = nj2 * inv_nj;
  const float e3 = nj - ni2 * inv_ni;

  // dr/dP = (I - rj rj^T) / |P|
  const float a0 = rj0 * inv_nj, a1 = rj1 * inv_nj, a2 = rj2 * inv_nj;
  const float d00 = fmaf(-a0, rj0, inv_nj), d11 = fmaf(-a1, rj1, inv_nj),
              d22 = fmaf(-a2, rj2, inv_nj);
  const float d01 = -a0 * rj1, d02 = -a0 * rj2, d12 = -a1 * rj2;

  const float sw_ray = x.sq * inv_sigma_ray, sw_dist = x.sq * inv_sigma_dist;
  const float sw2_ray = sw_ray * sw_ray, sw2_dist = sw_dist * sw_dist;

  // rows [J_t(3) | J_rot(3) = -[rj]x row | J_s | err]; zeros never read
  const float b0[8] = {d00, d01, d02, 0.0f, rj2, -rj1, 0.0f, e0};
  const float b1[8] = {d01, d11, d12, -rj2, 0.0f, rj0, 0.0f, e1};
  const float b2[8] = {d02, d12, d22, rj1, -rj0, 0.0f, 0.0f, e2};
  const float b3[8] = {rj0, rj1, rj2, 0.0f, 0.0f, 0.0f, nj, e3};
  add_row<RAY0>(acc, b0, huber_w(sw_ray, sw2_ray, e0, huber_k));
  add_row<RAY1>(acc, b1, huber_w(sw_ray, sw2_ray, e1, huber_k));
  add_row<RAY2>(acc, b2, huber_w(sw_ray, sw2_ray, e2, huber_k));
  add_row<DIST>(acc, b3, huber_w(sw_dist, sw2_dist, e3, huber_k));
}

// Block b takes items b, b + gridDim.x, ...: item = (edge, tile), tile t
// the pixels [t pix, (t + 1) pix) of its edge.  Each item's 36 sums go to
// partial[item] in a fixed order; after grid.sync() block b writes edges
// b, b + gridDim.x, ..., each the sum of its tiles' partials in tile order.
__global__ void __launch_bounds__(THREADS, 2)
edge_hg_rays_kernel(const float* __restrict__ tij, const float* __restrict__ xi,
                    const float* __restrict__ xj, const float* __restrict__ sq,
                    float* __restrict__ partial, float* __restrict__ out,
                    unsigned long long* __restrict__ runs, int E, int N, int tiles, int pix,
                    float inv_sigma_ray, float inv_sigma_dist, float huber_k) {
  __shared__ float red[WARPS][NU];
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(runs, 1ull);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int items = E * tiles;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int e = item / tiles;
    const int tile = item - e * tiles;
    const float* Tp = tij + (int64_t)e * 8;
    const float qx = Tp[3], qy = Tp[4], qz = Tp[5], qw = Tp[6], s = Tp[7];
    const Edge T{s * (1.0f - 2.0f * (qy * qy + qz * qz)), s * (2.0f * (qx * qy - qz * qw)),
                 s * (2.0f * (qx * qz + qy * qw)),        s * (2.0f * (qx * qy + qz * qw)),
                 s * (1.0f - 2.0f * (qx * qx + qz * qz)), s * (2.0f * (qy * qz - qx * qw)),
                 s * (2.0f * (qx * qz - qy * qw)),        s * (2.0f * (qy * qz + qx * qw)),
                 s * (1.0f - 2.0f * (qx * qx + qy * qy)), Tp[0], Tp[1], Tp[2]};
    const float* exi = xi + (int64_t)e * N * 3;
    const float* exj = xj + (int64_t)e * N * 3;
    const float* esq = sq + (int64_t)e * N;

    float acc[NU];
#pragma unroll
    for (int k = 0; k < NU; ++k) acc[k] = 0.0f;

    const int end = min(N, (tile + 1) * pix);
    int n = min(N, tile * pix) + threadIdx.x;
    Pixel a = load_pixel(exi, exj, esq, n, N - 1, n < end);
    Pixel b = load_pixel(exi, exj, esq, n + THREADS, N - 1, n + THREADS < end);
#pragma unroll 2
    for (; n < end; n += 2 * THREADS) {
      // the next pair's loads go out before this pair's arithmetic
      const Pixel c = load_pixel(exi, exj, esq, n + 2 * THREADS, N - 1, n + 2 * THREADS < end);
      const Pixel d = load_pixel(exi, exj, esq, n + 3 * THREADS, N - 1, n + 3 * THREADS < end);
      add_pixel(acc, a, T, inv_sigma_ray, inv_sigma_dist, huber_k);
      add_pixel(acc, b, T, inv_sigma_ray, inv_sigma_dist, huber_k);
      a = c;
      b = d;
    }

    // the item's sums in a fixed order: lanes by shuffles, warps in order
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
      partial[(int64_t)item * NU + threadIdx.x] = v;
    }
    __syncthreads();
  }

  cg::this_grid().sync();
  if (threadIdx.x >= NU) return;
  const int k = threadIdx.x;
  // k -> (i, j), i <= j, in the order add_row writes them
  int i = 0, rem = k;
  while (rem >= 8 - i) {
    rem -= 8 - i;
    ++i;
  }
  const int j = i + rem;
  for (int e = blockIdx.x; e < E; e += gridDim.x) {
    float v = 0.0f;
    for (int t = 0; t < tiles; ++t) v += __ldcg(partial + ((int64_t)e * tiles + t) * NU + k);
    out[(int64_t)e * 64 + i * 8 + j] = v;
    out[(int64_t)e * 64 + j * 8 + i] = v;
  }
}

}  // namespace

// Blocks of the kernel that the card holds at once (SMs x blocks an SM):
// the most a cooperative launch may take.
extern "C" int edge_hg_rays_slots(void) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, edge_hg_rays_kernel, THREADS, 0) !=
          cudaSuccess)
    return -1;
  return sms * per_sm;
}

// tij: (E, 8) f32; xi, xj: (E, N, 3) f32; sq: (E, N) f32, all contiguous;
// partial: scratch of (E * tiles, 36) f32; out: (E, 8, 8) f32; runs: one
// u64 that each run adds one to.  E, N, tiles >= 1, 3 N < 2^31; slots
// from edge_hg_rays_slots.  One cooperative launch of min(E * tiles,
// slots) blocks on `stream` (captured too); returns its error.
extern "C" int edge_hg_rays_f32(const void* tij, const void* xi, const void* xj,
                                const void* sq, void* partial, void* out, void* runs, int E,
                                int N, int tiles, int slots, float inv_sigma_ray,
                                float inv_sigma_dist, float huber_k, void* stream) {
  const float *t = static_cast<const float*>(tij), *a = static_cast<const float*>(xi),
              *b = static_cast<const float*>(xj), *c = static_cast<const float*>(sq);
  float *pa = static_cast<float*>(partial), *o = static_cast<float*>(out);
  unsigned long long* r = static_cast<unsigned long long*>(runs);
  int pix = (N + tiles - 1) / tiles;
  void* args[] = {&t, &a, &b, &c, &pa, &o, &r, &E, &N, &tiles, &pix,
                  &inv_sigma_ray, &inv_sigma_dist, &huber_k};
  const int items = E * tiles;
  cudaLaunchAttribute coop[1];
  coop[0].id = cudaLaunchAttributeCooperative;
  coop[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(items < slots ? items : slots);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = reinterpret_cast<cudaStream_t>(stream);
  cfg.attrs = coop;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(edge_hg_rays_kernel), args));
}
