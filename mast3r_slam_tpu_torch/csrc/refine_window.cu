// Coarse-to-fine descriptor window argmax on int8 descriptors, for Hopper
// (sm_90a).  Bound through ctypes by ops/refine.py.
//
// Replaces: mast3r_slam_tpu/ops/refine_pallas.py  refine_r1_pallas / _kernel
// (the radius-1, one-level case), and computes the whole of
// mast3r_slam_tpu/ops/matching.py refine_matches(radius, dilation_max) and
// the subset levels of refine_matches_gated: for every source pixel, at
// each dilation d of a short schedule given by value (dilation_max .. 1
// for refine_matches; (5, 2) on the speed profile's compacted subset, whose
// strip tables score the same candidates in the same k = dy*diam + dx
// order), score the (2r+1)^2 candidates around its current match by the
// exact int32 dot product of int8 descriptors, mask out-of-image
// candidates to INT32_MIN, take the first maximum in dy-major order (=
// jnp.argmax) and move there.  Sources may come in any order (a compacted
// subset is not in image order): the window and global paths below are
// both exact for any set of a block's pixels.
// The TPU kernel never shipped: Mosaic had no usable in-VMEM gather.
//
// What bounds it on the H100: bytes.  At 384x512, F = 24 it must read the
// 4.7 MB int8 image, the 4.7 MB of source descriptors and 0.8 MB of start
// indices, and write 0.8 MB of results: about 11 MB, 3.3 us at 3.35 TB/s.
// The candidates it scores are 25 times the image (49 a level, 5 levels,
// 24 bytes each: 1.16 GB at 384x512), so where they are read from sets its
// pace: from L2 one pixel a thread (the first form of this kernel) took
// 0.58 ms.
//
// Design: a shared-memory window per block per level.  A block takes a
// 16x16 patch of source pixels where N == H*W (neighbouring pixels have
// nearby matches on real data), else a run of 256.  At each level the block
// reduces the bounding box of its pixels' current matches, widens it by
// r*d and clamps it to the image.  If that window fits the budget, the
// block copies it from the int8 image into shared memory with cp.async (16
// bytes a copy where the rows allow) and scores every candidate from there;
// a window copied at an earlier level serves again, uncopied, where it
// contains the new one.  A block whose window is over the budget reads its
// candidates from global memory (L2) instead; both paths compute the same
// exact scores, so the result does not depend on the path.
//
// The pixel's own descriptor sits in registers; from the window one thread
// scores its pixel's candidates, each F/8 8-byte shared loads and F/4
// dp4a.  From global memory a group of 8 lanes scores one pixel, a
// candidate column a lane, so that a pixel's loads are in flight together
// (one thread a pixel waits on them a row at a time).

#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>

namespace {

constexpr int TILE = 16;                 // a block's patch: TILE x TILE pixels
constexpr int THREADS = TILE * TILE;
constexpr int WARPS = THREADS / 32;
constexpr int WIN_BYTES = 70 * 1024;     // the window's budget: 3 blocks an SM
constexpr int MAX_LEVELS = 8;            // dilations a schedule may hold
constexpr int MAX_DEVICES = 64;  // cards a process may launch on

// the dilations of one launch, in the order they run, passed by value
struct Schedule {
  int n;
  int d[MAX_LEVELS];
};

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, int bytes) {
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(dst), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(src) : "memory");
}

// the int32 score of one candidate row against the descriptor `a`
template <int WORDS, bool GLOBAL>
__device__ __forceinline__ int dot_row(const int8_t* row, const int (&a)[WORDS]) {
  int acc = 0;
  if constexpr (WORDS % 2 == 0) {
    const int2* row2 = reinterpret_cast<const int2*>(row);
#pragma unroll
    for (int w = 0; w < WORDS / 2; ++w) {
      const int2 x = GLOBAL ? __ldg(row2 + w) : row2[w];
      acc = __dp4a(x.x, a[2 * w], acc);
      acc = __dp4a(x.y, a[2 * w + 1], acc);
    }
  } else {
    const int* row1 = reinterpret_cast<const int*>(row);
#pragma unroll
    for (int w = 0; w < WORDS; ++w) acc = __dp4a(GLOBAL ? __ldg(row1 + w) : row1[w], a[w], acc);
  }
  return acc;
}

constexpr unsigned FULL = 0xffffffffu;
constexpr int OFF_IMAGE = -(1 << 28);   // a row that puts every candidate outside
// the global pass: a group of GROUP lanes scores one pixel's candidates,
// lane `sub` the columns sub, sub + GROUP, ... of every row, so one pixel's
// loads are in flight together; a warp scores 32 / GROUP pixels at once
constexpr int GROUP = 8;

// the first best of the (2r+1)^2 candidates at dilation d around (u0, v0),
// read from the shared-memory window `win`, of row stride `stride` pixels,
// whose (0, 0) is image pixel (ox, oy); returns the candidate's dy-major
// index
template <int WORDS>
__device__ __forceinline__ int best_candidate(const int8_t* win, int stride, int ox, int oy,
                                              int u0, int v0, int H, int W, int radius,
                                              int d, const int (&a)[WORDS]) {
  constexpr int F = 4 * WORDS;
  const int diam = 2 * radius + 1;
  int best = INT_MIN;
  int best_k = 0;
#pragma unroll 1
  for (int ky = 0; ky < diam; ++ky) {
    const int vv = v0 + (ky - radius) * d;
    const bool row_in = vv >= 0 && vv < H;
    for (int kx = 0; kx < diam; ++kx) {
      const int uu = u0 + (kx - radius) * d;
      int score = INT_MIN;
      if (row_in && uu >= 0 && uu < W)
        score = dot_row<WORDS, false>(win + ((vv - oy) * stride + (uu - ox)) * F, a);
      const int k = ky * diam + kx;
      // the first candidate seeds the max; after it a strict '>' keeps the
      // first maximum, exactly jnp.argmax's tie rule
      if (k == 0 || score > best) {
        best = score;
        best_k = k;
      }
    }
  }
  return best_k;
}

// best_candidate over the image `img` (row stride W) in global memory, with
// a group of GROUP lanes on one pixel; every lane of the group returns the
// index.  The whole warp calls it.
template <int WORDS>
__device__ __forceinline__ int group_best(const int8_t* img, int u0, int v0, int H, int W,
                                          int radius, int d, const int (&a)[WORDS],
                                          int sub) {
  constexpr int F = 4 * WORDS;
  const int diam = 2 * radius + 1;
  int best = INT_MIN;
  int best_k = INT_MAX;  // no candidate yet
  for (int ky = 0; ky < diam; ++ky) {
    const int vv = v0 + (ky - radius) * d;
    const bool row_in = vv >= 0 && vv < H;
    for (int kx = sub; kx < diam; kx += GROUP) {
      const int uu = u0 + (kx - radius) * d;
      int score = INT_MIN;
      if (row_in && uu >= 0 && uu < W)
        score = dot_row<WORDS, true>(img + (static_cast<int64_t>(vv) * W + uu) * F, a);
      // a lane's candidates come in increasing k: its first seeds the max,
      // then a strict '>' keeps its first maximum
      if (best_k == INT_MAX || score > best) {
        best = score;
        best_k = ky * diam + kx;
      }
    }
  }
  // over the group: the larger score, on a tie the smaller k, which is
  // jnp.argmax's first maximum (a lane without candidates has k INT_MAX)
#pragma unroll
  for (int off = GROUP / 2; off > 0; off >>= 1) {
    const int s2 = __shfl_xor_sync(FULL, best, off);
    const int k2 = __shfl_xor_sync(FULL, best_k, off);
    if (s2 > best || (s2 == best && k2 < best_k)) {
      best = s2;
      best_k = k2;
    }
  }
  return best_k;
}

// tiles_w > 0: blocks are TILE x TILE patches, tiles_w of them a row (N ==
// H*W); else runs of THREADS sources.  Copies move `gran` bytes (16, 8 or
// 4), and a window's columns start and end on multiples of `align_px`
// pixels, so every copy is aligned.  stats (optional): (block, level) pairs
// served from a window, all (block, level) pairs, pixel-levels served from
// a window, all pixel-levels.
template <int WORDS>
__global__ void __launch_bounds__(THREADS, 3)
refine_window_kernel(const int8_t* __restrict__ d11, const int8_t* __restrict__ d21,
                     const int32_t* __restrict__ idx_in, int32_t* __restrict__ idx_out,
                     int N, int H, int W, int radius, const Schedule sched, int tiles_w,
                     int gran, int align_px, unsigned long long* __restrict__ stats) {
  constexpr int F = 4 * WORDS;
  extern __shared__ __align__(16) int8_t win[];
  __shared__ int red[WARPS][4];
  // the global pass: each pixel's source index (-1: none) and current
  // match, then the candidate its lane group found
  __shared__ int pack_n[THREADS], pack_lin[THREADS], pack_k[THREADS];
  const int diam = 2 * radius + 1;

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  int n;
  if (tiles_w > 0) {
    const int px = (blockIdx.x % tiles_w) * TILE + tid % TILE;
    const int py = (blockIdx.x / tiles_w) * TILE + tid / TILE;
    n = (px < W && py < H) ? py * W + px : -1;
  } else {
    n = blockIdx.x * THREADS + tid;
    if (n >= N) n = -1;
  }
  const bool valid = n >= 0;
  const int64_t t = static_cast<int64_t>(b) * N + (valid ? n : 0);

  int a[WORDS];
  int u0 = 0, v0 = 0;
  if (valid) {
    const int* src = reinterpret_cast<const int*>(d21 + t * F);
#pragma unroll
    for (int w = 0; w < WORDS; ++w) a[w] = __ldg(src + w);
    const int start = idx_in[t];
    u0 = start % W;
    v0 = start / W;
  } else {
#pragma unroll
    for (int w = 0; w < WORDS; ++w) a[w] = 0;
  }
  const int8_t* img = d11 + static_cast<int64_t>(b) * H * W * F;
  const uint32_t win_s = static_cast<uint32_t>(__cvta_generic_to_shared(win));
  const int warp = tid / 32, lane = tid % 32;
  const int cnt = __syncthreads_count(valid);
  // the window in shared memory, kept across levels until a copy replaces it
  int kwu0 = 0, kwv0 = 0, kww = 0, kwh = 0;
  bool kept = false;

#pragma unroll 1
  for (int level = 0; level < sched.n; ++level) {
    const int d = sched.d[level];
    const int rd = radius * d;
    // the bounding box of the block's matches
    int vals[4] = {valid ? u0 : INT_MAX, valid ? -u0 : INT_MAX, valid ? v0 : INT_MAX,
                   valid ? -v0 : INT_MAX};
#pragma unroll
    for (int i = 0; i < 4; ++i) vals[i] = warp_min(vals[i]);
    if (lane == 0)
#pragma unroll
      for (int i = 0; i < 4; ++i) red[warp][i] = vals[i];
    __syncthreads();
    int umin = INT_MAX, umax = INT_MIN, vmin = INT_MAX, vmax = INT_MIN;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      umin = min(umin, red[w][0]);
      umax = max(umax, -red[w][1]);
      vmin = min(vmin, red[w][2]);
      vmax = max(vmax, -red[w][3]);
    }

    // the window [wu0, wu0 + ww) x [wv0, wv0 + wh): the box widened by r*d,
    // clamped to the image, columns on multiples of align_px; it holds every
    // in-image candidate of every pixel of the block
    int wu0 = max(umin - rd, 0) / align_px * align_px;
    int ww = min((umax + rd + 1 + align_px - 1) / align_px * align_px, W) - wu0;
    int wv0 = max(vmin - rd, 0);
    int wh = min(vmax + rd + 1, H) - wv0;
    const bool use_win = static_cast<int64_t>(ww) * wh * F <= WIN_BYTES;
    if (stats != nullptr && tid == 0) {
      atomicAdd(stats, use_win ? 1ull : 0ull);
      atomicAdd(stats + 1, 1ull);
      atomicAdd(stats + 2, use_win ? static_cast<unsigned long long>(cnt) : 0ull);
      atomicAdd(stats + 3, static_cast<unsigned long long>(cnt));
    }

    if (use_win) {
      if (kept && wu0 >= kwu0 && wu0 + ww <= kwu0 + kww && wv0 >= kwv0 &&
          wv0 + wh <= kwv0 + kwh) {
        // the kept window contains this one: it serves, uncopied
        wu0 = kwu0;
        wv0 = kwv0;
        ww = kww;
        wh = kwh;
      } else {
        kwu0 = wu0;
        kwv0 = wv0;
        kww = ww;
        kwh = wh;
        kept = true;
        const int row_bytes = ww * F;
        const int per_row = row_bytes / gran;
        for (int c = tid; c < wh * per_row; c += THREADS) {
          const int row = c / per_row;
          const int col = (c - row * per_row) * gran;
          cp_async(win_s + row * row_bytes + col,
                   img + (static_cast<int64_t>(wv0 + row) * W + wu0) * F + col, gran);
        }
        asm volatile("cp.async.commit_group;" ::: "memory");
        asm volatile("cp.async.wait_group 0;" ::: "memory");
        __syncthreads();
      }
      if (valid) {
        const int k = best_candidate<WORDS>(win, ww, wu0, wv0, u0, v0, H, W, radius, d, a);
        u0 += (k % diam - radius) * d;
        v0 += (k / diam - radius) * d;
      }
    } else {
      // every pixel reads global memory, a lane group a pixel
      pack_n[tid] = n;
      pack_lin[tid] = v0 * W + u0;
      __syncthreads();
      for (int base = warp * (32 / GROUP); base < THREADS; base += THREADS / GROUP) {
        const int j = base + lane / GROUP;
        const bool active = pack_n[j] >= 0;
        int pa[WORDS];
        int pu = 0, pv = OFF_IMAGE;
        if (active) {
          const int* src = reinterpret_cast<const int*>(
              d21 + (static_cast<int64_t>(b) * N + pack_n[j]) * F);
#pragma unroll
          for (int w = 0; w < WORDS; ++w) pa[w] = __ldg(src + w);
          pu = pack_lin[j] % W;
          pv = pack_lin[j] / W;
        } else {
#pragma unroll
          for (int w = 0; w < WORDS; ++w) pa[w] = 0;
        }
        const int k = group_best<WORDS>(img, pu, pv, H, W, radius, d, pa, lane % GROUP);
        if (active && lane % GROUP == 0) pack_k[j] = k;
      }
      __syncthreads();
      if (valid) {
        const int k = pack_k[tid];
        u0 += (k % diam - radius) * d;
        v0 += (k / diam - radius) * d;
      }
    }
    __syncthreads();  // the window, `red` and the packs are rewritten at the next level
  }
  if (valid) idx_out[t] = v0 * W + u0;
}

template <int WORDS>
cudaError_t launch(const int8_t* d11, const int8_t* d21, const int32_t* idx_in,
                   int32_t* idx_out, int B, int N, int H, int W, int radius,
                   const Schedule& sched, unsigned long long* stats, cudaStream_t stream) {
  // the attribute is the current device's: set it once on each card
  static bool attr_set[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!attr_set[device]) {
    e = cudaFuncSetAttribute(refine_window_kernel<WORDS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, WIN_BYTES);
    if (e != cudaSuccess) return e;
    attr_set[device] = true;
  }
  constexpr int F = 4 * WORDS;
  // the widest copy that every window row allows: image rows, the base
  // pointer and whole pixels runs of align_px all on `gran` bytes
  const auto fits = [&](int g) {
    return (static_cast<int64_t>(W) * F) % g == 0 && reinterpret_cast<uintptr_t>(d11) % g == 0;
  };
  const int gran = fits(16) ? 16 : (fits(8) ? 8 : 4);
  int common = F, x = gran;  // gcd(F, gran)
  while (x) { const int r = common % x; common = x; x = r; }
  const int align_px = gran / common;
  const int tiles_w = (N == H * W) ? (W + TILE - 1) / TILE : 0;
  const int blocks = tiles_w ? tiles_w * ((H + TILE - 1) / TILE) : (N + THREADS - 1) / THREADS;
  refine_window_kernel<WORDS><<<dim3(blocks, B), THREADS, WIN_BYTES, stream>>>(
      d11, d21, idx_in, idx_out, N, H, W, radius, sched, tiles_w, gran, align_px, stats);
  return cudaGetLastError();
}

}  // namespace

// d11: (B, H*W, F) int8, d21: (B, N, F) int8, idx_in/idx_out: (B, N) int32
// linear indices v*W + u.  F % 4 == 0 and F <= 64.  dilations: n_levels
// (1 .. 8) host ints >= 1, the levels in the order they run.  stats: null,
// or four zeroed uint64 counters the kernel adds to (see the kernel).
// Launches on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for another F or schedule).
extern "C" int refine_window_i8(const void* d11, const void* d21, const void* idx_in,
                                void* idx_out, int B, int N, int H, int W, int F,
                                int radius, const int* dilations, int n_levels, void* stats,
                                void* stream) {
  if (n_levels < 1 || n_levels > MAX_LEVELS) return static_cast<int>(cudaErrorInvalidValue);
  Schedule sched{};
  sched.n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    if (dilations[l] < 1) return static_cast<int>(cudaErrorInvalidValue);
    sched.d[l] = dilations[l];
  }
  const auto* a = reinterpret_cast<const int8_t*>(d11);
  const auto* q = reinterpret_cast<const int8_t*>(d21);
  const auto* i = reinterpret_cast<const int32_t*>(idx_in);
  auto* o = reinterpret_cast<int32_t*>(idx_out);
  auto* st = reinterpret_cast<unsigned long long*>(stats);
  auto s = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (F / 4) {
#define REFINE_CASE(WORDS)                                                              \
    case WORDS:                                                                         \
      e = launch<WORDS>(a, q, i, o, B, N, H, W, radius, sched, st, s);           \
      break;
    REFINE_CASE(1) REFINE_CASE(2) REFINE_CASE(3) REFINE_CASE(4)
    REFINE_CASE(5) REFINE_CASE(6) REFINE_CASE(7) REFINE_CASE(8)
    REFINE_CASE(9) REFINE_CASE(10) REFINE_CASE(11) REFINE_CASE(12)
    REFINE_CASE(13) REFINE_CASE(14) REFINE_CASE(15) REFINE_CASE(16)
#undef REFINE_CASE
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// dynamic shared memory a block takes (the window's budget, bytes), for the
// smoke run's log
extern "C" int refine_window_smem_bytes() { return WIN_BYTES; }
