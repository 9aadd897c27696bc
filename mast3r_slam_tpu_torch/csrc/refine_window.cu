// Coarse-to-fine descriptor window argmax on int8 descriptors, for Hopper
// (sm_90a).  Bound through ctypes by ops/refine.py.
//
// Replaces: mast3r_slam_tpu/ops/refine_pallas.py  refine_r1_pallas / _kernel
// (the radius-1, one-level case), and computes the whole of
// mast3r_slam_tpu/ops/matching.py refine_matches(radius, dilation_max): for
// every source pixel, at dilation d = dilation_max .. 1, score the
// (2r+1)^2 candidates around its current match by the exact int32 dot
// product of int8 descriptors, mask out-of-image candidates to INT32_MIN,
// take the first maximum in dy-major order (= jnp.argmax) and move there.
// The TPU kernel never shipped: Mosaic had no usable in-VMEM gather.  A GPU
// gathers natively.
//
// What bounds it on the H100: bytes.  At 384x512, F = 24 it must read the
// 4.7 MB int8 image, the 4.7 MB of source descriptors and 0.8 MB of start
// indices, and write 0.8 MB of results: about 11 MB, 3.3 us at 3.35 TB/s.
// The work is 49 candidates x 5 levels x 6 dp4a per pixel, 0.3 G int8
// dot-products, far under the int8 peak.
//
// Design: one thread per source pixel walks every level, since each
// pixel's pyramid is independent of the others.  Its own descriptor sits in
// 6 registers; each candidate is 3 8-byte loads and 6 __dp4a.  The image
// (4.7 MB) stays in the 50 MB L2, so the repeated candidate reads are L2
// hits and device memory sees each byte about once.  Simple and right first;
// a shared-memory window per block comes later.

#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>

namespace {

constexpr int MAX_WORDS = 16;  // F <= 64 int8 values, in 32-bit words
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
refine_window_kernel(const int8_t* __restrict__ d11,
                     const int8_t* __restrict__ d21,
                     const int32_t* __restrict__ idx_in,
                     int32_t* __restrict__ idx_out, int B, int N, int H, int W,
                     int F, int radius, int dilation_max) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)B * N) return;
  const int b = (int)(t / N);
  const int words = F / 4;

  int a[MAX_WORDS];
  const int* src = reinterpret_cast<const int*>(d21 + t * F);
#pragma unroll
  for (int w = 0; w < MAX_WORDS; ++w) a[w] = (w < words) ? __ldg(src + w) : 0;
  // rows are read 8 bytes a load where F % 8 == 0 (F = 24: 3 loads, not 6;
  // a 24-byte row is 8-byte aligned but not 16-byte aligned)
  const bool pairs = (F % 8) == 0;

  const int8_t* img = d11 + (int64_t)b * H * W * F;
  const int start = idx_in[t];
  int u0 = start % W;
  int v0 = start / W;
  const int diam = 2 * radius + 1;

  for (int d = dilation_max; d >= 1; --d) {
    int best = INT_MIN;
    int best_k = 0;
    for (int ky = 0; ky < diam; ++ky) {
      const int vv = v0 + (ky - radius) * d;
      const bool row_in = vv >= 0 && vv < H;
      for (int kx = 0; kx < diam; ++kx) {
        const int uu = u0 + (kx - radius) * d;
        int score = INT_MIN;
        if (row_in && uu >= 0 && uu < W) {
          const int8_t* row = img + ((int64_t)vv * W + uu) * F;
          int acc = 0;
          if (pairs) {
            const int2* row2 = reinterpret_cast<const int2*>(row);
#pragma unroll
            for (int w = 0; w < MAX_WORDS / 2; ++w) {
              if (2 * w < words) {
                const int2 x = __ldg(row2 + w);
                acc = __dp4a(x.x, a[2 * w], acc);
                acc = __dp4a(x.y, a[2 * w + 1], acc);
              }
            }
          } else {
            const int* row1 = reinterpret_cast<const int*>(row);
#pragma unroll
            for (int w = 0; w < MAX_WORDS; ++w)
              if (w < words) acc = __dp4a(__ldg(row1 + w), a[w], acc);
          }
          score = acc;
        }
        const int k = ky * diam + kx;
        // the first candidate seeds the max; after it a strict '>' keeps the
        // first maximum, exactly jnp.argmax's tie rule
        if (k == 0 || score > best) {
          best = score;
          best_k = k;
        }
      }
    }
    u0 += (best_k % diam - radius) * d;
    v0 += (best_k / diam - radius) * d;
  }
  idx_out[t] = v0 * W + u0;
}

}  // namespace

// d11: (B, H*W, F) int8, d21: (B, N, F) int8, idx_in/idx_out: (B, N) int32
// linear indices v*W + u.  F % 4 == 0 and F <= 64.  Launches on `stream`
// and returns cudaGetLastError().
extern "C" int refine_window_i8(const void* d11, const void* d21,
                                const void* idx_in, void* idx_out, int B,
                                int N, int H, int W, int F, int radius,
                                int dilation_max, void* stream) {
  const int64_t total = (int64_t)B * N;
  const int blocks = (int)((total + THREADS - 1) / THREADS);
  refine_window_kernel<<<blocks, THREADS, 0,
                         reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int8_t*>(d11), reinterpret_cast<const int8_t*>(d21),
      reinterpret_cast<const int32_t*>(idx_in),
      reinterpret_cast<int32_t*>(idx_out), B, N, H, W, F, radius, dilation_max);
  return static_cast<int>(cudaGetLastError());
}
