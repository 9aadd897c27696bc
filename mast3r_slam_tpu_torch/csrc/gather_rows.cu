// Row gather followed by a reduction over the row, for Hopper (sm_90a).
// Bound through ctypes by ops/gather.py, whose sum_plan sizes the launch.
//
//   gather_rows_sum  out[t] = sum_f float(table[idx[t], f]), int8 or f32.
//     Replaces: scripts/tpu_r4_experiments.py  gatherprobe -> run (the
//     Mosaic in-VMEM gather probe, kernel body `kern`).
//
// What bounds it on the H100: latency.  Each output row reads its index,
// then one table row at a random place (16 to 128 bytes); at the probe's
// 196,608 rows of 32 int8 that is 7.9 MB, 2.3 us at 3.35 TB/s, but a row
// read cannot start before its index arrives, so a wave of threads waits
// out two memory round trips in series.  A launch that runs in two waves
// waits four.  The reductions are one dp4a a word of int8 (into an exact
// int32) or one f32 add a word.
//
// Design: the whole call in one wave.  A group of `lanes` threads (a power
// of two) takes a row, each lane 32 bytes of it a pass (two 16-byte loads,
// or 8- or 4-byte loads where the row is not a multiple of 16): a row of
// up to 32 bytes is one thread's, with no shuffle; a 128-byte f32 row takes
// 4 lanes.  The grid is at most the blocks the card holds at once
// (gather_rows_sum_slots), so where T rows exceed one wave a group takes
// `rows` consecutive rows, 4 at a time: the 4 indices in one 16-byte load,
// then every row load of the 4, then the sums.  Each lane sums its words
// in order and the group combines its lanes by an xor-shuffle tree: a
// fixed order, so every call gives the same bits.  An index outside the
// table reads nothing: the sum is NaN.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PIECE = 8;  // words a lane takes of a row a pass (32 bytes)

// plain loads: through L1, so the second 16-byte load of a 32-byte row
// finds the sector the first brought (L2-only loads timed 1.3 us slower at
// the probe's int8 rows on an H100)
template <int NW>
__device__ __forceinline__ void load_words(const uint32_t* p, uint32_t* w) {
  if constexpr (NW == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (NW == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = *p;
  }
}

// int8: the word's four values summed in an int32 (dp4a against ones),
// exact, so the f32 of the sum is the plain version's for any row of fewer
// than 2^17 values (every partial sum then below 2^24 in magnitude)
struct SumInt8 {
  using Acc = int;
  __device__ static void add(int& a, uint32_t w) { a = __dp4a((int)w, 0x01010101, a); }
};

struct SumF32 {
  using Acc = float;
  __device__ static void add(float& a, uint32_t w) { a += __uint_as_float(w); }
};

// NW: words a load (4, 2 or 1: the largest that divides the row); RB: rows
// a group loads at once (1, or 4 where a group takes several rows)
template <int NW, int RB, class Op>
__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const uint32_t* __restrict__ table, const int32_t* __restrict__ idx,
                   float* __restrict__ out, int64_t n_out, int M, int row_words, int lanes,
                   int rows) {
  using Acc = typename Op::Acc;
  const int lanes_log2 = __ffs(lanes) - 1;  // a power of two: shifts, no division
  const int lane = threadIdx.x & (lanes - 1);
  const int64_t first =
      (((int64_t)blockIdx.x * THREADS + threadIdx.x) >> lanes_log2) * rows;
  const int passes = (row_words + (lanes << 3) - 1) >> (lanes_log2 + 3);  // PIECE = 8
  // every lane of a warp runs the same trip counts and reaches the shuffles
  for (int b = 0; b < rows; b += RB) {
    const int64_t r0 = first + b;
    int r[RB];
    bool loaded = false;
    if constexpr (RB == 4) {
      // rows % 4 == 0: 16-byte aligned where idx is
      if ((reinterpret_cast<uintptr_t>(idx) & 15) == 0 && r0 + RB <= n_out) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(idx + r0));
        r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
        loaded = true;
      }
    }
    if (!loaded) {
#pragma unroll
      for (int k = 0; k < RB; ++k) r[k] = r0 + k < n_out ? __ldg(idx + r0 + k) : -1;
    }
    bool ok[RB];
    Acc acc[RB];
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      ok[k] = r[k] >= 0 && r[k] < M;
      acc[k] = 0;
    }
    for (int p = 0; p < passes; ++p) {
      const int w0 = (p * lanes + lane) * PIECE;
      uint32_t w[RB][PIECE];
#pragma unroll
      for (int k = 0; k < RB; ++k)
#pragma unroll
        for (int j = 0; j < PIECE; j += NW)
          if (ok[k] && w0 + j < row_words)
            load_words<NW>(table + (int64_t)r[k] * row_words + w0 + j, &w[k][j]);
#pragma unroll
      for (int k = 0; k < RB; ++k)
#pragma unroll
        for (int j = 0; j < PIECE; ++j)
          if (ok[k] && w0 + j < row_words) Op::add(acc[k], w[k][j]);
    }
#pragma unroll
    for (int k = 0; k < RB; ++k) {
      for (int s = lanes / 2; s > 0; s >>= 1) acc[k] += __shfl_xor_sync(0xffffffffu, acc[k], s);
      if (lane == 0 && r0 + k < n_out)
        out[r0 + k] = ok[k] ? (float)acc[k] : __int_as_float(0x7fc00000);
    }
  }
}

template <class Op>
const void* kernel_of(int nw, int rb) {
  if (rb == 4)
    return nw == 4 ? reinterpret_cast<const void*>(gather_rows_kernel<4, 4, Op>)
         : nw == 2 ? reinterpret_cast<const void*>(gather_rows_kernel<2, 4, Op>)
                   : reinterpret_cast<const void*>(gather_rows_kernel<1, 4, Op>);
  return nw == 4 ? reinterpret_cast<const void*>(gather_rows_kernel<4, 1, Op>)
       : nw == 2 ? reinterpret_cast<const void*>(gather_rows_kernel<2, 1, Op>)
                 : reinterpret_cast<const void*>(gather_rows_kernel<1, 1, Op>);
}

const void* kernel_of(int is_int8, int nw, int rb) {
  return is_int8 ? kernel_of<SumInt8>(nw, rb) : kernel_of<SumF32>(nw, rb);
}

}  // namespace

// Blocks of THREADS threads the card holds at once for one instance of the
// kernel (is_int8, words a load nw in {1, 2, 4}, rows a load rb in {1, 4}),
// or -1 if the query failed.
extern "C" int gather_rows_sum_slots(int is_int8, int nw, int rb) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel_of(is_int8, nw, rb),
                                                    THREADS, 0) != cudaSuccess)
    return -1;
  return sms * per_sm;
}

// table: (M, F) int8 (is_int8 = 1, F % 4 == 0) or f32, 16-byte aligned;
// idx: (T,) int32; out: (T,) f32.  T >= 1.  The plan (ops/gather.py
// sum_plan): nw divides the row's words, lanes a power of two <= 32, rb 1
// or 4 and rows a multiple of rb, grid blocks of THREADS threads covering
// ceil(T / rows) groups.  Returns the launch's error.
extern "C" int gather_rows_sum(const void* table, const void* idx, void* out, int T, int M,
                               int F, int is_int8, int nw, int lanes, int rb, int rows,
                               int grid, void* stream) {
  const int row_words = is_int8 ? F / 4 : F;
  if ((nw != 1 && nw != 2 && nw != 4) || row_words % nw || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) || (rb != 1 && rb != 4) || rows < rb || rows % rb || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* fn = kernel_of(is_int8, nw, rb);
  const uint32_t* t = reinterpret_cast<const uint32_t*>(table);
  const int32_t* ix = reinterpret_cast<const int32_t*>(idx);
  float* o = reinterpret_cast<float*>(out);
  int64_t n_out = T;
  void* args[] = {&t, &ix, &o, &n_out, &M, (void*)&row_words, &lanes, &rows};
  cudaError_t err = cudaLaunchKernel(fn, dim3(grid), dim3(THREADS), args, 0,
                                     reinterpret_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
