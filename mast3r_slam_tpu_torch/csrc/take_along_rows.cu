// Same-shape take along rows, out[i, f] = tab[idx[i, f], f], for Hopper
// (sm_90a).  Bound through ctypes by ops/gather.py, whose take_plan sizes
// the launch.
//
// Replaces: scripts/tpu_r4_experiments.py  gatherprobe2 -> run (Mosaic's
// only supported in-kernel gather, jnp.take_along_axis on axis 0).
//
// What bounds it on the H100: L2 requests.  Each output element reads one
// table element at a random row, and a random element costs a whole
// 32-byte sector request: 25.2 M of them at the probe's (196,608, 128)
// f32, each to a random line.
// The table (100.7 MB) is twice the L2, and the L2 allocates 128-byte
// lines: whatever the columns taken at once, one line a table row, M lines
// (25 MB at the probe), is the least footprint of a pass over the rows.
// The bytes the call must move are the table's once, idx and out: 302 MB.
//
// Design: slab-major order.  A slab is slab_cols consecutive columns (32
// to 128 bytes of a table row; 128 timed fastest on an H100, and with it
// idx and out move in whole lines).  Blocks take (slab, row-chunk) items in that
// order.  In one pass a block takes one item, and the card dispatches
// blocks in order.  Where the plan asks for passes > 1 (a table the L2
// cannot keep whole), a persistent grid (at most take_along_rows_slots,
// the blocks the card holds at once; one cooperative launch) walks one
// slab a pass and waits at a grid barrier before the next, so that only
// one slab's lines are live in L2 at a time.  A thread takes 4 consecutive
// elements of a slab row (one 16-byte index load, 4 table reads issued
// before any is used, one 4-value store), consecutive threads consecutive
// groups, so that each warp instruction moves idx and out in whole lines.
// idx and out pass once, with streaming hints (ld/st .cs).  Nothing
// device-wide is set.  Exact: nothing is computed.  An index outside
// [0, M) reads nothing and writes NaN (f32) or 0 (int8).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__device__ __forceinline__ T poison();
template <>
__device__ __forceinline__ float poison<float>() { return __int_as_float(0x7fc00000); }
template <>
__device__ __forceinline__ int8_t poison<int8_t>() { return 0; }

constexpr int C = 4;  // elements a thread: one 16-byte index load

template <typename T>
struct Vec4;  // 4 values: 16 bytes of f32, 4 of int8
template <>
struct Vec4<float> { using type = float4; };
template <>
struct Vec4<int8_t> { using type = char4; };

// One item: THREADS / tps rows of slab `slab` from row chunk * (THREADS /
// tps), thread t on the 4 columns t % tps of the item's row t / tps, where
// tps = slab_cols / C (consecutive threads, consecutive column groups).
template <typename T>
__device__ __forceinline__ void take_item(const T* __restrict__ tab,
                                          const int32_t* __restrict__ idx, T* __restrict__ out,
                                          int K, int M, int F, int slab_cols, int slab,
                                          int chunk) {
  using V = typename Vec4<T>::type;
  const int tps_log2 = __ffs(slab_cols / C) - 1;  // threads a row of a slab: a power of two
  const int64_t i = (int64_t)chunk * (THREADS >> tps_log2) + (threadIdx.x >> tps_log2);
  const int c0 = slab * slab_cols + (threadIdx.x & ((1 << tps_log2) - 1)) * C;
  if (i >= K || c0 >= F) return;
  const int64_t base = i * F + c0;
  // 4 | F: 16-byte index loads (the wrapper checks idx's base) and 4-value
  // stores (out is a fresh allocation) stay aligned
  const bool full = F % C == 0 && c0 + C <= F;
  int ix[C];
  if (full) {
    const int4 v = __ldcs(reinterpret_cast<const int4*>(idx + base));
    ix[0] = v.x; ix[1] = v.y; ix[2] = v.z; ix[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < C; ++k) ix[k] = c0 + k < F ? __ldcs(idx + base + k) : -1;
  }
  T v[C];
#pragma unroll
  for (int k = 0; k < C; ++k)
    v[k] = (ix[k] >= 0 && ix[k] < M) ? __ldg(tab + (int64_t)ix[k] * F + c0 + k) : poison<T>();
  if (full) {
    V w;
    w.x = v[0]; w.y = v[1]; w.z = v[2]; w.w = v[3];
    __stcs(reinterpret_cast<V*>(out + base), w);
  } else {
#pragma unroll
    for (int k = 0; k < C; ++k)
      if (c0 + k < F) out[base + k] = v[k];
  }
}

// One pass: a block an item, (chunk, slab) = (blockIdx.x, blockIdx.y), so
// the card's in-order dispatch walks the items slab-major.
template <typename T>
__global__ void __launch_bounds__(THREADS)
take_along_rows_kernel(const T* __restrict__ tab, const int32_t* __restrict__ idx,
                       T* __restrict__ out, int K, int M, int F, int slab_cols) {
  take_item(tab, idx, out, K, M, F, slab_cols, blockIdx.y, blockIdx.x);
}

// One pass a slab: the persistent grid walks the slab's chunks, then waits
// at a grid barrier before the next slab (a cooperative launch).
template <typename T>
__global__ void __launch_bounds__(THREADS)
take_along_rows_passes_kernel(const T* __restrict__ tab, const int32_t* __restrict__ idx,
                              T* __restrict__ out, int K, int M, int F, int slab_cols,
                              int chunks, int n_slabs) {
  for (int slab = 0; slab < n_slabs; ++slab) {
    if (slab > 0) cooperative_groups::this_grid().sync();
    for (int chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x)
      take_item(tab, idx, out, K, M, F, slab_cols, slab, chunk);
  }
}

}  // namespace

// Blocks of THREADS threads the card holds at once of the one-pass-a-slab
// kernel for one element size (1 or 4 bytes), or -1 if the query failed.
extern "C" int take_along_rows_slots(int elem_bytes) {
  int dev = 0, sms = 0, per_sm = 0;
  const void* fn =
      elem_bytes == 1 ? reinterpret_cast<const void*>(take_along_rows_passes_kernel<int8_t>)
                      : reinterpret_cast<const void*>(take_along_rows_passes_kernel<float>);
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, THREADS, 0) != cudaSuccess)
    return -1;
  return sms * per_sm;
}

// tab: (M, F) int8 (elem_bytes = 1) or f32 (elem_bytes = 4); idx (K, F)
// int32, 16-byte aligned; out (K, F) of tab's type, 16-byte aligned.
// K * F >= 1.  The plan (ops/gather.py take_plan): slab_cols a power-of-two
// multiple of C = 4 and at most 4 THREADS, chunks = ceil(K / rows an
// item), items = ceil(F / slab_cols) x chunks, passes 1 (a block an item,
// grid = items) or ceil(F / slab_cols) (a cooperative launch of grid <= the
// resident blocks).  Returns the launch's error.
extern "C" int take_along_rows(const void* tab, const void* idx, void* out, int K, int M,
                               int F, int elem_bytes, int slab_cols, int chunks, int items,
                               int passes, int grid, void* stream) {
  const int tps = slab_cols / C;
  int n_slabs = chunks > 0 ? items / chunks : 0;
  if (slab_cols < C || slab_cols % C || (tps & (tps - 1)) || tps > THREADS || chunks < 1 ||
      items != n_slabs * chunks || grid < 1 || (passes != 1 && passes != n_slabs) ||
      (passes == 1 && (grid != items || n_slabs > 65535)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool i8 = elem_bytes == 1;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (passes == 1) {
    const void* fn = i8 ? reinterpret_cast<const void*>(take_along_rows_kernel<int8_t>)
                        : reinterpret_cast<const void*>(take_along_rows_kernel<float>);
    void* args[] = {&tab, &idx, &out, &K, &M, &F, &slab_cols};
    err = cudaLaunchKernel(fn, dim3(chunks, n_slabs), dim3(THREADS), args, 0, st);
  } else {
    const void* fn = i8 ? reinterpret_cast<const void*>(take_along_rows_passes_kernel<int8_t>)
                        : reinterpret_cast<const void*>(take_along_rows_passes_kernel<float>);
    void* args[] = {&tab, &idx, &out, &K, &M, &F, &slab_cols, &chunks, &n_slabs};
    err = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(THREADS), args, 0, st);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}
