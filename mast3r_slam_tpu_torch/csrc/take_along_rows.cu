// Same-shape take along rows, out[i, f] = tab[idx[i, f], f], for Hopper
// (sm_90a).  Bound through ctypes by ops/gather.py.
//
// Replaces: scripts/tpu_r4_experiments.py  gatherprobe2 -> run (Mosaic's
// only supported in-kernel gather, jnp.take_along_axis on axis 0).  The
// port also runs it where the JAX package calls take_along_axis on
// retrieval's path: the top-k feature select of
// mast3r_slam_tpu/retrieval/head.py extract_topk_features, whose index is
// broadcast along the row (a row gather).
//
// What bounds it on the H100: bytes, and for independent random indices
// 32-byte sectors.  It reads idx (4 B an element) and tab at the indexed
// places and writes out: at the probe's (196,608, 128) f32 that is 302 MB,
// 90 us at 3.35 TB/s; but each random element read costs a whole sector
// (8x the bytes for f32, 32x for int8).  Where the index is broadcast along
// the row, neighbouring lanes read neighbouring elements of one row and the
// reads coalesce.
//
// Design: a thread takes 4 consecutive elements of the flat (K*F) output:
// one 16-byte load of its 4 indices, 4 independent element reads, one store
// of 4 values (16 bytes for f32, 4 for int8); the last thread handles a
// ragged tail element by element.  Exact: nothing is computed.  An index
// outside [0, M) reads nothing and writes NaN (f32) or 0 (int8).

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

template <typename T>
__device__ __forceinline__ T take(const T* __restrict__ tab, int i, int64_t e, int M, int F) {
  return (i >= 0 && i < M) ? tab[(int64_t)i * F + e % F] : poison<T>();
}

template <typename T, typename V4>
__global__ void __launch_bounds__(THREADS)
take_along_rows_kernel(const T* __restrict__ tab, const int32_t* __restrict__ idx,
                       T* __restrict__ out, int64_t n, int M, int F) {
  const int64_t e0 = ((int64_t)blockIdx.x * THREADS + threadIdx.x) * 4;
  if (e0 >= n) return;
  if (e0 + 4 <= n) {
    const int4 ix = __ldg(reinterpret_cast<const int4*>(idx + e0));
    V4 v;
    v.x = take(tab, ix.x, e0, M, F);
    v.y = take(tab, ix.y, e0 + 1, M, F);
    v.z = take(tab, ix.z, e0 + 2, M, F);
    v.w = take(tab, ix.w, e0 + 3, M, F);
    *reinterpret_cast<V4*>(out + e0) = v;
  } else {
    for (int64_t e = e0; e < n; ++e) out[e] = take(tab, idx[e], e, M, F);
  }
}

}  // namespace

// tab: (M, F) int8 (elem_bytes = 1) or f32 (elem_bytes = 4); idx, out:
// (K, F), idx int32 16-byte aligned, out of tab's type 16-byte aligned.
// K * F >= 1.  Returns cudaGetLastError().
extern "C" int take_along_rows(const void* tab, const void* idx, void* out, int K, int M,
                               int F, int elem_bytes, void* stream) {
  const int64_t n = (int64_t)K * F;
  const unsigned blocks = (unsigned)((n + 4 * THREADS - 1) / (4 * THREADS));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int32_t* ix = reinterpret_cast<const int32_t*>(idx);
  if (elem_bytes == 1)
    take_along_rows_kernel<int8_t, char4><<<blocks, THREADS, 0, st>>>(
        reinterpret_cast<const int8_t*>(tab), ix, reinterpret_cast<int8_t*>(out), n, M, F);
  else
    take_along_rows_kernel<float, float4><<<blocks, THREADS, 0, st>>>(
        reinterpret_cast<const float*>(tab), ix, reinterpret_cast<float*>(out), n, M, F);
  return static_cast<int>(cudaGetLastError());
}
