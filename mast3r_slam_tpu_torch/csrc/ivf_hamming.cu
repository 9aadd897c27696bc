// IVF bucket scoring for Hopper (sm_90a): the Hamming distance of each
// query code to every code of its word's bucket.  Bound through ctypes by
// ops/gather.py.
//
// Replaces: the gather-and-popcount of mast3r_slam_tpu/retrieval/asmk.py
// _ivf_search_bucketed (the bucketed IVF scoring), as the port's
// retrieval/asmk.py ivf_search_bucketed calls it:
//   dist[q, b] = sum_w popcount(q_vecs[q, w] ^ bvecs[qw[q], b, w]), int32,
// exact; a word outside [0, n_buckets) gives -1 and reads nothing.
//
// What bounds it on the H100: bytes, at a size where a kernel's fixed
// cost weighs as much.  At the full-width query (Q = 1500 codes, buckets
// of 16 codes of W = 32 words) the slabs this run touches, the query codes
// and the distances are about 3.3 MB, 1.0 us at 3.35 TB/s; the popcounts
// are one integer operation a byte.  chip_smoke.py phase 2 prints the
// device time of a one-element fill beside it: the floor of any kernel.
//
// Design: a query's bucket bvecs[qw[q]] is one contiguous slab of cap rows
// of W words (2 KB at cap 16, W 32).  A row is cut into chunks of V words
// (4, 2 or 1, the largest that divides W: one 16-, 8- or 4-byte load), and
// L lanes share a row (the least power of two >= chunks a row, at most
// 32).  Lane l takes chunk l % L of every row it visits, so it loads the
// query's words of that chunk once, into registers, with the same
// lane-to-column map as its slab loads.  A warp's 32 / L row slots take
// min(cap, 32 / L) rows of one query at a time, and where a bucket has
// fewer rows than that a warp takes several queries (W = 1 or 2 at cap
// 16: two).  A lane first reads its query's word and its query words,
// together; then it issues up to four slab loads (rows a pass apart)
// before it counts any; the row's lanes sum by a fixed xor-shuffle tree.
// The slab's offset is one 64-bit product a query: no division or modulo
// a word.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PASSES = 4;  // slab loads a lane keeps in flight

template <int V>
__device__ __forceinline__ void load_chunk(const uint32_t* p, uint32_t (&w)[V]) {
  if constexpr (V == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (V == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ int popxor(const uint32_t (&a)[V], const uint32_t (&b)[V]) {
  int s = 0;
#pragma unroll
  for (int v = 0; v < V; ++v) s += __popc(a[v] ^ b[v]);
  return s;
}

// lanes: L; spq: row slots of a query (min(cap, 32 / L)); qpw: queries a
// warp ((32 / L) / spq)
template <int V>
__global__ void __launch_bounds__(THREADS)
ivf_hamming_kernel(const uint32_t* __restrict__ bvecs, const uint32_t* __restrict__ q_vecs,
                   const int32_t* __restrict__ qw, int32_t* __restrict__ dist, int Q,
                   int n_buckets, int cap, int W, int lanes, int spq, int qpw) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int cl = lane & (lanes - 1);  // the lane's chunk of a row
  const int slot = lane / lanes;      // its row slot
  const int qo = slot / spq;
  const int rs = slot - qo * spq;     // its row within a pass
  const int64_t q = warp * qpw + qo;
  const int chunks = W / V;
  const bool live = qo < qpw && q < Q;

  // the query's word and its words of chunk cl, read together
  int word = -1;
  uint32_t qv[V];
#pragma unroll
  for (int v = 0; v < V; ++v) qv[v] = 0u;
  if (live) {
    word = __ldg(qw + q);
    if (cl < chunks) {
#pragma unroll
      for (int v = 0; v < V; ++v) qv[v] = __ldg(q_vecs + q * W + cl * V + v);
    }
  }
  const bool ok = live && word >= 0 && word < n_buckets;
  const uint32_t* slab = bvecs + (ok ? (int64_t)word * cap * W : 0);
  const uint32_t* qrow = q_vecs + (live ? q * W : 0);

  // every lane of the warp runs the same passes and shuffles (cap is uniform)
  for (int r0 = 0; r0 < cap; r0 += PASSES * spq) {
    uint32_t w[PASSES][V];
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int row = r0 + p * spq + rs;
#pragma unroll
      for (int v = 0; v < V; ++v) w[p][v] = 0u;
      if (ok && row < cap && cl < chunks) load_chunk<V>(slab + (int64_t)row * W + cl * V, w[p]);
    }
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      if (r0 + p * spq >= cap) break;
      const int row = r0 + p * spq + rs;
      int acc = popxor<V>(w[p], qv);
      // rows of more than 32 chunks (W > 128): the lane's further chunks,
      // their query words read again
      if (ok && row < cap) {
        for (int c = cl + lanes; c < chunks; c += lanes) {
          uint32_t a[V], b[V];
          load_chunk<V>(slab + (int64_t)row * W + c * V, a);
#pragma unroll
          for (int v = 0; v < V; ++v) b[v] = __ldg(qrow + c * V + v);
          acc += popxor<V>(a, b);
        }
      }
      for (int s = lanes / 2; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
      if (live && cl == 0 && row < cap) dist[q * cap + row] = ok ? acc : -1;
    }
  }
}

template <int V>
int launch(const void* bvecs, const void* q_vecs, const void* qw, void* dist, int Q,
           int n_buckets, int cap, int W, cudaStream_t st) {
  const int chunks = W / V;
  int lanes = 1;
  while (lanes < chunks && lanes < 32) lanes *= 2;
  const int spq = cap < 32 / lanes ? cap : 32 / lanes;
  const int qpw = (32 / lanes) / spq;
  const int64_t warps = ((int64_t)Q + qpw - 1) / qpw;
  const unsigned blocks = (unsigned)((warps * 32 + THREADS - 1) / THREADS);
  ivf_hamming_kernel<V><<<blocks, THREADS, 0, st>>>(
      reinterpret_cast<const uint32_t*>(bvecs), reinterpret_cast<const uint32_t*>(q_vecs),
      reinterpret_cast<const int32_t*>(qw), reinterpret_cast<int32_t*>(dist), Q, n_buckets,
      cap, W, lanes, spq, qpw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bvecs: (n_buckets, bucket_cap, W) int32, 16-byte aligned; q_vecs: (Q, W)
// int32; qw: (Q,) int32; dist: (Q, bucket_cap) int32, all contiguous.
// Q, bucket_cap, W >= 1.  One launch on `stream`; returns cudaGetLastError().
extern "C" int ivf_hamming(const void* bvecs, const void* q_vecs, const void* qw,
                           void* dist, int Q, int n_buckets, int bucket_cap, int W,
                           void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (W % 4 == 0) return launch<4>(bvecs, q_vecs, qw, dist, Q, n_buckets, bucket_cap, W, st);
  if (W % 2 == 0) return launch<2>(bvecs, q_vecs, qw, dist, Q, n_buckets, bucket_cap, W, st);
  return launch<1>(bvecs, q_vecs, qw, dist, Q, n_buckets, bucket_cap, W, st);
}
