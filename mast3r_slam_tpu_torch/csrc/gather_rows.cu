// Row gather followed by a reduction over the row, for Hopper (sm_90a).
// Bound through ctypes by ops/gather.py.
//
//   gather_rows_sum  out[t] = sum_f float(table[idx[t], f]), int8 or f32.
//     Replaces: scripts/tpu_r4_experiments.py  gatherprobe -> run (the
//     Mosaic in-VMEM gather probe, kernel body `kern`).
//
// What bounds it on the H100: bytes, and in practice 32-byte sectors.  Each
// output row reads one table row at a random place (16 to 128 bytes) plus
// its index; at the probe's 196,608 rows of 32 int8 that is 7.9 MB, 2.3 us
// at 3.35 TB/s, but a 16-byte row still costs a whole 32-byte sector.  The
// reductions are a few integer or f32 adds a word: far under any peak.
//
// Design: a group of L lanes (a power of two, L <= 32) takes one output
// row.  Lane l loads the row's 16-byte chunks l, l + L, ... with one vector
// load each (8 or 4 bytes where the row is not a multiple of 16), reduces
// them in order, and the group combines its lanes by an xor-shuffle tree:
// a fixed order, so every call gives the same bits.  L is chosen so that a
// row takes one load a lane where it can (16-byte int8 rows: L = 1; 32-byte
// int8 rows: L = 2; 128-byte rows: L = 8).  Many independent rows a warp
// keep enough loads in flight to cover the latency of the random reads.
// An index outside the table reads nothing: the sum is NaN.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <int NW>
__device__ __forceinline__ void load_words(const uint32_t* p, uint32_t (&w)[NW]) {
  if constexpr (NW == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (NW == 2) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = __ldg(p);
  }
}

// out[t] = sum of the row's int8 values, in element order within a chunk
struct SumInt8 {
  const int32_t* idx;
  float* out;
  int M;
  __device__ int64_t row(int64_t o) const {
    const int r = idx[o];
    return (r >= 0 && r < M) ? r : -1;
  }
  __device__ void add(float& a, uint32_t w) const {
#pragma unroll
    for (int k = 0; k < 4; ++k) a += (float)(int8_t)(w >> (8 * k));
  }
  __device__ void store(int64_t o, float a, bool ok) const {
    out[o] = ok ? a : __int_as_float(0x7fc00000);
  }
};

struct SumF32 {
  const int32_t* idx;
  float* out;
  int M;
  __device__ int64_t row(int64_t o) const {
    const int r = idx[o];
    return (r >= 0 && r < M) ? r : -1;
  }
  __device__ void add(float& a, uint32_t w) const {
    a += __uint_as_float(w);
  }
  __device__ void store(int64_t o, float a, bool ok) const {
    out[o] = ok ? a : __int_as_float(0x7fc00000);
  }
};

template <int NW, class Op>
__global__ void __launch_bounds__(THREADS)
gather_rows_kernel(const uint32_t* __restrict__ table, int64_t n_out, int row_words,
                   int lanes, Op op) {
  const int lane = threadIdx.x & (lanes - 1);
  const int64_t o = ((int64_t)blockIdx.x * THREADS + threadIdx.x) / lanes;
  const bool live = o < n_out;
  const int64_t r = live ? op.row(o) : -1;
  float acc = 0.0f;
  if (r >= 0) {
    const uint32_t* src = table + r * row_words;
    for (int c = lane * NW; c < row_words; c += lanes * NW) {
      uint32_t w[NW];
      load_words<NW>(src + c, w);
#pragma unroll
      for (int k = 0; k < NW; ++k) op.add(acc, w[k]);
    }
  }
  // every lane of the warp reaches the shuffles (no early return)
  for (int s = lanes / 2; s > 0; s >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, s);
  if (live && lane == 0) op.store(o, acc, r >= 0);
}

// words a load (4, 2 or 1: the largest that divides the row) and lanes a
// row (the least power of two >= loads a row, at most 32)
void shape(int row_words, int* nw, int* lanes) {
  *nw = row_words % 4 == 0 ? 4 : (row_words % 2 == 0 ? 2 : 1);
  const int loads = row_words / *nw;
  int l = 1;
  while (l < loads && l < 32) l *= 2;
  *lanes = l;
}

template <class Op>
int launch(const void* table, int64_t n_out, int row_words, Op op, void* stream) {
  int nw, lanes;
  shape(row_words, &nw, &lanes);
  const int64_t rows_per_block = THREADS / lanes;
  const unsigned blocks = (unsigned)((n_out + rows_per_block - 1) / rows_per_block);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const uint32_t* t = reinterpret_cast<const uint32_t*>(table);
  if (nw == 4)
    gather_rows_kernel<4, Op><<<blocks, THREADS, 0, st>>>(t, n_out, row_words, lanes, op);
  else if (nw == 2)
    gather_rows_kernel<2, Op><<<blocks, THREADS, 0, st>>>(t, n_out, row_words, lanes, op);
  else
    gather_rows_kernel<1, Op><<<blocks, THREADS, 0, st>>>(t, n_out, row_words, lanes, op);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// table: (M, F) int8 (is_int8 = 1, F % 4 == 0) or f32, 16-byte aligned;
// idx: (T,) int32; out: (T,) f32.  T >= 1.  Returns cudaGetLastError().
extern "C" int gather_rows_sum(const void* table, const void* idx, void* out, int T,
                               int M, int F, int is_int8, void* stream) {
  const int32_t* ix = reinterpret_cast<const int32_t*>(idx);
  float* o = reinterpret_cast<float*>(out);
  if (is_int8) return launch(table, T, F / 4, SumInt8{ix, o, M}, stream);
  return launch(table, T, F, SumF32{ix, o, M}, stream);
}
