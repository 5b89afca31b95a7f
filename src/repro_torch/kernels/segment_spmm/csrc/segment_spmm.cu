// Segment scatter-sum (GNN message aggregation) for Hopper, sm_90a.
//
// Replaces the TPU kernel `scatter_sum_sorted_pallas` of the JAX package
// (src/repro/kernels/segment_spmm/segment_spmm.py:57, body `_kernel` at
// :30), entered through the wrapper `ops.scatter_sum` (ops.py:16), which
// masks, argsorts the rows by destination and launches it over the sorted
// rows.  That kernel walks a grid of 128-node by 256-edge blocks in order
// and turns the scatter into MXU products: each live cell builds the
// one-hot matrix `dst[e] == node` and accumulates `onehot @ values` into
// an output block kept in VMEM across the edge axis.
//
// Hopper has no use for the one-hot product (it multiplies mostly zeros,
// and spreads a non-finite row of a block into other segments through
// 0 * inf).  Here the same sorted order makes each segment a contiguous
// range of sorted rows, and the reduction is direct:
//
// * segment_bounds_kernel: one thread per sorted row boundary writes
//   offsets[s] = the first sorted row whose id >= s, for s in
//   [0, n_segments]; segment s is rows [offsets[s], offsets[s + 1]);
// * segment_sum_kernel: one warp per output segment, lanes across
//   columns (CPL columns per lane, up to 128 columns per pass, more passes
//   for wider rows).  The warp walks its rows in ascending sorted order,
//   reads row order[r] of the unsorted values (the wrapper materialises
//   no sorted copy), accumulates in fp32 registers and writes its output
//   row exactly once: no atomics, deterministic, zeros for an empty
//   segment.  Rows with the sentinel id n_segments (masked, or out of
//   range) sort last and belong to no segment, so they are never read.
//
// Every row and element offset is 64-bit: at ogb_products E * D =
// 61,859,328 * 64 exceeds 2^31.  Widths need not be multiples of 4
// (gatedgcn has D = 70): loads are per element, each warp's 32 lanes
// reading 32 neighbouring elements of one row.
//
// What bounds it on this card: bytes.  The work must read every kept row
// once (E * D * sizeof(T)), the sorted ids and the permutation, and write
// the output; it does a handful of operations per element.  Left on the
// table by this simple design: a segment with many rows (the JAX test
// sends 80% of the rows to one segment) runs on one warp while the rest
// of the card idles; wide vector loads; and reading the rows in their
// sorted order would make them contiguous, at the cost of a sorted copy.
//
// C interface (bound with ctypes):
//   int segment_spmm(values, sorted_ids, order, offsets, out, n_rows, d,
//                    n_segments, dtype, stream)
// over values [n_rows, d] (dtype 0: float32, 1: bfloat16), sorted_ids
// int32 [n_rows] ascending (ids outside [0, n_segments) are dropped),
// order int64 [n_rows] a permutation of the rows, scratch
// offsets int64 [n_segments + 1] and out [n_segments, d] of the values'
// type; returns cudaGetLastError() after the launches (0 on success), or
// -1 for an unknown dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../../common/csrc/float_convert.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kMaxColumnsPerLane = 4;

__global__ void __launch_bounds__(kThreads)
segment_bounds_kernel(const int* __restrict__ sorted_ids, long long n_rows,
                      int n_segments, long long* __restrict__ offsets) {
  const long long e =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e > n_rows) return;
  // segments (prev, cur] start at row e: the ids before e are <= prev.
  // Ids are clamped to [-1, n_segments], so whatever the caller passes
  // nothing is written outside offsets, and sorted rows with an id below
  // 0 or above n_segments fall in no segment.
  const int prev =
      e == 0 ? -1 : max(-1, min(sorted_ids[e - 1], n_segments));
  const int cur = e == n_rows ? n_segments
                              : max(-1, min(sorted_ids[e], n_segments));
  for (int s = prev + 1; s <= cur; ++s) offsets[s] = e;
}

template <typename T, int CPL>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ values,
                   const long long* __restrict__ order,
                   const long long* __restrict__ offsets,
                   T* __restrict__ out, int n_segments, int d) {
  const long long seg =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (seg >= n_segments) return;
  const long long begin = offsets[seg];
  const long long end = offsets[seg + 1];
  T* out_row = out + seg * d;
  for (int c0 = 0; c0 < d; c0 += 32 * CPL) {
    float acc[CPL];
#pragma unroll
    for (int j = 0; j < CPL; ++j) acc[j] = 0.f;
#pragma unroll 4
    for (long long r = begin; r < end; ++r) {
      const T* row = values + order[r] * d;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = c0 + lane + 32 * j;
        if (c < d) acc[j] += to_float(row[c]);
      }
    }
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = c0 + lane + 32 * j;
      if (c < d) out_row[c] = from_float<T>(acc[j]);
    }
  }
}

template <typename T, int CPL>
void launch_sum(const void* values, const long long* order,
                const long long* offsets, void* out, int n_segments, int d,
                cudaStream_t stream) {
  const long long grid =
      (static_cast<long long>(n_segments) + kWarpsPerBlock - 1) /
      kWarpsPerBlock;
  segment_sum_kernel<T, CPL>
      <<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
          static_cast<const T*>(values), order, offsets,
          static_cast<T*>(out), n_segments, d);
}

template <typename T>
void launch_sum_by_width(const void* values, const long long* order,
                         const long long* offsets, void* out,
                         int n_segments, int d, cudaStream_t stream) {
  // columns per lane: enough for one pass up to 128 columns
  const int cpl = min(kMaxColumnsPerLane, max(1, (d + 31) / 32));
  switch (cpl) {
    case 1:
      launch_sum<T, 1>(values, order, offsets, out, n_segments, d, stream);
      break;
    case 2:
      launch_sum<T, 2>(values, order, offsets, out, n_segments, d, stream);
      break;
    case 3:
      launch_sum<T, 3>(values, order, offsets, out, n_segments, d, stream);
      break;
    default:
      launch_sum<T, 4>(values, order, offsets, out, n_segments, d, stream);
  }
}

}  // namespace

extern "C" int segment_spmm(const void* values, const int* sorted_ids,
                            const long long* order, long long* offsets,
                            void* out, long long n_rows, int d,
                            int n_segments, int dtype, void* stream) {
  if (dtype != 0 && dtype != 1) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long bounds_grid = (n_rows + 1 + kThreads - 1) / kThreads;
  segment_bounds_kernel<<<static_cast<unsigned>(bounds_grid), kThreads, 0,
                          s>>>(sorted_ids, n_rows, n_segments, offsets);
  if (n_segments > 0 && d > 0) {
    if (dtype == 0)
      launch_sum_by_width<float>(values, order, offsets, out, n_segments, d,
                                 s);
    else
      launch_sum_by_width<__nv_bfloat16>(values, order, offsets, out,
                                         n_segments, d, s);
  }
  return static_cast<int>(cudaGetLastError());
}
