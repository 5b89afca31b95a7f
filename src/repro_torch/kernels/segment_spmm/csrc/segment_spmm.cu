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
// range of sorted positions, and the reduction is direct.  The sort is
// done once per graph (the wrapper's segment plan, ops.plan): every
// aggregation over the same destinations reuses its sorted ids, its
// permutation and the offsets the bounds pass writes.
//
// * segment_bounds_kernel (once per plan): one thread per sorted position
//   boundary writes offsets[s] = the first sorted position whose id >= s,
//   for s in [0, n_segments]; segment s is positions
//   [offsets[s], offsets[s + 1]).
// * segment_sum_kernel (every aggregation): position r of a segment adds
//   row rows[r] of values [R, d].  With rows = the plan's permutation this
//   sums per-edge values (R = E); with rows = src composed with the
//   permutation it sums h[src] straight from the node rows of h (R = N),
//   so the caller never materialises the [E, d] message tensor.  A
//   segment of at most `chunk` positions is summed in order by one group
//   of LPR lanes (below; 32 / LPR segments per warp), which writes its
//   output row once.  A longer ("hot") segment is cut at the fixed chunk
//   boundaries of the position axis: one warp per chunk sums the pieces of
//   the (at most two) long segments it meets into an fp32 scratch row
//   (slot 0: the segment holding the chunk's first position, slot 1: the
//   one holding its last, if different), and
// * segment_combine_kernel adds a long segment's pieces, read in chunk
//   order, in the warp of the chunk where the segment ends, and writes its
//   output row.
//
// Rows are read with 16-byte loads where the width and the alignment
// allow it (float32 with d % 4 == 0, bfloat16 with d % 8 == 0): a group of
// LPR lanes covers one row (LPR = the row's 16-byte vectors rounded up to
// a power of two, at most 32; 16 lanes for d = 64 float32).  At ~1 row
// per segment (a sampled minibatch) a warp thus serves 32 / LPR segments
// at once instead of idling all but LPR lanes.  A chunk or a combine is
// summed by the whole warp: its 32 / LPR groups take interleaved rows and
// their fp32 sums are added by a fixed xor-shuffle tree.  Other widths
// (gatedgcn's d = 70) load per element, 32 lanes, up to 128 columns per
// pass.  Sums are in fp32 and in a fixed order: no atomics, the
// output is bitwise the same from run to run, zeros for an empty segment.
// Rows with the sentinel id n_segments (masked, or out of range) sort last
// and belong to no segment, so they are never read.  Every row and element
// offset is 64-bit: at ogb_products E * d = 61,859,328 * 64 exceeds 2^31.
//
// What bounds it on this card: bytes.  With rows = the permutation it must
// read every kept row of values once, the sorted ids and the row index,
// and write the output.  With the gather fused (rows into h) the least it
// must read is h once, but it reads a node row once per in-edge, at random:
// at ogb_products h is 627 MB against a 50 MB L2, so the rate of those
// gathered 256-byte rows sets its time.  A hot segment no longer runs on
// one warp while the card idles: its chunks run on as many warps as it has
// chunks, and only the combine of its partial sums is serial (one warp
// reads ceil(rows / chunk) partial rows: the chunk size trades that serial
// tail against the longest segment one group sums alone).
//
// C interface (bound with ctypes):
//   int segment_bounds(sorted_ids, n_pos, n_segments, offsets, stream)
//   int segment_spmm(values, rows, sorted_ids, offsets, partial, out,
//                    n_pos, d, n_segments, chunk, dtype, vec, stream)
// over sorted_ids int32 [n_pos] ascending (ids outside [0, n_segments) are
// dropped), rows int32 [n_pos] (row of values for each sorted position),
// values [R, d] (dtype 0: float32, 1: bfloat16; vec 1: 16-byte aligned
// rows with d a multiple of 16 / sizeof(value)), offsets int64
// [n_segments + 1] from segment_bounds, scratch partial float32
// [2 * ceil(n_pos / chunk), d] and out [n_segments, d] of the values'
// type; each returns cudaGetLastError() after its launches (0 on success),
// or -1 for an unknown dtype or a vec the width does not allow.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../../common/csrc/float_convert.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr unsigned kFullMask = 0xffffffffu;
// per-element loads: up to this many columns per lane in one pass
constexpr int kMaxColumnsPerLane = 4;

__global__ void __launch_bounds__(kThreads)
segment_bounds_kernel(const int* __restrict__ sorted_ids, long long n_pos,
                      int n_segments, long long* __restrict__ offsets) {
  const long long e =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e > n_pos) return;
  // segments (prev, cur] start at position e: the ids before e are <=
  // prev.  Ids are clamped to [-1, n_segments], so whatever the caller
  // passes nothing is written outside offsets, and sorted positions with
  // an id below 0 or above n_segments fall in no segment.
  const int prev =
      e == 0 ? -1 : max(-1, min(sorted_ids[e - 1], n_segments));
  const int cur = e == n_pos ? n_segments
                             : max(-1, min(sorted_ids[e], n_segments));
  for (int s = prev + 1; s <= cur; ++s) offsets[s] = e;
}

// VEC consecutive elements at p (aligned to VEC * sizeof(T) when VEC > 1)
// into fp32.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float* x) {
  if constexpr (VEC == 1) {
    x[0] = to_float(p[0]);
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const float4 f = reinterpret_cast<const float4*>(p)[i];
      x[4 * i] = f.x;
      x[4 * i + 1] = f.y;
      x[4 * i + 2] = f.z;
      x[4 * i + 3] = f.w;
    }
  } else {
    // bfloat16: the high half of a float's bits
#pragma unroll
    for (int i = 0; i < VEC / 8; ++i) {
      const uint4 r = reinterpret_cast<const uint4*>(p)[i];
      const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        x[8 * i + 2 * k] = __uint_as_float(w[k] << 16);
        x[8 * i + 2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
      }
    }
  }
}

// VEC fp32 values into VEC consecutive elements of type T at p.
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float* x) {
  if constexpr (VEC == 1) {
    p[0] = from_float<T>(x[0]);
  } else if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i)
      reinterpret_cast<float4*>(p)[i] =
          make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
  } else {
    static_assert(VEC % 4 == 0, "bfloat16 stores go 4 elements at a time");
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      unsigned w[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const __nv_bfloat16 lo = from_float<__nv_bfloat16>(x[4 * i + 2 * k]);
        const __nv_bfloat16 hi =
            from_float<__nv_bfloat16>(x[4 * i + 2 * k + 1]);
        w[k] = static_cast<unsigned>(__bfloat16_as_ushort(lo))
               | (static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16);
      }
      reinterpret_cast<uint2*>(p)[i] = make_uint2(w[0], w[1]);
    }
  }
}

// acc[j] += row row_of(r) of values [., d] at vector column
// c0 + j * LPR + col, for r = first, first + stride, ... below end: the
// rows one group of LPR lanes reads (each lane VEC elements wide, NV
// vectors per pass), in order, in fp32.
template <typename T, int VEC, int LPR, int NV, typename RowOf>
__device__ __forceinline__ void add_rows(float (&acc)[NV][VEC],
                                         const T* __restrict__ values, int d,
                                         int c0, long long first,
                                         long long end, int stride,
                                         RowOf row_of) {
  const int col = (threadIdx.x & 31) % LPR;
  const int dv = d / VEC;
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[j][k] = 0.f;
#pragma unroll 4
  for (long long r = first; r < end; r += stride) {
    const T* row = values + row_of(r) * d;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int cv = c0 + j * LPR + col;
      if (cv < dv) {
        float x[VEC];
        load_vec<T, VEC>(row + static_cast<long long>(cv) * VEC, x);
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[j][k] += x[k];
      }
    }
  }
}

// One group of LPR lanes sums rows row_of(r), r in [begin, end), in order
// and hands each output vector to emit(vector column, VEC floats).
template <typename T, int VEC, int LPR, int NV, typename RowOf,
          typename Emit>
__device__ __forceinline__ void group_sum_rows(const T* __restrict__ values,
                                               int d, long long begin,
                                               long long end, RowOf row_of,
                                               Emit emit) {
  const int col = (threadIdx.x & 31) % LPR;
  const int dv = d / VEC;
  for (int c0 = 0; c0 < dv; c0 += LPR * NV) {
    float acc[NV][VEC];
    add_rows<T, VEC, LPR, NV>(acc, values, d, c0, begin, end, 1, row_of);
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int cv = c0 + j * LPR + col;
      if (cv < dv) emit(cv, acc[j]);
    }
  }
}

// The whole warp sums rows row_of(r), r in [begin, end): its 32 / LPR
// groups take every (32 / LPR)-th row, and their sums are added by an
// xor-shuffle tree, a fixed order; group 0 emits.  Every lane of the warp
// must call it with the same arguments.
template <typename T, int VEC, int LPR, int NV, typename RowOf,
          typename Emit>
__device__ __forceinline__ void warp_sum_rows(const T* __restrict__ values,
                                              int d, long long begin,
                                              long long end, RowOf row_of,
                                              Emit emit) {
  constexpr int kGroups = 32 / LPR;
  const int group = (threadIdx.x & 31) / LPR;
  const int col = (threadIdx.x & 31) % LPR;
  const int dv = d / VEC;
  for (int c0 = 0; c0 < dv; c0 += LPR * NV) {
    float acc[NV][VEC];
    add_rows<T, VEC, LPR, NV>(acc, values, d, c0, begin + group, end,
                              kGroups, row_of);
#pragma unroll
    for (int off = 16; off >= LPR; off >>= 1)
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          acc[j][k] += __shfl_xor_sync(kFullMask, acc[j][k], off);
    if (group == 0) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int cv = c0 + j * LPR + col;
        if (cv < dv) emit(cv, acc[j]);
      }
    }
  }
}

// Warps [0, seg_warps): 32 / LPR segments per warp, one per group of LPR
// lanes, each summed in order by its group (a long one is left to the
// chunk warps).  Warps [seg_warps, seg_warps + n_chunks): one chunk of
// positions each, whose pieces of long segments the whole warp sums into
// fp32 partial rows.
template <typename T, int VEC, int LPR, int NV>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ values, const int* __restrict__ rows,
                   const int* __restrict__ sorted_ids,
                   const long long* __restrict__ offsets,
                   float* __restrict__ partial, T* __restrict__ out,
                   long long n_pos, int d, int n_segments, long long chunk,
                   long long n_chunks, long long seg_warps) {
  const long long w =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  auto row_of = [&](long long r) {
    return static_cast<long long>(rows[r]);
  };
  if (w < seg_warps) {
    const long long seg = w * (32 / LPR) + (threadIdx.x & 31) / LPR;
    if (seg >= n_segments) return;
    const long long begin = offsets[seg];
    const long long end = offsets[seg + 1];
    if (end - begin > chunk) return;
    T* out_row = out + seg * d;
    group_sum_rows<T, VEC, LPR, NV>(
        values, d, begin, end, row_of, [&](int cv, const float* a) {
          store_vec<T, VEC>(out_row + static_cast<long long>(cv) * VEC, a);
        });
    return;
  }
  const long long p = w - seg_warps;
  if (p >= n_chunks) return;
  const long long lo = p * chunk;
  const long long hi = min(n_pos, lo + chunk);
  const int first = sorted_ids[lo];
  for (int slot = 0; slot < 2; ++slot) {
    const int s = slot == 0 ? first : sorted_ids[hi - 1];
    if (s < 0 || s >= n_segments || (slot == 1 && s == first)) continue;
    const long long begin = offsets[s];
    const long long end = offsets[s + 1];
    if (end - begin <= chunk) continue;
    float* dst = partial + (2 * p + slot) * d;
    warp_sum_rows<T, VEC, LPR, NV>(
        values, d, max(begin, lo), min(end, hi), row_of,
        [&](int cv, const float* a) {
          store_vec<float, VEC>(dst + static_cast<long long>(cv) * VEC, a);
        });
  }
}

template <typename T, int VEC, int LPR, int NV>
__global__ void __launch_bounds__(kThreads)
segment_combine_kernel(const float* __restrict__ partial,
                       const int* __restrict__ sorted_ids,
                       const long long* __restrict__ offsets,
                       T* __restrict__ out, long long n_pos, int d,
                       int n_segments, long long chunk, long long n_chunks) {
  const long long p =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (p >= n_chunks) return;
  const long long lo = p * chunk;
  const long long hi = min(n_pos, lo + chunk);
  const int s = sorted_ids[lo];
  if (s < 0 || s >= n_segments) return;
  const long long begin = offsets[s];
  const long long end = offsets[s + 1];
  // only a long segment, in the chunk where it ends
  if (end - begin <= chunk || end > hi) return;
  // chunk q holds the segment in slot 0 when the segment covers the
  // chunk's first position, else (its first chunk) in slot 1
  auto piece = [&](long long q) { return 2 * q + (q * chunk >= begin ? 0 : 1); };
  T* out_row = out + static_cast<long long>(s) * d;
  warp_sum_rows<float, VEC, LPR, NV>(
      partial, d, begin / chunk, p + 1, piece, [&](int cv, const float* a) {
        store_vec<T, VEC>(out_row + static_cast<long long>(cv) * VEC, a);
      });
}

struct Args {
  const void* values;
  const int* rows;
  const int* sorted_ids;
  const long long* offsets;
  float* partial;
  void* out;
  long long n_pos;
  int d;
  int n_segments;
  long long chunk;
  long long n_chunks;
  cudaStream_t stream;
};

unsigned blocks_for_warps(long long warps) {
  return static_cast<unsigned>((warps + kWarpsPerBlock - 1) /
                               kWarpsPerBlock);
}

template <typename T, int VEC, int LPR, int NV>
void launch_sum(const Args& a) {
  const long long seg_warps = (a.n_segments + 32 / LPR - 1) / (32 / LPR);
  segment_sum_kernel<T, VEC, LPR, NV>
      <<<blocks_for_warps(seg_warps + a.n_chunks), kThreads, 0, a.stream>>>(
          static_cast<const T*>(a.values), a.rows, a.sorted_ids, a.offsets,
          a.partial, static_cast<T*>(a.out), a.n_pos, a.d, a.n_segments,
          a.chunk, a.n_chunks, seg_warps);
}

template <typename T, int VEC, int LPR, int NV>
void launch_combine(const Args& a) {
  segment_combine_kernel<T, VEC, LPR, NV>
      <<<blocks_for_warps(a.n_chunks), kThreads, 0, a.stream>>>(
          a.partial, a.sorted_ids, a.offsets, static_cast<T*>(a.out),
          a.n_pos, a.d, a.n_segments, a.chunk, a.n_chunks);
}

// Lanes per row and vectors per lane for a row of dv VEC-wide vectors:
// LPR = dv rounded up to a power of two up to 32 (NV = 1), else 32 lanes
// with up to kMaxColumnsPerLane vectors each per pass.
template <template <typename, int, int, int> class Launch, typename T,
          int VEC>
void by_width(const Args& a) {
  const int dv = a.d / VEC;
  if constexpr (VEC > 1) {
    if (dv <= 1) return Launch<T, VEC, 1, 1>::run(a);
    if (dv <= 2) return Launch<T, VEC, 2, 1>::run(a);
    if (dv <= 4) return Launch<T, VEC, 4, 1>::run(a);
    if (dv <= 8) return Launch<T, VEC, 8, 1>::run(a);
    if (dv <= 16) return Launch<T, VEC, 16, 1>::run(a);
  }
  switch (min(kMaxColumnsPerLane, max(1, (dv + 31) / 32))) {
    case 1:
      return Launch<T, VEC, 32, 1>::run(a);
    case 2:
      return Launch<T, VEC, 32, 2>::run(a);
    case 3:
      return Launch<T, VEC, 32, 3>::run(a);
    default:
      return Launch<T, VEC, 32, 4>::run(a);
  }
}

template <typename T, int VEC, int LPR, int NV>
struct Sum {
  static void run(const Args& a) { launch_sum<T, VEC, LPR, NV>(a); }
};

// the combine reads fp32 partial rows (4 per 16 bytes) and stores T
template <typename T, int VEC, int LPR, int NV>
struct Combine {
  static void run(const Args& a) { launch_combine<T, VEC, LPR, NV>(a); }
};

template <typename T>
int launch_all(const Args& a, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec) {
    if (a.d % kVec != 0) return -1;
    by_width<Sum, T, kVec>(a);
  } else {
    by_width<Sum, T, 1>(a);
  }
  if (a.n_chunks > 0) {
    if (a.d % 4 == 0)
      by_width<Combine, T, 4>(a);
    else
      by_width<Combine, T, 1>(a);
  }
  return 0;
}

}  // namespace

extern "C" int segment_bounds(const int* sorted_ids, long long n_pos,
                              int n_segments, long long* offsets,
                              void* stream) {
  const long long grid = (n_pos + 1 + kThreads - 1) / kThreads;
  segment_bounds_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      sorted_ids, n_pos, n_segments, offsets);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int segment_spmm(const void* values, const int* rows,
                            const int* sorted_ids, const long long* offsets,
                            float* partial, void* out, long long n_pos,
                            int d, int n_segments, long long chunk,
                            int dtype, int vec, void* stream) {
  if ((dtype != 0 && dtype != 1) || chunk < 1) return -1;
  if (n_segments <= 0 || d <= 0) return 0;
  const Args a{values, rows, sorted_ids, offsets, partial, out, n_pos, d,
               n_segments, chunk, (n_pos + chunk - 1) / chunk,
               static_cast<cudaStream_t>(stream)};
  const int err = dtype == 0 ? launch_all<float>(a, vec != 0)
                             : launch_all<__nv_bfloat16>(a, vec != 0);
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
