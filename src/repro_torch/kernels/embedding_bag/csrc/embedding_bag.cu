// Embedding bags of every sparse field of a batch (weighted sums of
// gathered table rows), written with the dense columns straight into x0,
// for Hopper, sm_90a.
//
// Replaces the TPU kernel `embedding_bag_pallas` of the JAX package
// (src/repro/kernels/embedding_bag/embedding_bag.py:38, body `_kernel` at
// :22), entered through `ops.embedding_bag` (ops.py:13), and the concat
// that DCN-v2 puts after its F calls (`interact_features`,
// src/repro/models/recsys.py:97).  That kernel pads the batch to 64-bag
// blocks and, per block, walks bag x k in a serial loop, loading one table
// row at a time from HBM into a VMEM accumulator.
//
// One launch computes x0 = [dense || bag_0 || ... || bag_{F-1}], a
// [B, n_dense + F * D] output, where bag_f[b] = sum_k w[b, f, k] *
// table_f[ids[b, f, k]].  The single-field form (ops.embedding_bag) is the
// same kernel with F = 1 and no dense columns.
//
// * The F table pointers and vocabulary sizes go in by value, in the
//   kernel's parameter struct (16 bytes a field, kMaxFields = 64), so
//   nothing is allocated or copied per call.  ids and weights are read in
//   place through their bag and field strides (k contiguous).
// * A block owns `tile` consecutive bags.  Its threads take the (bag,
//   field, VEC columns) items of those bags in turn; per item a thread
//   reads the bag's ids and weights (the same addresses for the threads of
//   one bag: broadcast loads) and sums w * row over k in ascending order
//   in fp32, one row at a time: issuing the K row loads before summing any
//   of them was slower on the card, at DCN-v2's shapes, whether or not the
//   registers were capped for more blocks per SM.  Each bag is rounded
//   once to the table's type.
// * Loads: at D = 16 a float32 row is 64 bytes and 16-byte aligned, so
//   four threads cover it with float4 loads (VEC = 4, when D % 4 == 0 and
//   every table is 16-byte aligned; else VEC = 1, and bf16 tables load
//   one element at a time).
// * Stores: x0's row (429 floats for DCN-v2) is odd, so a field's columns
//   are 16-byte aligned in one row of four and no thread can store its
//   float4 in place.  The block therefore writes its bags' x0 rows (dense
//   columns copied in the same pass) into shared memory, and after one
//   __syncthreads stores them as what they are in x0: one contiguous span
//   of tile * row elements.  With tile a multiple of 4 the span starts on
//   16 bytes, so a float32 x0 goes out in float4 stores that are
//   contiguous across the warp (a scalar tail, and scalar stores for any
//   other span).
// * tile = 16 bags (27 KB of shared memory at DCN-v2's 429-float row); up
//   to 64 while a block has fewer items than threads (one field of 16
//   columns: 64 bags), halved down to 4 while the grid has fewer than two
//   blocks per SM (B = 512: 4 bags, 128 blocks), and halved further if a
//   row is too wide for 48 KB.
// * ids follow `jnp.take`: a negative id >= -V wraps to id + V, any other
//   id outside [0, V) gives a NaN row.  The kernel never reads outside a
//   table.  Duplicate ids in a bag accumulate.
//
// What bounds it on this card: bytes, and where the rows come from.  The
// work must read B * F * K ids and weights, each distinct row once, the
// dense columns, and write x0 once; it does two operations per gathered
// element.  The six large tables (1M to 10M rows) are gathered from HBM;
// the rows of the twenty small ones (at most 100,000 rows, 6.4 MB) are
// read again and again from L2, so at DCN-v2's serve_bulk the fields of
// small tables cost about what L2's bandwidth gives, not what the
// function's bytes would (chip_smoke.py times the grouped launch on three
// field ranges).  Tried on the card and not kept: blocks of one field
// group each, ordered group by group so that a group's tables stay in L2
// (slower: x0 is then written in 64-byte pieces per row), tiles of 4, 8
// and 32 bags, ids and weights staged in shared memory, two items per
// thread in flight (none gained enough to keep its code), and K rows in
// flight (above).  No L2 access-policy window was tried.
//
// C interface (bound with ctypes):
//   int embedding_bag_fields(tables, vocabs, n_fields, dense, ids,
//                            weights, out, out_stride, n_bags, bag,
//                            ids_bag_stride, ids_field_stride,
//                            w_bag_stride, w_field_stride, n_dense,
//                            dense_stride, d, dtype, out_dtype, stream)
// tables: n_fields pointers to [vocab_f, d] tables of one dtype (0:
// float32, 1: bfloat16); vocabs: n_fields int64; dense [n_bags, n_dense]
// of out_dtype with row stride dense_stride (may be null when n_dense is
// 0); ids int32 and weights float32 with bag b, field f at b * bag_stride
// + f * field_stride (k contiguous); out [n_bags, n_dense + n_fields * d]
// of out_dtype, columns contiguous, rows out_stride elements apart (the
// row length for x0 itself: one contiguous span per block; more for one
// field's columns of a wider x0, stored row by row).  Returns
// cudaGetLastError() after the launch (0 on success), or -1 for a dtype
// pair it does not take, more than kMaxFields fields or a row wider than
// a block's shared memory.
//
// The transpose, `embedding_bag_fields_backward`, has no TPU kernel to
// replace: the JAX package differentiates its XLA embedding bag
// (`use_pallas=False`, src/repro/models/recsys.py:45).  For every field f
// it adds w[b, f, k] * grad_x0[b, n_dense + f * D + c] into row
// ids[b, f, k] of field f's gradient, column c, over every (b, k), in one
// launch for all F fields (the forward's is one launch too).
//
// * One thread per (bag, field, column), in x0's order, so a warp reads
//   grad_x0 contiguously and adds into two 64-byte row pieces (D = 16);
//   it loops over the bag's K ids (broadcast loads) and adds with an fp32
//   atomicAdd, so duplicate ids, within a bag or across bags, sum in
//   whatever order the atomics land.  A grid-stride loop covers B * F * D
//   items.
// * The gradients are fp32 buffers [V_f, D] that the wrapper zeroes; a
//   bf16 table's is cast once, after the launch.  Their pointers and
//   vocabulary sizes go in by value, as the forward's tables do.
// * An id the forward wraps (negative, >= -V) adds into the wrapped row;
//   an id the forward turns into a NaN row adds nothing (its bag is NaN
//   whatever the table holds).
//
// What bounds it: bytes, if the atomics kept up — ids and weights, the
// bag columns of grad_x0, and each touched gradient row read and written
// once.  The atomics into hot rows (the small tables: a 1,000-row field
// takes ~262 adds per element at DCN-v2's train_batch) are what it
// waits on instead; chip_smoke.py times it beside 26 index_add_ calls.
//
//   int embedding_bag_fields_backward(grads, vocabs, n_fields, ids,
//                                     weights, grad_out, grad_stride,
//                                     n_bags, bag, ids_bag_stride,
//                                     ids_field_stride, w_bag_stride,
//                                     w_field_stride, n_dense, d,
//                                     grad_dtype, stream)
// grads: n_fields pointers to float32 [vocab_f, d] buffers; grad_out
// [n_bags, >= n_dense + n_fields * d] of grad_dtype (0: float32, 1:
// bfloat16), columns contiguous, rows grad_stride elements apart; ids and
// weights as for the forward.  Returns cudaGetLastError() after the
// launch, or -1 for a dtype it does not take or more than kMaxFields
// fields.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../../common/csrc/float_convert.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFields = 64;
// bags of a block: 16 (DCN-v2: 1,664 items for 256 threads), up to 64
// for narrow rows (one field of 16 columns: 256 items), down to 4 for a
// small batch
constexpr int kMinTile = 4;
constexpr int kTile = 16;
constexpr int kMaxTile = 64;
constexpr int kSmemBytes = 48 * 1024;
struct Fields {
  const void* table[kMaxFields];
  long long vocab[kMaxFields];
};

// VEC consecutive elements of a row, as floats
template <typename T, int VEC>
struct Chunk {
  float x[VEC];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) x[j] = to_float(p[j]);
  }
};

template <>
struct Chunk<float, 4> {
  float x[4];
  __device__ __forceinline__ void load(const float* p) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
};

// Store n staged floats to dst as O: float4 stores where dst is 16-byte
// aligned (float out), else one element per thread; contiguous across
// the warp either way.
template <typename O>
__device__ __forceinline__ void store_span(O* __restrict__ dst,
                                           const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads)
    dst[i] = from_float<O>(src[i]);
}

template <>
__device__ __forceinline__ void store_span<float>(float* __restrict__ dst,
                                                  const float* src, int n) {
  int head = 0;
  if (reinterpret_cast<unsigned long long>(dst) % 16 == 0) {
    const int n4 = n / 4;
    for (int i = threadIdx.x; i < n4; i += kThreads)
      reinterpret_cast<float4*>(dst)[i] =
          reinterpret_cast<const float4*>(src)[i];
    head = 4 * n4;
  }
  for (int i = head + threadIdx.x; i < n; i += kThreads) dst[i] = src[i];
}

// ROWS_APART: out's rows are further apart than its row (one field's
// columns of a wider x0); a compile-time switch, so that x0's own launch
// compiles without the row-by-row store.
template <typename T, typename O, int VEC, bool ROWS_APART>
__global__ void __launch_bounds__(kThreads)
embedding_bag_fields_kernel(const Fields fields, const O* __restrict__ dense,
                            const int* __restrict__ ids,
                            const float* __restrict__ weights,
                            O* __restrict__ out, long long out_stride,
                            long long n_bags, int n_fields, int bag,
                            long long ids_b, long long ids_f, long long w_b,
                            long long w_f, int n_dense,
                            long long dense_stride, int d, int tile) {
  const int row = n_dense + n_fields * d;
  // this block's x0 rows, [tile, row] floats (16-byte aligned)
  extern __shared__ float4 stage4[];
  float* stage = reinterpret_cast<float*>(stage4);
  const long long b0 = static_cast<long long>(blockIdx.x) * tile;
  const int n_here = static_cast<int>(min(static_cast<long long>(tile),
                                          n_bags - b0));
  for (int i = threadIdx.x; i < n_here * n_dense; i += kThreads) {
    const int bl = i / n_dense;
    const int c = i - bl * n_dense;
    stage[bl * row + c] = to_float(dense[(b0 + bl) * dense_stride + c]);
  }
  const int chunks = d / VEC;
  const int items = n_here * n_fields * chunks;
  const float nan = __int_as_float(0x7fc00000);
  for (int i = threadIdx.x; i < items; i += kThreads) {
    const int rest = i / chunks;
    const int c = (i - rest * chunks) * VEC;
    const int bl = rest / n_fields;
    const int f = rest - bl * n_fields;
    const long long b = b0 + bl;
    const T* table = static_cast<const T*>(fields.table[f]);
    const long long vocab = fields.vocab[f];
    const int* bag_ids = ids + b * ids_b + f * ids_f;
    const float* bag_w = weights + b * w_b + f * w_f;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    for (int k = 0; k < bag; ++k) {
      long long id = bag_ids[k];
      const float w = bag_w[k];
      if (id < 0) id += vocab;
      Chunk<T, VEC> r;
      if (id >= 0 && id < vocab) {
        r.load(table + id * d + c);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) r.x[j] = nan;
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] += w * r.x[j];
    }
    float* dst = stage + bl * row + n_dense + f * d + c;
#pragma unroll
    for (int j = 0; j < VEC; ++j) dst[j] = to_float(from_float<T>(acc[j]));
  }
  __syncthreads();
  if constexpr (ROWS_APART) {
    for (int i = threadIdx.x; i < n_here * row; i += kThreads) {
      const int bl = i / row;
      out[(b0 + bl) * out_stride + (i - bl * row)] = from_float<O>(stage[i]);
    }
  } else {
    // the block's rows are one contiguous span of x0
    store_span(out + b0 * row, stage, n_here * row);
  }
}

template <typename T, typename O, int VEC>
int launch(const Fields& fields, const void* dense, const int* ids,
           const float* weights, void* out, long long out_stride,
           long long n_bags, int n_fields, int bag, long long ids_b,
           long long ids_f, long long w_b, long long w_f, int n_dense,
           long long dense_stride, int d, cudaStream_t stream) {
  const int row = n_dense + n_fields * d;
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // enough items for every thread of a block, then enough blocks for
  // two per SM
  int tile = kTile;
  while (tile < kMaxTile && tile * row < kThreads * VEC) tile *= 2;
  while (tile > kMinTile && (n_bags + tile - 1) / tile < 2LL * sms)
    tile /= 2;
  while (tile > 1 && static_cast<long long>(tile) * row * 4 > kSmemBytes)
    tile /= 2;
  const long long smem = static_cast<long long>(tile) * row * 4;
  if (smem > kSmemBytes) return -1;
  const long long grid = (n_bags + tile - 1) / tile;
  if (grid > 0) {
    const auto kernel = out_stride == row
                            ? embedding_bag_fields_kernel<T, O, VEC, false>
                            : embedding_bag_fields_kernel<T, O, VEC, true>;
    kernel<<<static_cast<unsigned>(grid), kThreads,
             static_cast<size_t>(smem), stream>>>(
        fields, static_cast<const O*>(dense), ids, weights,
        static_cast<O*>(out), out_stride, n_bags, n_fields, bag, ids_b,
        ids_f, w_b, w_f, n_dense, dense_stride, d, tile);
  }
  return static_cast<int>(cudaGetLastError());
}

struct Grads {
  float* grad[kMaxFields];
  long long vocab[kMaxFields];
};

template <typename O>
__global__ void __launch_bounds__(kThreads)
embedding_bag_fields_backward_kernel(
    const Grads grads, const int* __restrict__ ids,
    const float* __restrict__ weights, const O* __restrict__ grad_out,
    long long grad_stride, long long n_bags, int n_fields, int bag,
    long long ids_b, long long ids_f, long long w_b, long long w_f,
    int n_dense, int d) {
  const long long per_bag = static_cast<long long>(n_fields) * d;
  const long long items = n_bags * per_bag;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < items; i += step) {
    const long long b = i / per_bag;
    const int rest = static_cast<int>(i - b * per_bag);
    const int f = rest / d;
    const int c = rest - f * d;
    const float g = to_float(grad_out[b * grad_stride + n_dense + rest]);
    float* grad = grads.grad[f];
    const long long vocab = grads.vocab[f];
    const int* bag_ids = ids + b * ids_b + f * ids_f;
    const float* bag_w = weights + b * w_b + f * w_f;
    for (int k = 0; k < bag; ++k) {
      long long id = bag_ids[k];
      if (id < 0) id += vocab;
      if (id >= 0 && id < vocab) atomicAdd(grad + id * d + c, bag_w[k] * g);
    }
  }
}

template <typename O>
int launch_backward(const Grads& grads, const int* ids, const float* weights,
                    const void* grad_out, long long grad_stride,
                    long long n_bags, int n_fields, int bag, long long ids_b,
                    long long ids_f, long long w_b, long long w_f,
                    int n_dense, int d, cudaStream_t stream) {
  int sms = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long items = n_bags * n_fields * static_cast<long long>(d);
  // 8 blocks of 256 threads per SM fill its 2,048 threads
  const long long blocks = (items + kThreads - 1) / kThreads;
  const long long cap = 8LL * (sms > 0 ? sms : 1);
  const long long grid = blocks < cap ? blocks : cap;
  if (grid > 0)
    embedding_bag_fields_backward_kernel<O>
        <<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
            grads, ids, weights, static_cast<const O*>(grad_out),
            grad_stride, n_bags, n_fields, bag, ids_b, ids_f, w_b, w_f,
            n_dense, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int embedding_bag_fields_backward(
    float* const* grads, const long long* vocabs, int n_fields,
    const int* ids, const float* weights, const void* grad_out,
    long long grad_stride, long long n_bags, int bag,
    long long ids_bag_stride, long long ids_field_stride,
    long long w_bag_stride, long long w_field_stride, int n_dense, int d,
    int grad_dtype, void* stream) {
  if (n_fields < 1 || n_fields > kMaxFields) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Grads g{};
  for (int f = 0; f < n_fields; ++f) {
    g.grad[f] = grads[f];
    g.vocab[f] = vocabs[f];
  }
#define PTMT_ARGS                                                      \
  g, ids, weights, grad_out, grad_stride, n_bags, n_fields, bag,       \
      ids_bag_stride, ids_field_stride, w_bag_stride, w_field_stride, \
      n_dense, d, s
  if (grad_dtype == 0) return launch_backward<float>(PTMT_ARGS);
  if (grad_dtype == 1) return launch_backward<__nv_bfloat16>(PTMT_ARGS);
#undef PTMT_ARGS
  return -1;
}

extern "C" int embedding_bag_fields(
    const void* const* tables, const long long* vocabs, int n_fields,
    const void* dense, const int* ids, const float* weights, void* out,
    long long out_stride, long long n_bags, int bag, long long ids_bag_stride,
    long long ids_field_stride, long long w_bag_stride,
    long long w_field_stride, int n_dense, long long dense_stride, int d,
    int dtype, int out_dtype, void* stream) {
  if (n_fields < 1 || n_fields > kMaxFields) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Fields fields{};
  bool aligned = d % 4 == 0;
  for (int f = 0; f < n_fields; ++f) {
    fields.table[f] = tables[f];
    fields.vocab[f] = vocabs[f];
    aligned = aligned &&
              reinterpret_cast<unsigned long long>(tables[f]) % 16 == 0;
  }
#define PTMT_ARGS                                                      \
  fields, dense, ids, weights, out, out_stride, n_bags, n_fields, bag, \
      ids_bag_stride, ids_field_stride, w_bag_stride, w_field_stride,  \
      n_dense, dense_stride, d, s
  if (dtype == 0 && out_dtype == 0)
    return aligned ? launch<float, float, 4>(PTMT_ARGS)
                   : launch<float, float, 1>(PTMT_ARGS);
  if (dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, 1>(PTMT_ARGS);
  if (dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float, 1>(PTMT_ARGS);
#undef PTMT_ARGS
  return -1;
}
