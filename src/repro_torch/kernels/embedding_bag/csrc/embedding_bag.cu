// Embedding bag (weighted sum of gathered table rows) for Hopper, sm_90a.
//
// Replaces the TPU kernel `embedding_bag_pallas` of the JAX package
// (src/repro/kernels/embedding_bag/embedding_bag.py:38, body `_kernel` at
// :22), entered through `ops.embedding_bag` (ops.py:13).  That kernel pads
// the batch to 64-bag blocks and, per block, walks bag x k in a serial
// loop, loading one table row at a time from HBM into a VMEM accumulator.
//
// Here every bag is independent and no block carries state:
//
// * one thread per (bag, VEC columns) of the output: grid
//   ceil(B * D / VEC / 256) blocks of 256 threads.  At DCN-v2's
//   embed_dim 16 a float32 row is 64 bytes, so with VEC = 4 (float4 loads,
//   used when D % 4 == 0 and the table is 16-byte aligned) four threads
//   cover a row and one warp serves eight bags;
// * each thread loads the bag's ids and weights (the same addresses for
//   all threads of a bag: one broadcast load), sums w[b, k] * row over k
//   in ascending order in fp32 and casts on store;
// * the ragged end of the batch is masked by the thread bound, so the
//   batch is not padded;
// * ids follow `jnp.take`: a negative id >= -V wraps to id + V, any other
//   id outside [0, V) gives a NaN row.  The kernel never reads outside
//   the table.  Duplicate ids in a bag accumulate.
//
// ids and weights may be row-strided views ([B, K] slices of a
// [B, F, K] batch, k contiguous): the wrapper passes each one's bag
// stride, so a forward does not copy its 26 fields out of the batch.
//
// What bounds it on this card: bytes, and the latency of the random
// 64-byte row reads.  The work must read B * K table rows, the ids and
// weights, and write B * D outputs; it does two operations per gathered
// element.  Left on the table by this simple design: more rows in flight
// per thread (the K loads of a bag are independent), and bf16 vector loads.
//
// C interface (bound with ctypes):
//   int embedding_bag(table, ids, weights, out, n_bags, bag, ids_stride,
//                     w_stride, vocab, d, dtype, stream)
// over table [vocab, d] (dtype 0: float32, 1: bfloat16), ids int32 and
// weights float32 with bag b at ids + b * ids_stride (k contiguous), and
// out [n_bags, d] of the table's type; returns cudaGetLastError() after
// the launch (0 on success), or -1 for an unknown dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../../common/csrc/float_convert.cuh"

namespace {

constexpr int kThreads = 256;

// VEC consecutive elements of a row, as floats
template <typename T, int VEC>
struct Chunk {
  float x[VEC];
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) x[j] = to_float(p[j]);
  }
  __device__ __forceinline__ void store(T* p) const {
#pragma unroll
    for (int j = 0; j < VEC; ++j) p[j] = from_float<T>(x[j]);
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
  __device__ __forceinline__ void store(float* p) const {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
embedding_bag_kernel(const T* __restrict__ table, const int* __restrict__ ids,
                     const float* __restrict__ weights, T* __restrict__ out,
                     long long n_bags, int bag, long long ids_stride,
                     long long w_stride, long long vocab, int d) {
  const int chunks = d / VEC;
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n_bags * chunks) return;
  const long long b = i / chunks;
  const int c = static_cast<int>(i - b * chunks) * VEC;
  const int* bag_ids = ids + b * ids_stride;
  const float* bag_w = weights + b * w_stride;
  const float nan = __int_as_float(0x7fc00000);
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  for (int k = 0; k < bag; ++k) {
    long long id = bag_ids[k];
    if (id < 0) id += vocab;
    const float w = bag_w[k];
    if (id >= 0 && id < vocab) {
      Chunk<T, VEC> row;
      row.load(table + id * d + c);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] += w * row.x[j];
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] += w * nan;
    }
  }
  Chunk<T, VEC> res;
#pragma unroll
  for (int j = 0; j < VEC; ++j) res.x[j] = acc[j];
  res.store(out + b * d + c);
}

template <typename T, int VEC>
void launch(const void* table, const int* ids, const float* weights,
            void* out, long long n_bags, int bag, long long ids_stride,
            long long w_stride, long long vocab, int d,
            cudaStream_t stream) {
  const long long n = n_bags * (d / VEC);
  const long long grid = (n + kThreads - 1) / kThreads;
  if (grid == 0) return;
  embedding_bag_kernel<T, VEC>
      <<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
          static_cast<const T*>(table), ids, weights, static_cast<T*>(out),
          n_bags, bag, ids_stride, w_stride, vocab, d);
}

}  // namespace

extern "C" int embedding_bag(const void* table, const int* ids,
                             const float* weights, void* out,
                             long long n_bags, int bag, long long ids_stride,
                             long long w_stride, long long vocab, int d,
                             int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const bool vec = d % 4 == 0 &&
                     reinterpret_cast<unsigned long long>(table) % 16 == 0 &&
                     reinterpret_cast<unsigned long long>(out) % 16 == 0;
    if (vec)
      launch<float, 4>(table, ids, weights, out, n_bags, bag, ids_stride,
                       w_stride, vocab, d, s);
    else
      launch<float, 1>(table, ids, weights, out, n_bags, bag, ids_stride,
                       w_stride, vocab, d, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16, 1>(table, ids, weights, out, n_bags, bag,
                             ids_stride, w_stride, vocab, d, s);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}
