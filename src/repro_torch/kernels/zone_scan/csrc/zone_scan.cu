// Dense per-zone scan (PTMT Phase 1) of a [Z, E] zone batch, for Hopper,
// sm_90a.
//
// Replaces the TPU kernel `zone_scan_pallas` of the JAX package
// (src/repro/kernels/zone_scan/zone_scan.py:245, body `_kernel` at :162),
// which `ops.scan_zones` vmaps over the zones of a batch
// (src/repro/kernels/zone_scan/ops.py:51), in both of its variants
// (`with_ts` is the template parameter WITH_TS here).  That kernel walks a
// grid of 512-candidate blocks by 256-edge blocks in order, carrying lane
// state in VMEM scratch across the edge axis, and skips a cell when its
// edges wholly precede the candidates (index skip, :195) or start after
// the block's last seed time plus l_max*delta (time skip, :196).  Its
// wrapper pads E to a multiple of 512 and fills pad times with the largest
// valid t only to keep those skips conservative.
//
// Here blocks run in parallel with no carried state, so the shape is the
// per-lane form of those skips:
//
// * one thread per (zone, slot) lane of the batch: grid ceil(Z*E / 256)
//   blocks of 256 threads, one launch per batch;
// * a thread whose slot is invalid writes length 0 and all-zero code (and
//   ts), exactly as the TPU kernel leaves a never-seeded lane;
// * a valid lane seeds at its own slot and sweeps only the later slots of
//   its own row (the index skip), stopping at the row's end or as soon as
//   it timed out or holds l_max edges — after which no edge changes its
//   outputs (the time skip, made exact per lane).  The sweep is
//   ptmt::sweep_row, shared with the flat kernel fused_zone_scan.cu;
// * no padding of E and no fill of pad times: invalid slots gate nothing.
//
// What bounds it on this card: integer operations and divergence, as for
// the flat kernel (~2K compares for the node-table lookup plus the gap
// test per visited slot; a warp runs as long as its longest lane).  The
// bytes it must move are 4 int32 inputs and L + 1 (+ l_max with WITH_TS)
// int32 outputs per slot.  Left on the table by this simple design:
// staging the row in shared memory, and splitting long lanes across a
// warp.
//
// C interface (bound with ctypes):
//   int zone_scan_dense(u, v, t, valid, code, length, ts, n_zones, e_cap,
//                       delta, l_max, with_ts, stream)
// over row-major int32 [Z, E] inputs and code [Z, E, L], length [Z, E],
// ts [Z, E, l_max] outputs; returns cudaGetLastError() after the launch
// (0 on success), or -1 for an l_max this build does not instantiate.  ts
// is ignored (may be null) when with_ts is 0.

#include <cuda_runtime.h>

#include "edge_update.cuh"

namespace {

constexpr int kThreads = 256;

template <int LMAX, bool WITH_TS>
__global__ void __launch_bounds__(kThreads)
zone_scan_kernel(const int* __restrict__ u, const int* __restrict__ v,
                 const int* __restrict__ t, const int* __restrict__ valid,
                 int* __restrict__ code, int* __restrict__ length,
                 int* __restrict__ ts, long long n_lanes, int e_cap,
                 int delta) {
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (q >= n_lanes) return;
  const long long row = q / e_cap * e_cap;  // first slot of the lane's zone
  const int i = static_cast<int>(q - row);

  ptmt::LaneState<LMAX, WITH_TS> s;
  if (!valid[q]) {
    s.clear();
  } else {
    s.seed(u[q], v[q], t[q]);
    ptmt::sweep_row(s, u + row, v + row, t + row, valid + row, nullptr, 0,
                    i + 1, e_cap, delta);
  }
  s.store(q, code, length, ts);
}

template <int LMAX, bool WITH_TS>
int launch(const int* u, const int* v, const int* t, const int* valid,
           int* code, int* length, int* ts, int n_zones, int e_cap,
           int delta, cudaStream_t stream) {
  const long long n_lanes = static_cast<long long>(n_zones) * e_cap;
  if (n_lanes > 0) {
    const long long grid = (n_lanes + kThreads - 1) / kThreads;
    zone_scan_kernel<LMAX, WITH_TS>
        <<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
            u, v, t, valid, code, length, ts, n_lanes, e_cap, delta);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int zone_scan_dense(const int* u, const int* v, const int* t,
                               const int* valid, int* code, int* length,
                               int* ts, int n_zones, int e_cap, int delta,
                               int l_max, int with_ts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTMT_CASE(L)                                                        \
  case L:                                                                   \
    return with_ts ? launch<L, true>(u, v, t, valid, code, length, ts,      \
                                     n_zones, e_cap, delta, s)              \
                   : launch<L, false>(u, v, t, valid, code, length, ts,     \
                                      n_zones, e_cap, delta, s);
  switch (l_max) {
    PTMT_CASE(1) PTMT_CASE(2) PTMT_CASE(3) PTMT_CASE(4) PTMT_CASE(5)
    PTMT_CASE(6) PTMT_CASE(7) PTMT_CASE(8) PTMT_CASE(9) PTMT_CASE(10)
    PTMT_CASE(11) PTMT_CASE(12) PTMT_CASE(13) PTMT_CASE(14)
    default:
      return -1;
  }
#undef PTMT_CASE
}
