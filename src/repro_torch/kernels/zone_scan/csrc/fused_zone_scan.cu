// Fused flat zone scan (PTMT Phase 1) for Hopper, sm_90a.
//
// Replaces the TPU kernel `fused_zone_scan_flat` of the JAX package
// (src/repro/kernels/zone_scan/zone_scan.py:429, body `_fused_kernel` at
// :336).  That kernel sweeps 512-lane blocks over whole [lo, hi) windows
// in order, with lane state in VMEM.  Here there is no sequential grid and
// state is scarce, so the shape follows the compiled JAX lowering instead:
//
// * one thread per slot q of the flat stream.  A thread whose slot is
//   invalid, or lies past its block's window, writes length 0 and code 0;
// * the thread seeds its candidate at slot q and sweeps the later slots of
//   its own zone row: rows are contiguous runs of equal zone_id, so it
//   stops at the first slot of another zone, or at hi[q / blk] (the
//   host-planned window end: zone end, or the Lemma-4.1 horizon cut under
//   bounds="live").  Starting at q instead of the row start is exact:
//   before its seed a lane has length 0, so it is inactive and no edge
//   touches it;
// * early exit: the thread stops once its lane timed out or holds l_max
//   edges.  After either, no edge can change code or length (a time-out
//   only sets `done`, which the outputs never read), so the exit is exact.
//   It is the per-lane form of the TPU kernel's chunk skip;
// * lane state (length, last_t, done, n_nodes, nodes[K], code[L]) lives in
//   registers, l_max is a template parameter (see edge_update.cuh).
//
// What bounds it on this card: integer operations and divergence.  Each
// visited slot costs ~2K compares for the node-table lookup plus the gap
// test and ~5 loads; the bytes the function must move (5 int32 inputs per
// slot plus (L+1) int32 outputs) are a few MB per launch.  Neighbouring
// threads sweep nearly the same slots shifted by one, so the loads
// coalesce and hit L1.  Left on the table by this simple design: staging
// edge chunks in shared memory, a warp-cooperative sweep that splits one
// long lane's window, and balancing lanes whose windows differ in length.
//
// C interface (bound with ctypes):
//   int fused_zone_scan_flat(u, v, t, valid, zone_id, hi, code, length,
//                            n_slots, blk, delta, l_max, stream)
// returns cudaGetLastError() after the launch (0 on success), or -1 for
// an l_max this build does not instantiate.

#include <cuda_runtime.h>

#include "edge_update.cuh"

namespace {

constexpr int kThreads = 256;

template <int LMAX>
__global__ void __launch_bounds__(kThreads)
fused_zone_scan_kernel(const int* __restrict__ u, const int* __restrict__ v,
                       const int* __restrict__ t,
                       const int* __restrict__ valid,
                       const int* __restrict__ zone_id,
                       const int* __restrict__ hi, int* __restrict__ code,
                       int* __restrict__ length, int n_slots, int blk,
                       int delta) {
  using State = ptmt::LaneState<LMAX>;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_slots) return;
  const int end = min(hi[q / blk], n_slots);

  if (!valid[q] || q >= end) {
    length[q] = 0;
#pragma unroll
    for (int m = 0; m < State::L; ++m) code[q * State::L + m] = 0;
    return;
  }

  State s;
  s.seed(u[q], v[q], t[q]);
  const int zid = zone_id[q];
  if (s.length < LMAX) {
    for (int j = q + 1; j < end; ++j) {
      if (zone_id[j] != zid) break;  // end of the lane's zone row
      if (!valid[j]) continue;       // padding slot: gates nothing
      if (!s.update(u[j], v[j], t[j], true, delta)) break;
    }
  }
  length[q] = s.length;
#pragma unroll
  for (int m = 0; m < State::L; ++m) code[q * State::L + m] = s.code[m];
}

template <int LMAX>
int launch(const int* u, const int* v, const int* t, const int* valid,
           const int* zone_id, const int* hi, int* code, int* length,
           int n_slots, int blk, int delta, cudaStream_t stream) {
  if (n_slots > 0) {
    const int grid = (n_slots + kThreads - 1) / kThreads;
    fused_zone_scan_kernel<LMAX><<<grid, kThreads, 0, stream>>>(
        u, v, t, valid, zone_id, hi, code, length, n_slots, blk, delta);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_zone_scan_flat(const int* u, const int* v, const int* t,
                                    const int* valid, const int* zone_id,
                                    const int* hi, int* code, int* length,
                                    int n_slots, int blk, int delta,
                                    int l_max, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTMT_CASE(L)                                                       \
  case L:                                                                  \
    return launch<L>(u, v, t, valid, zone_id, hi, code, length, n_slots,   \
                     blk, delta, s);
  switch (l_max) {
    PTMT_CASE(1) PTMT_CASE(2) PTMT_CASE(3) PTMT_CASE(4) PTMT_CASE(5)
    PTMT_CASE(6) PTMT_CASE(7) PTMT_CASE(8) PTMT_CASE(9) PTMT_CASE(10)
    PTMT_CASE(11) PTMT_CASE(12) PTMT_CASE(13) PTMT_CASE(14)
    default:
      return -1;
  }
#undef PTMT_CASE
}
