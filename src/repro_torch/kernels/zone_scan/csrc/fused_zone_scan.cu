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
// * lane state (length, last_t, done, n_nodes, nodes[K], code[L], and
//   ts[l_max] with WITH_TS) lives in registers, l_max and WITH_TS are
//   template parameters (see edge_update.cuh, which also holds the row
//   sweep this kernel shares with the dense kernel zone_scan.cu).
//
// WITH_TS is the TPU kernel's `with_ts=True` variant (state and output at
// zone_scan.py:381, :425-426, :484-485): it also writes ts[S, l_max], the
// absorption time of each step, for the config-lattice co-mining fold.
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
// WITH_TS adds l_max int32 stores per lane and l_max registers; the sweep
// is the same.
//
// C interface (bound with ctypes):
//   int fused_zone_scan_flat(u, v, t, valid, zone_id, hi, code, length, ts,
//                            n_slots, blk, delta, l_max, with_ts, stream)
// returns cudaGetLastError() after the launch (0 on success), or -1 for
// an l_max this build does not instantiate.  ts is ignored (may be null)
// when with_ts is 0.

#include <cuda_runtime.h>

#include "edge_update.cuh"

namespace {

constexpr int kThreads = 256;

template <int LMAX, bool WITH_TS>
__global__ void __launch_bounds__(kThreads)
fused_zone_scan_kernel(const int* __restrict__ u, const int* __restrict__ v,
                       const int* __restrict__ t,
                       const int* __restrict__ valid,
                       const int* __restrict__ zone_id,
                       const int* __restrict__ hi, int* __restrict__ code,
                       int* __restrict__ length, int* __restrict__ ts,
                       int n_slots, int blk, int delta) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= n_slots) return;
  const int end = min(hi[q / blk], n_slots);

  ptmt::LaneState<LMAX, WITH_TS> s;
  if (!valid[q] || q >= end) {
    s.clear();
  } else {
    s.seed(u[q], v[q], t[q]);
    ptmt::sweep_row(s, u, v, t, valid, zone_id, zone_id[q], q + 1, end,
                    delta);
  }
  s.store(q, code, length, ts);
}

template <int LMAX, bool WITH_TS>
int launch(const int* u, const int* v, const int* t, const int* valid,
           const int* zone_id, const int* hi, int* code, int* length, int* ts,
           int n_slots, int blk, int delta, cudaStream_t stream) {
  if (n_slots > 0) {
    const int grid = (n_slots + kThreads - 1) / kThreads;
    fused_zone_scan_kernel<LMAX, WITH_TS><<<grid, kThreads, 0, stream>>>(
        u, v, t, valid, zone_id, hi, code, length, ts, n_slots, blk, delta);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int fused_zone_scan_flat(const int* u, const int* v, const int* t,
                                    const int* valid, const int* zone_id,
                                    const int* hi, int* code, int* length,
                                    int* ts, int n_slots, int blk, int delta,
                                    int l_max, int with_ts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PTMT_CASE(L)                                                        \
  case L:                                                                   \
    return with_ts ? launch<L, true>(u, v, t, valid, zone_id, hi, code,     \
                                     length, ts, n_slots, blk, delta, s)    \
                   : launch<L, false>(u, v, t, valid, zone_id, hi, code,    \
                                      length, ts, n_slots, blk, delta, s);
  switch (l_max) {
    PTMT_CASE(1) PTMT_CASE(2) PTMT_CASE(3) PTMT_CASE(4) PTMT_CASE(5)
    PTMT_CASE(6) PTMT_CASE(7) PTMT_CASE(8) PTMT_CASE(9) PTMT_CASE(10)
    PTMT_CASE(11) PTMT_CASE(12) PTMT_CASE(13) PTMT_CASE(14)
    default:
      return -1;
  }
#undef PTMT_CASE
}
